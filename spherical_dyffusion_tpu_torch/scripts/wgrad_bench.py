"""Time K1's weight gradient on the card, one checkout against another.

``dhconv_weight_grad`` (``ops/pallas_contractions.py``, its kernel in
``csrc/dhconv.cu``) at the shapes ``chip_smoke.py`` drives it at: the main
path's x (B, 180, 181, 256) -> 256 at B = 1 and 2, the "w" = 2 and 4
channel shards (1, 180, 181, 128 or 64) -> 256, and the skill studies'
(16, 64, 65, 64) and (8, 16, 17, 16). For each checkout and shape: the ms
a call in a loop of calls through the wrapper between CUDA events, the
device ms (the calls queued behind a spin kernel, so that the host's work
between launches does not count), the error against the plain version
(1e-5 of its largest entry) and whether a second call gives the same bits;
one complex ``torch.matmul`` beside them; at the small shapes, where a call
is mostly the host's, also the host's time a call of each (perf_counter
around 400 calls that queue behind a spin kernel, so none waits on the
device). Each checkout runs in a process
of its own that imports the port's package from that checkout and builds
its kernels there; the checkouts take turns (A, B, B, A for two rounds) so
that a drift of the card's clocks falls on both alike.

    python3 -m spherical_dyffusion_tpu_torch.scripts.wgrad_bench \\
        --tree before=/path/to/another/checkout --tree after=. [--rounds 2] \\
        [--json out.json]

The last line printed is one JSON object: per checkout and shape the median
over the rounds, and per shape the ratio of each checkout's times to the
first's; the line before it holds the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

__all__ = ["main", "SHAPES"]

# name: (B, L, M, CI, CO)
SHAPES = {
    "main_b1": (1, 180, 181, 256, 256),
    "main_b2": (2, 180, 181, 256, 256),
    "shard_ci128": (1, 180, 181, 128, 256),
    "shard_ci64": (1, 180, 181, 64, 256),
    "studies_full": (16, 64, 65, 64, 64),
    "studies_mini": (8, 16, 17, 16, 16),
}
SPIN_CYCLES = 200_000_000  # about 0.1 s of torch.cuda._sleep at an H100's clocks


def _measure(shapes) -> dict:
    """One checkout's figures, from the package on ``sys.path``."""
    import torch

    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        dhconv_weight_grad,
        dhconv_weight_grad_plain,
    )

    def host_us(fn, reps=400):
        fn()
        torch.cuda.synchronize()
        ev = torch.cuda.Event()
        torch.cuda._sleep(2 * SPIN_CYCLES)
        ev.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e6
        if ev.query():
            raise RuntimeError("the device reached the timed calls before the host had "
                               "queued them all; lengthen the spin")
        torch.cuda.synchronize()
        return t

    def loop_ms(fn, reps, spin=False):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        if spin and ev[0].query():
            raise RuntimeError("the device reached the timed calls before the host had queued "
                               "them all; lengthen the spin")
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    g = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for name in shapes:
        B, L, M, CI, CO = SHAPES[name]
        x = torch.randn((B, L, M, CI, 2), device="cuda", generator=g)
        gy = torch.randn((B, L, M, CO, 2), device="cuda", generator=g)
        got, again = dhconv_weight_grad(x, gy), dhconv_weight_grad(x, gy)
        want = dhconv_weight_grad_plain(x, gy)
        err = float((got - want).abs().max() / want.abs().max())
        if err > 1e-5:
            raise RuntimeError(f"dW at {name} is {err:.3e} off its plain version")
        xk = torch.view_as_complex(x).transpose(0, 1).reshape(L, -1, CI).mH.contiguous()
        gk = torch.view_as_complex(gy).transpose(0, 1).reshape(L, -1, CO).contiguous()
        small = B * M * CI < 2 ** 16  # a call there is mostly the host's: more of them
        reps = 200 if small else 20
        out[name] = dict(
            ms=loop_ms(lambda: dhconv_weight_grad(x, gy), reps),
            device_ms=loop_ms(lambda: dhconv_weight_grad(x, gy), 20, spin=True),
            library_ms=loop_ms(lambda: torch.matmul(xk, gk), reps),
            max_rel_err=err, same_bits=bool(torch.equal(got, again)))
        if small:
            out[name].update(host_us=host_us(lambda: dhconv_weight_grad(x, gy)),
                             library_host_us=host_us(lambda: torch.matmul(xk, gk)))
        del x, gy, got, again, want, xk, gk
    return out


def _child(tree: str, args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                            cwd=os.path.abspath(tree), env=env, stdout=subprocess.PIPE,
                            text=True)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: a checkout of the repository (at least one)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns; a round runs the checkouts in order, then reversed")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated names")
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    shapes = [s for s in a.shapes.split(",") if s]
    for s in shapes:
        if s not in SHAPES:
            ap.error(f"unknown shape {s}; known: {', '.join(SHAPES)}")
    if a.child:
        if a.build:
            from spherical_dyffusion_tpu_torch.ops import _cuda

            _cuda.library()
            return {}
        print(json.dumps(_measure(shapes)), flush=True)
        return {}
    trees = [t.split("=", 1) for t in a.tree]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("give each checkout as --tree NAME=DIR")
    # every checkout's kernels built at once, before any timing
    builds = [(name, _child(tree, ["--child", "--build"])) for name, tree in trees]
    for name, proc in builds:
        proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"wgrad_bench: building {name}'s kernels failed")
    runs = {name: [] for name, _ in trees}
    order = []
    for _ in range(a.rounds):
        order += trees + trees[::-1]
    for name, tree in order:
        proc = _child(tree, ["--child", "--shapes", ",".join(shapes)])
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"wgrad_bench: {name}'s run failed")
        res = json.loads(text.strip().splitlines()[-1])
        runs[name].append(res)
        print(f"{name}: " + "; ".join(f"{s} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
                                      f"complex torch.matmul {r['library_ms']:.4f})"
                                      for s, r in res.items()), flush=True)
    keys = ("ms", "device_ms", "library_ms", "host_us", "library_host_us")
    median = {name: {s: {k: statistics.median(r[s][k] for r in rs) for k in keys
                         if k in rs[0][s]}
                     for s in shapes} for name, rs in runs.items()}
    for name, rs in runs.items():
        for s in shapes:
            median[name][s]["max_rel_err"] = max(r[s]["max_rel_err"] for r in rs)
            median[name][s]["same_bits"] = all(r[s]["same_bits"] for r in rs)
    first = trees[0][0]
    ratio = {name: {s: {k: median[name][s][k] / median[first][s][k] for k in keys[:2]}
                    for s in shapes} for name, _ in trees[1:]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no card")
    result = dict(shapes={s: SHAPES[s] for s in shapes}, rounds=a.rounds, median=median,
                  ratio_to_first=ratio, order=[n for n, _ in order])
    if a.json:
        with open(a.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
