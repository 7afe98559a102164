"""The paper window split over a data x h x w mesh, rank by rank, on the port.

Counterpart of the JAX package's ``scripts/mesh_paper_window.py``, which
compiles the flagship window program (``bench.build``: two SFNOs at embed
256 x 8 on 180 x 360, horizon 6, the cold sampler, the SST prescriber)
sharded ``P("data", "h", "w")`` over virtual CPU devices and records each
device's memory. Here every rank of the mesh is a process of its own that
holds one block (``parallel/mesh.py``), and two backends run them:

* ``--backend fake`` (the default): one process plays each rank of the
  mesh in turn, on the card, over PyTorch's fake process group (backend
  "fake", ``torch.testing._internal.distributed.fake_pg``): a group whose
  collectives return at once and move no data. For each rank it starts the
  group, builds the mesh and the stepper (the weights are built once and
  shared by every rank), runs one untimed window and one timed window of
  that rank's block, and records the memory the rank holds, its compute
  seconds, the kernels' launches and the collectives it calls, by kind and
  bytes. The collectives are not performed: a buffer that one of them fills
  (a gather's, an all-to-all's, a reduce-scatter's) keeps what the memory
  held before, so a fake rank's values mean nothing, and the fake mode
  reports no value and no finiteness. Its figures are one rank's footprint
  and compute time of a real deployment, without the communication;
* ``--backend gloo`` (the CPU): the ranks are spawned processes with real
  collectives, each writing its record; with ``--execute`` the window is
  gathered and checked finite, the counterpart of the JAX script's
  ``--execute``. At paper width that is slow on the CPU (the JAX script's
  own run took about 36 minutes), so this mode is for small sizes.

It writes ``stats.json`` into ``--out`` with the JAX script's keys
(``mesh``, ``program``, ``build_s``, ``argument_mb``, ``output_mb``,
``temp_mb``: the largest over the ranks) and ``per_rank`` (each rank's
record), ``backend``, ``collectives`` ("not performed" on the fake group)
and ``card`` (the card's name and power limit from ``nvidia-smi``). Per
rank:

* ``argument_mb``: the parameters and buffers of both networks (the SHT
  matrices included, as JAX counts its "constants") and this rank's blocks
  of the window's inputs, from the tensors' shapes;
* ``output_mb``: this rank's block of the final state and the predictions
  (``gathered_output_mb``: the window gathered, which ``run_window``
  returns on every rank);
* ``temp_mb``: ``torch.cuda.max_memory_allocated`` over the timed window
  less what was allocated before it (``peak_mb``: the maximum itself,
  ``peak_reserved_mb``: ``max_memory_reserved`` over the window, the
  allocator's cache included); ``resident_mb``: what was allocated before it,
  the window's global inputs and the K1 weight images the warm-up window
  made (``k1_images_mb``) included. None of these counts the CUDA context,
  cuBLAS's workspaces or a real group's communication buffers, which the
  fake group never makes.

The flags and defaults are the JAX script's (``--devices 8 --window 12
--embed 256 --layers 8 --data 2 --h 2 --w 2 --execute``; by default JAX's
program: float32, no hand-written kernel, the uniform sampler), with these
departures:

* ``--backend``, and ``--device`` (default ``cuda``; raises without a card;
  ``cpu`` runs the fake mode on the CPU, and the gloo mode needs it);
* ``--use-pallas``, ``--fused-tail``, ``--peel``, ``--scan-layers`` and
  ``--dtype`` (``bench.build``'s options, as ``rollout_10yr``'s): K1 and K3;
* ``--img-shape`` (default 180 360) and ``--no-interpolator-dropout`` for
  small runs;
* the forcings are zeros of the window's shape: the JAX script passes none,
  which its forecaster (built for the state and two forcings) cannot take;
* the default ``--out`` is ``results/torch_mesh_paper_window``.

Usage:
    python -m spherical_dyffusion_tpu_torch.scripts.mesh_paper_window [--devices 8]
        [--window 12] [--embed 256] [--layers 8] [--data 2 --h 2 --w 2]
        [--use-pallas --fused-tail --peel --scan-layers --dtype bfloat16]
        [--backend fake|gloo] [--device cuda|cpu] [--execute] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import main_path
from ..inference.stepper import DYffusionStepper
from ..ops.fused_mlp import fused_block_tail, fused_mlp
from ..ops.fused_rank import fused_rank
from ..ops.pallas_contractions import dhconv, dhconv_weight_image
from ..parallel.mesh import AXIS_DATA, AXIS_H, AXIS_W, make_mesh
from .rollout_10yr import card

__all__ = ["parse_args", "build_program", "window_inputs", "fake_store", "counted_collectives",
           "run_rank", "fake_ranks", "write_worker_args", "gloo_worker", "main", "COLLECTIVES"]

# the collectives the port makes, each counted with the bytes of its send buffer
COLLECTIVES = ("all_reduce", "all_to_all_single", "reduce_scatter_tensor",
               "all_gather_into_tensor", "broadcast")
KERNELS = {"K1": dhconv, "K2": fused_mlp, "K3": fused_block_tail, "K4": fused_rank}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--window", type=int, default=12)
    ap.add_argument("--embed", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--h", type=int, default=2)
    ap.add_argument("--w", type=int, default=2)
    ap.add_argument("--execute", action="store_true",
                    help="gloo: also gather the window and check it finite (the fake group "
                         "moves no data, so the fake mode checks no value)")
    ap.add_argument("--out", default="results/torch_mesh_paper_window")
    ap.add_argument("--backend", choices=("fake", "gloo"), default="fake",
                    help="fake: every rank in turn in this process, on the card, no data "
                         "moved; gloo: spawned processes with real collectives, on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--dtype", default="float32",
                    help="compute dtype, and the transforms' matmul dtype")
    ap.add_argument("--use-pallas", action="store_true", help="the dense dhconv through K1")
    ap.add_argument("--fused-tail", action="store_true",
                    help="each block's norm, time scale-shift, MLP and skip through K3")
    ap.add_argument("--peel", action="store_true", help="the peeled scan sampler")
    ap.add_argument("--scan-layers", action="store_true",
                    help="the middle blocks scanned (the same plain loop in the port)")
    ap.add_argument("--img-shape", type=int, nargs=2, default=(180, 360),
                    metavar=("H", "W"))
    ap.add_argument("--no-interpolator-dropout", dest="interpolator_dropout",
                    action="store_false",
                    help="the interpolator's dropout off at inference (live by default)")
    return ap.parse_args(argv)


def build_program(args: argparse.Namespace, device) -> DYffusionStepper:
    """``bench.build``'s window stepper at ``args``' widths and options,
    without a mesh, its weights drawn from seed 0 on ``device``."""
    return main_path.build(args.embed, args.layers, args.dtype, tuple(args.img_shape),
                           use_pallas=args.use_pallas, fused_mlp=False,
                           fused_tail=args.fused_tail, peel=args.peel,
                           scan_layers=args.scan_layers, device=str(device), seed=0,
                           enable_interpolator_dropout=args.interpolator_dropout)


def window_inputs(args: argparse.Namespace, program: DYffusionStepper, device) -> dict:
    """The JAX script's inputs in ``run_window``'s shapes: ``--data`` rows
    (one a data shard) of zeros, the state (B, H, W, C), the forcings (B,
    T+1, H, W, 2), the prescribed targets and the masks (B, T+1, H, W)."""
    exp = program.exp
    B, (H, W), T = args.data, tuple(args.img_shape), args.window + 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"x0": zeros(B, H, W, len(exp.in_packer.names)),
            "forcing": zeros(B, T, H, W, len(exp.forcing_names)),
            "targets": zeros(B, T, H, W), "mask": zeros(B, T, H, W)}


def fake_store():
    """The store of PyTorch's fake process group (importing its module
    registers the "fake" backend); raises where this PyTorch has none."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"PyTorch's fake process group is not available here ({e}); the "
                           f"fake mode needs it, and there is no other") from e
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError("PyTorch's fake process group did not register its backend")
    return FakeStore()


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@contextlib.contextmanager
def counted_collectives():
    """Count every collective of ``COLLECTIVES`` called inside the block,
    with the bytes of its send buffer: ``{kind: {"calls": n, "bytes": b}}``."""
    counts = {k: {"calls": 0, "bytes": 0} for k in COLLECTIVES}
    real = {k: getattr(dist, k) for k in COLLECTIVES}

    def counting(kind):
        def call(*args, **kwargs):  # the port passes the tensors positionally
            counts[kind]["calls"] += 1
            counts[kind]["bytes"] += _nbytes(args[0] if kind in ("all_reduce", "broadcast")
                                             else args[1])
            return real[kind](*args, **kwargs)
        return call

    for k in COLLECTIVES:
        setattr(dist, k, counting(k))
    try:
        yield counts
    finally:
        for k in COLLECTIVES:
            setattr(dist, k, real[k])


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        key = (t.device, t.data_ptr())
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


def _k1_images_bytes(nets) -> int:
    """The bytes of the K1 weight images the networks' filters hold (the
    whole weight's and a channel shard's)."""
    images = []
    for net in nets:
        for block in getattr(net, "blocks", ()):
            for name in ("_k1_image", "_k1_shard_image"):
                cache = getattr(block.filter, name, None)
                if cache is not None and cache.image is not None:
                    images.append(cache.image)
    return _unique_bytes(images)


def _mb(n: Optional[int]) -> Optional[float]:
    return None if n is None else n / 1e6


def run_rank(args: argparse.Namespace, program: DYffusionStepper, inputs: dict, mesh,
             warmup: bool = True):
    """This process's rank of ``mesh``: ``program``'s networks in a stepper
    on the mesh, one untimed window (with ``warmup``) and one timed window
    of ``args.window`` steps from seed 0. Returns (the rank's record, the
    gathered final state and predictions)."""
    exp = program.exp
    nets = (exp.model, exp.interpolator.model)
    dev = inputs["x0"].device
    cuda = dev.type == "cuda"
    stepper = DYffusionStepper(exp, prescriber=program.prescriber, mesh=mesh)
    blocks = {}
    real = stepper._run_window

    def recording(*a, **k):  # this rank's blocks, in and out
        x, preds = real(*a, **k)
        blocks.update(zip(("x0", "forcing", "targets", "mask"), a[:4]), state=x, preds=preds)
        return x, preds

    stepper._run_window = recording

    def window():
        return stepper.run_window(inputs["x0"], inputs["forcing"], inputs["targets"],
                                  inputs["mask"], torch.Generator().manual_seed(0), args.window)

    if warmup:  # K1's images, cuBLAS, the allocator
        window()
        blocks.clear()
    for fn in (*KERNELS.values(), dhconv_weight_image):
        fn.launches = 0
    before = None
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with counted_collectives() as coll:
        t0 = time.perf_counter()
        x, preds = window()
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    peak_reserved = torch.cuda.max_memory_reserved(dev) if cuda else None
    params = _unique_bytes(itertools.chain(*(itertools.chain(n.parameters(), n.buffers())
                                             for n in nets)))
    ins = sum(_nbytes(blocks[k]) for k in ("x0", "forcing", "targets", "mask"))
    outs = _nbytes(blocks["state"]) + _nbytes(blocks["preds"])
    rec = {
        "rank": mesh.rank,
        "coords": {a: mesh.index(a) for a in (AXIS_DATA, AXIS_H, AXIS_W)},
        "blocks": {k: list(v.shape) for k, v in blocks.items()},
        "params_bytes": params, "inputs_bytes": ins, "argument_bytes": params + ins,
        "output_bytes": outs, "gathered_output_bytes": _nbytes(x) + _nbytes(preds),
        "argument_mb": _mb(params + ins), "output_mb": _mb(outs),
        "gathered_output_mb": _mb(_nbytes(x) + _nbytes(preds)),
        "temp_mb": _mb(peak - before) if cuda else None,
        "peak_mb": _mb(peak), "peak_reserved_mb": _mb(peak_reserved),
        "resident_mb": _mb(before),
        "k1_images_mb": _mb(_k1_images_bytes(nets)),
        "seconds": seconds,
        "launches": {k: fn.launches for k, fn in KERNELS.items()},
        "k1_images": dhconv_weight_image.launches,
        "collectives": coll,
    }
    del stepper, blocks
    return rec, (x, preds)


def fake_ranks(args: argparse.Namespace, program: DYffusionStepper, inputs: dict,
               ranks: Optional[Sequence[int]] = None, warmup: bool = True) -> List[dict]:
    """Each rank of ``ranks`` (every rank of the mesh by default) in turn
    over the fake process group: the group, the mesh and the stepper made
    anew for the rank, ``program``'s weights and ``inputs`` shared. Returns
    the ranks' records."""
    n = args.data * args.h * args.w
    store = fake_store()
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the fake ranks make their own")
    dev = inputs["x0"].device
    records = []
    for r in (range(n) if ranks is None else ranks):
        dist.init_process_group("fake", rank=r, world_size=n, store=store)
        try:
            mesh = make_mesh(data=args.data, h=args.h, w=args.w)
            rec, _ = run_rank(args, program, inputs, mesh, warmup=warmup)
        finally:
            dist.destroy_process_group()
        records.append(rec)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def write_worker_args(out: str, argv: Sequence[str]) -> None:
    """Write the command line ``gloo_worker`` reads from ``out``."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "args.json"), "w") as f:
        json.dump(list(argv), f)


def gloo_worker(rank: int, world: int, init: str, out: str) -> None:
    """One rank of the gloo mode, spawned: it reads the command line from
    ``out/args.json``, joins the gloo group at ``init``, builds the program
    (the same seed on every rank), runs its rank and saves its record to
    ``out/rank<r>.pt``; with ``--execute`` the record also holds whether the
    gathered window is finite and, on rank 0, the window (``state``,
    ``preds``)."""
    torch.set_num_threads(1)
    with open(os.path.join(out, "args.json")) as f:
        args = parse_args(json.load(f))
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        program = build_program(args, "cpu")
        inputs = window_inputs(args, program, "cpu")
        mesh = make_mesh(data=args.data, h=args.h, w=args.w)
        rec, (x, preds) = run_rank(args, program, inputs, mesh, warmup=False)
        if args.execute:
            rec["finite"] = bool(torch.isfinite(x).all() and torch.isfinite(preds).all())
            if rank == 0:
                rec.update(state=x, preds=preds)
        torch.save(rec, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gloo(args: argparse.Namespace, argv: Sequence[str]) -> List[dict]:
    """The gloo mode: ``data * h * w`` spawned ranks over a ``file://``
    rendezvous under ``args.out``; their records by rank."""
    n = args.data * args.h * args.w
    out = os.path.join(args.out, "gloo_ranks")
    write_worker_args(out, argv)
    rendezvous = os.path.join(out, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mp.start_processes(gloo_worker, args=(n, "file://" + rendezvous, out), nprocs=n,
                       start_method="spawn")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(n)]


def _worst(records: List[dict], key: str) -> Optional[float]:
    vals = [r[key] for r in records if r.get(key) is not None]
    return max(vals) if vals else None


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    n = args.data * args.h * args.w
    if n > args.devices:
        raise ValueError(f"the mesh data {args.data} x h {args.h} x w {args.w} needs {n} "
                         f"devices, more than --devices {args.devices}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if args.backend == "gloo" and device.type != "cpu":
        raise ValueError("the gloo backend runs its ranks on the CPU: pass --device cpu")
    H, W = args.img_shape
    kernels = [k for k, on in (("K1", args.use_pallas), ("K3", args.fused_tail)) if on]
    stats = {
        "mesh": {AXIS_DATA: args.data, AXIS_H: args.h, AXIS_W: args.w},
        "program": f"DYffusion window({args.window}) embed{args.embed}x{args.layers} "
                   f"@{H}x{W}, {args.data} rows, activations P('data','h','w'), {args.dtype}, "
                   f"{'+'.join(kernels) or 'no hand-written kernel'}, "
                   f"{'peeled' if args.peel else 'uniform'} sampler",
        "backend": args.backend,
    }
    if args.backend == "gloo":
        t0 = time.perf_counter()
        records = _gloo(args, argv)
        stats["build_s"] = None  # each rank builds its own program
        stats["wall_s"] = time.perf_counter() - t0
        stats["collectives"] = "performed over gloo"
        if args.execute:
            stats["finite"] = all(r["finite"] for r in records)
        records = [{k: v for k, v in r.items() if k not in ("state", "preds")} for r in records]
    else:
        fake_store()  # refuse before building anything
        t0 = time.perf_counter()
        program = build_program(args, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["build_s"] = time.perf_counter() - t0
        records = fake_ranks(args, program, window_inputs(args, program, device),
                             warmup=device.type == "cuda")
        stats["collectives"] = "not performed"
        stats["finite"] = "not reported: the fake group moves no data, so no value is checked"
    for key in ("argument_mb", "output_mb", "temp_mb", "peak_mb", "peak_reserved_mb",
                "gathered_output_mb", "k1_images_mb", "seconds"):
        stats[key] = _worst(records, key)
    stats["per_rank"] = records
    stats["card"] = card() if device.type == "cuda" else None
    stats["note"] = ("per rank: argument = parameters and buffers of both networks + this "
                     "rank's input blocks; temp = max_memory_allocated over the timed window "
                     "less what was allocated before it (K1 images made in the warm-up window "
                     "are resident, k1_images_mb); no CUDA context, cuBLAS workspace or "
                     "communication buffer is counted; the top-level figures are the largest "
                     "over the ranks")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps({k: v for k, v in stats.items() if k != "per_rank"}))
    return stats


if __name__ == "__main__":
    main()
