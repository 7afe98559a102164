"""The 10-simulated-year product rollout of the main path, on the port.

Counterpart of the JAX package's ``scripts/rollout_10yr.py``: it runs the
product path, ``run_inference`` with the aggregator reducing every window on
the card, for a 10-simulated-year rollout (14,600 steps of 6 hours) of the
paper's configuration (two SFNOs at embed 256 x 8 with the dense dhconv,
DYffusion at horizon 6, 35 channels and 2 forcings on 180 x 360, the SST
prescriber), and writes

* ``rollout_10yr.json``: the configuration (with the card's name and power
  limit), the throughput (steps/s and simulated years a day), the host
  fractions (data loading, writer and aggregator, the rest), the numerics
  (every per-step RMSE row finite) and the aggregator's time-mean logs;
* ``metrics_full.json``: every log of the aggregator.

The weights are random, drawn from a seed: the metric values are not
scientific; the run shows the product path end to end at full width and
scale. ``--writer`` also writes the predictions
(``autoregressive_predictions.nc``).

The flags and defaults are the JAX script's, with these departures:

* ``--device`` (default ``cuda``; raises without a card) replaces
  ``--platform``;
* the default ``--out`` is ``results/torch_rollout_10yr``;
* ``--use-pallas`` and ``--fused-tail`` (``bench.py``'s ``build``
  arguments, off there and here) route the dense dhconv through K1 and each
  block's tail through K3;
* ``--fast`` is the JAX script's (CP rank 0.25, truncation 0.8, bf16
  spectral IO) and routes the rank pipeline's middle through K4 where the
  (``--dtype``, bf16) pair of matmul and spectral-IO dtypes has an instance
  of it (``models/sfno.py:K4_PAIRS``): with ``--dtype bfloat16``. Another
  dtype (``--fast --dtype float16``) runs the unfused rank pipeline, which
  is what the JAX package's SFNO computes; the choice is made at build time
  and printed.

Usage (on the card; ``--device cpu`` at a small ``--embed``, ``--layers``
and ``--steps`` on the CPU):
    python -m spherical_dyffusion_tpu_torch.scripts.rollout_10yr [--steps 14600]
        [--window 96] [--use-pallas --fused-tail] [--dtype float16
        --preds-dtype float16] [--fast] [--writer] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import main_path
from ..data.datasets import SyntheticTimeSeries
from ..evaluation.aggregators import InferenceAggregator
from ..inference.loop import InferenceConfig, run_inference
from ..inference.stepper import DYffusionStepper
from ..inference.writers import DataWriter, DataWriterConfig
from ..models.sfno import K4_PAIRS
from ..ops.matmul import as_dtype

__all__ = ["parse_args", "fast_options", "build_stepper", "rollout_artifact", "card", "main",
           "STEPS_PER_SIM_YEAR"]

STEPS_PER_SIM_YEAR = 1460  # 6-hour steps
# the JAX script's --fast: CP rank 0.25, spectral truncation 0.8, bf16 spectral IO
FAST = dict(factorization="cp", rank=0.25, thresh=0.8, spectral_io="bfloat16")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=14600)
    ap.add_argument("--window", type=int, default=96,
                    help="forecast steps a window (one member)")
    ap.add_argument("--out", default="results/torch_rollout_10yr")
    ap.add_argument("--embed", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--writer", action="store_true",
                    help="also write the predictions (autoregressive_predictions.nc)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--dtype", default="bfloat16",
                    help="compute dtype, and the transforms' matmul dtype: float32, "
                         "bfloat16 or float16")
    ap.add_argument("--params-dtype", default=None,
                    help="round every weight to this dtype's values (stored in float32)")
    ap.add_argument("--preds-dtype", default="bfloat16",
                    help="dtype of the emitted predictions; the hand-off state stays float32")
    ap.add_argument("--targets-dtype", default="float32",
                    help="dtype of the target windows the aggregator reduces against "
                         "(float32 or bfloat16)")
    ap.add_argument("--no-scan-layers", dest="scan_layers", action="store_false",
                    help="the middle blocks unrolled (the same plain loop in the port)")
    ap.add_argument("--no-peel", dest="peel", action="store_false",
                    help="the unpeeled scan sampler")
    ap.add_argument("--fast", action="store_true",
                    help="CP rank 0.25, spectral truncation 0.8, bf16 spectral IO; K4 where "
                         "the (dtype, bf16) pair has an instance")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the dense dhconv through K1")
    ap.add_argument("--fused-tail", action="store_true",
                    help="each block's norm, time scale-shift, MLP and skip through K3")
    args = ap.parse_args(argv)
    if args.peel and not args.scan_layers:
        ap.error("--no-scan-layers requires --no-peel (the JAX script's rule: peel without "
                 "scanned blocks hangs its remote compile)")
    return args


def fast_options(args: argparse.Namespace) -> dict:
    """``main_path.build``'s options of ``--fast`` (none without it):
    ``FAST`` and ``fused_rank`` where K4 has an instance for the pair of
    matmul dtype (``--dtype``) and spectral-IO dtype (bf16)."""
    if not args.fast:
        return {}
    pair = (as_dtype(args.dtype), as_dtype(FAST["spectral_io"]))
    return dict(FAST, fused_rank=pair in K4_PAIRS)


def build_stepper(args: argparse.Namespace, seed: int = 0) -> DYffusionStepper:
    """The main path's stepper at ``args``' widths and options, its weights
    drawn from ``seed``, on ``args.device``."""
    return main_path.build(args.embed, args.layers, args.dtype, use_pallas=args.use_pallas,
                           fused_mlp=False, fused_tail=args.fused_tail, peel=args.peel,
                           scan_layers=args.scan_layers, params_dtype=args.params_dtype,
                           preds_dtype=args.preds_dtype, device=args.device, seed=seed,
                           **fast_options(args))


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def rollout_artifact(stepper: DYffusionStepper, args: argparse.Namespace,
                     verbose: bool = True,
                     before_timed: Optional[Callable[[], None]] = None) -> dict:
    """The rollout of ``args.steps`` steps in windows of ``args.window`` on
    the stepper's device, after one untimed warm-up run of a window (the
    weight images, cuBLAS, the allocator), as the JAX script runs it, and
    ``before_timed`` if given; writes ``rollout_10yr.json`` and
    ``metrics_full.json`` (and the predictions with ``args.writer``) into
    ``args.out`` and returns the first file's contents."""
    exp = stepper.exp
    names = list(exp.out_packer.names)
    os.makedirs(args.out, exist_ok=True)
    # a source as long as a window: every window's reads and uploads coincide,
    # so they come from the loop's caches after the first
    src = SyntheticTimeSeries(list(exp.in_packer.names) + list(exp.forcing_names)
                              + [main_path.MASK_NAME], n_timesteps=args.window,
                              spatial_shape=exp.model.cfg.img_shape)

    def aggregator():
        return InferenceAggregator(names, src.horizontal.area_weights(),
                                   log_zonal_mean_images=True)

    run_inference(stepper, src,
                  InferenceConfig(n_forward_steps=args.window, forward_steps_in_memory=args.window,
                                  n_repeats=3, targets_dtype=args.targets_dtype),
                  aggregator=aggregator(), mask_name=main_path.MASK_NAME, verbose=False)
    if before_timed is not None:
        before_timed()
    agg = aggregator()
    cfg = InferenceConfig(n_forward_steps=args.steps, forward_steps_in_memory=args.window,
                          n_ensemble=1, n_repeats=args.steps // args.window + 2,
                          targets_dtype=args.targets_dtype)
    writer = None
    if args.writer:
        writer = DataWriter(DataWriterConfig(save_prediction_files=True), args.out, names,
                            src.horizontal.lat, src.horizontal.lon, 1)
    t0 = time.time()
    try:
        summary = run_inference(stepper, src, cfg, aggregator=agg, writer=writer,
                                mask_name=main_path.MASK_NAME, verbose=verbose)
    except BaseException:
        if writer is not None:
            writer.abort()
        raise
    if writer is not None:
        writer.close()
    wall = time.time() - t0
    logs = agg.get_logs()
    # every step's RMSE row must be finite: a blow-up in any window poisons it
    rmse_rows = agg.reduced.series()["rmse"]
    finite = bool(np.isfinite(rmse_rows).all())
    sps, steady = summary["total_steps_per_second"], summary["steady_steps_per_second"]
    duration = summary["duration_s"]
    fused_rank = any(getattr(b.filter, "fused_rank", False) for b in exp.model.blocks)
    artifact = {
        "config": {
            "steps": args.steps, "window": args.window, "embed": args.embed,
            "layers": args.layers, "writer": bool(args.writer),
            "scan_layers": args.scan_layers, "peel_sampler": args.peel,
            "fast": bool(args.fast), "dtype": args.dtype, "preds_dtype": args.preds_dtype,
            "targets_dtype": args.targets_dtype, "params_dtype": args.params_dtype,
            "use_pallas": bool(args.use_pallas), "fused_tail": bool(args.fused_tail),
            "fused_rank": fused_rank, "device": str(next(exp.model.parameters()).device),
            "card": card() if next(exp.model.parameters()).is_cuda else None,
            "note": "random weights from a seed: evidence of the product path (throughput, "
                    "host fractions, aggregator), not of skill",
        },
        "throughput": {
            "total_steps": int(summary["n_forward_steps"]),
            "duration_s": duration,
            "steps_per_second": sps,
            "sim_years_per_day": sps * 86400.0 / STEPS_PER_SIM_YEAR,
            "steady_steps_per_second": steady,
            "steady_sim_years_per_day": steady * 86400.0 / STEPS_PER_SIM_YEAR,
        },
        "host_fractions": {
            "data_loading": summary["time/data_loading"] / duration,
            "writer_and_aggregator": summary["time/writer_and_aggregator"] / duration,
            "device_and_dispatch": (duration - summary["time/data_loading"]
                                    - summary["time/writer_and_aggregator"]) / duration,
        },
        "numerics": {
            "all_steps_finite": finite,
            "n_metric_rows": int(rmse_rows.shape[0]),
            "rmse_mean_over_rollout": float(np.nanmean(rmse_rows)),
            "rmse_last_window_mean": float(np.nanmean(rmse_rows[-args.window:])),
        },
        "time_mean_logs": {k: float(v) for k, v in logs.items() if "time_mean" in k},
    }
    with open(os.path.join(args.out, "rollout_10yr.json"), "w") as f:
        json.dump(artifact, f, indent=1)
    with open(os.path.join(args.out, "metrics_full.json"), "w") as f:
        json.dump({k: float(v) for k, v in logs.items()}, f, indent=1)
    if verbose:
        print(json.dumps(artifact["throughput"] | artifact["host_fractions"]
                         | {"finite": finite, "wall_s": wall, "fast": bool(args.fast),
                            "fused_rank": fused_rank}))
    return artifact


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if args.fast:
        route = ("on K4" if fast_options(args)["fused_rank"] else
                 "unfused (K4 has no instance for this pair of matmul and spectral-IO dtypes)")
        print(f"[rollout_10yr] --fast with --dtype {args.dtype}: the rank pipeline's middle "
              f"{route}", flush=True)
    return rollout_artifact(build_stepper(args), args)


if __name__ == "__main__":
    main()
