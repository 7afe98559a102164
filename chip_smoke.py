#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Phases, each timed:

0. device: the card's name, count, and its ``nvidia-smi`` name and power limit;
1. build: one ``nvcc`` per source in
   ``spherical_dyffusion_tpu_torch/csrc``, all started together, linked into
   one library; prints its seconds and the ``-Xptxas -v`` register, spill
   and shared-memory lines, and checks with ``cuobjdump -sass`` that K1's
   TF32 kernel, the four bf16 K2/K3 instances and the two bf16 K4 instances
   run their products as HGMMA (``wgmma``);
2. K1 (dhconv, 3xTF32 on the tensor cores) at the main path's shape, batch 1
   and 2, through a weight image made once (the image kernel against its
   plain version, and timed apart), against its plain version, with the
   function's bound (its products at the TF32 peak), the bound of three
   TF32 passes over the hi/lo image and the bound of a float32 CUDA-core
   kernel. Every kernel, plain version and library call is timed the same
   way, in a loop of calls between CUDA events; K1 and K4 are also timed
   with the calls queued behind a spin kernel (``device_ms``), which leaves
   out the host work a fast kernel may wait on in such a loop;
3. K2 (fused MLP) at the main path's shapes in bf16 (the forecaster's 64,800
   rows with the float32 residual, and the interpolator's call: 129,600 rows,
   no residual, dropout 0.1), against its plain version, plus its dropout
   statistics and the weight repack kernel against its plain permutation;
   times with dropout off and on;
4. K3 (fused block tail) at the main path's shapes (batch 1 with the
   float32 residual, batch 2 without), straddling tiles, erf gelu, dropout
   masks and float32, against its plain version; K3 with A = 1, C = 0
   against K2, bit for bit; times at batch 2 with dropout off and on;
5. K4 (the CP rank pipeline's fused Legendre analysis, scale and
   synthesis, the zero Legendre triangle skipped from ``l_first``) at the
   fast window's shape (h 180, l = m = 144, R 64) at batch 1 and 2 in bf16
   and float32, at the Pallas prototype's own shape (l = m = 181), on the
   0.25-degree grid (h 721, which the bf16 kernel walks in chunks) and at a
   ragged shape, against its plain version, with its bound over the triangle
   and the dense bound;
6. the window path: both SFNOs at embed 256 x 8 layers on 180 x 360, bf16
   compute (the transforms and dhconv with bf16 operands), K1 and K2 on,
   weights from a seed, one 12-step ``run_window`` (two horizon-6
   segments) at batch 1, cold-sampled by the double-batch scan sampler,
   with the kernels' launch counts (one weight repack per bf16 K2 or K3
   launch, and no K1 weight image: the models made theirs in the warm-up
   window); then the same window with dropout off
   through the kernels and through the plain path, in bf16 and in float32;
7. the fused-tail path: the same window with K1 and K3 (``fused_tail``), the
   peeled sampler and ``scan_layers``, with its launch counts and the
   interpolator's batch sizes; then dropout off, kernels against the plain
   path in float32 and bf16;
8. the fast window (``main_path.FAST_WINDOW``: CP rank 0.25, thresholding
   0.8, bf16 spectral IO, scan and peel, the block MLP unfused) with K4,
   launched 6 x per SFNO forward (blocks 1-6; blocks 0 and 7 change grid and
   contract in spectral space) and K1-K3 never; then dropout off, K4 against
   the plain path in float32 and bf16;
10. the rollout (run after phase 8): the product path of
   ``main_path.product_rollout`` on the fused-tail path at 256 x 8 with bf16
   weights (``params_dtype``), bf16 predictions (``preds_dtype``) and the
   forecaster's EMA weights drawn from seed 1: one warm-up window, then
   ``run_inference`` of 288 steps in three 96-step windows with the
   aggregator on, its rate, sim-yr/day and ``time/*`` splits, K1 and K3
   1,536 launches a window and no K1 weight image made; every log and the
   final state finite; one 12-step rollout at ensemble 2 (CRPS and SSR in
   its logs); with dropout off, a 24-step ``run_inference`` in two 12-step
   windows over a source that does not repeat, run under the sync debug
   mode "error" (no synchronizing CUDA call before the end sync), against
   two ``run_window`` calls chained by hand on inputs read from the source
   here, and the aggregator's per-step RMSE and bias tables against float64
   numpy;
9. profile: one ``torch.profiler`` pass over one window of each path, the
   top 10 CUDA kernels by total time and the kernel time by group;
11. training (run right after the build, while the process holds nothing
   else, so that its peak memory is training's own): (a) K1's backward at the main path's shapes, batch
   1 and 2: dx (K1 over the conjugate-transposed image) and dW (a float32
   ``torch.bmm``) against autograd of the plain version, the backward image
   against its plain version, and the dx kernel (event loop and
   ``device_ms``), the backward image, the dW product, one complex
   ``torch.matmul`` computing dx and autograd of complex ``torch.matmul``
   (dx and dW) timed; (b) ``main_path.train_steps`` at 256 x 8, 180 x 360,
   float32, K1 on: 6 interpolator steps, then 6 forecaster steps with the
   interpolator frozen in ``p_losses``: per-step losses (finite), the median
   step ms after 2 warm-up steps, steps/s, the forward / backward /
   optimizer-and-EMA split (CUDA events), peak device memory, K1 launches
   per step (8 forward and 8 dx per trained SFNO, 8 more for the frozen
   interpolator in a forecaster step) and K1 images per step (16, and 8
   more at the forecaster's first step); the loss at a fixed timestep on a
   batch repeated for 10 steps (dropout off, constant lr) falls; (c) with
   dropout off and the timesteps fixed, 3 steps of each experiment at
   constant lr 4e-4 through the kernels against 3 through the plain path
   from the same weights and batches: at every step the loss (1e-5
   relative), every gradient (1e-4 of its largest entry, or of 1e-4 of the
   network's where it cancels below that; where the L1 loss's sign flips at
   an output entry, the plain path's gradient taken at the kernels' output
   cotangent), every gradient finite and every filter weight's non-zero
   (F5); the parameters after the 3 updates (1e-6 plus AdamW's response to
   the measured gradient difference);
12. checkpoints and the command lines (run right after phase 11), in a
   temporary directory: (a) ``train.run_model`` with
   ``experiment=debug_interpolation``, then ``debug_dyffusion`` with the
   first run's checkpoint as its interpolator, through the port's JSON
   configs with dotlist overrides: embed 256 x 8 on 180 x 360, 35 channels
   and 2 forcings, batch 1, K1 on, 2 steps each: every step's ms
   (synchronized) with its K1 launches (16 and 24 a step, 8 of them dx, as
   in phase 11), each checkpoint's bytes and write seconds, its read seconds,
   and its parameters and EMA reloaded bit for bit; (b)
   ``run_inference.main_from_config`` from the forecaster's checkpoint: 24
   steps in windows of 12, K1 and K3 in both networks, bf16 compute and
   transforms, the EMA: steps/s, 8 K1 and 8 K3 launches per SFNO forward,
   ``metrics.json`` finite; then float32 with the interpolator's dropout
   off through the kernels and the plain path: final states and logs within
   1e-4; (c) a reference Lightning checkpoint built from (a)'s networks
   (``sfno_flax_to_torch``, ``model.model.*``, ``model.interpolator.model.*``,
   ``model_ema.*``, SFNO/datamodule/DYffusion hyperparameters), loaded by
   ``load_experiment_checkpoint`` with gelu_exact, exact_norm and
   exact_dropout and its weights equal bit for bit; a 12-step window with K1
   and the exact dropout live, whose host-to-device bytes in one window
   (counted by a dispatch mode that sees every aten op, beside a 1 MiB
   control copy) stay below 1% of one activation;
   dropout off, kernels against the plain path within 1e-4; (d)
   ``results/skill_fast08/forecaster.msgpack`` decoded by
   ``utils/flax_msgpack.py`` and loaded strictly into its SFNO;
13. the model options at 256 x 8 on 180 x 360 (run last, after phase 9):
   (a) the Tucker window (``main_path.TUCKER_WINDOW``: Tucker rank 0.25 on
   the rank pipeline, 2R = 128, bf16, scan and peel, K3 on): one warm-up
   and one timed 12-step window beside phase 7's, K3 launched 192 x and
   K1, K2, K4 never; then float32 with dropout off, K3 against the plain
   path (1e-4 of the largest prediction); (b) phase 7's fused-tail window
   with ``sht_fold_symmetry``: its seconds beside phase 7's, K1 and K3 192
   launches each; float32 with dropout off, folded against unfolded from
   the same weights (1e-4); (c) ``main_path.train_steps`` on
   ``build_training(scan_layers=True, checkpointing=3)``: float32, K1 on,
   dropout and DropPath live, 6 steps of each experiment, the median step ms
   and peak memory beside phase 11's (both from a card that the earlier
   phases left empty); per step 16 K1 forwards (8 of them
   the recompute) and 8 dx per trained SFNO, 8 more forwards of the frozen
   interpolator in a forecaster step, 16 K1 weight images; then 3 steps of
   each experiment with remat and 3 without, from the same weights,
   batches and generator seed, dropout live: at every step the losses and
   every gradient within 1e-6 of the tensor's largest entry and the
   generators' states equal; (d) one float32 forward at batch 1 of each
   other option (TT rank 0.25, Tucker in spectral space, the non-linear
   filter shared and per degree, layer norm, the FFT transform with K1,
   ``lon_method="fft"`` with K1, the merged dhconv, a separable dhconv, and
   the diagonal filter at embed 64, since at 256 its weight is 17.1 GB a
   block): finite, its ms; and one forecaster training step with
   ``data+noise-v2`` on a model built with the extra condition channels:
   its loss finite and, in one step under the dispatch mode, no
   activation-sized bytes copied from the host.

It prints a ``training`` JSON line (phase 11's figures), a ``cli`` JSON line
(phase 12's), an ``options`` JSON line (phase 13's), a ``kernels`` JSON line
(K1's backward dx as its own entry; ``launches_by_path`` holds phase 12
(b)'s counts as ``"cli"`` and phase 13's as ``"tucker"``, ``"fold"`` and
``"remat"``), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It needs the port's package beside it
and a CUDA card; without either it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

F32_PEAK = 67e12  # FLOP/s, float32 outside the tensor cores (H100 SXM data sheet)
TF32_PEAK = 495e12  # FLOP/s, dense TF32 tensor cores
BF16_PEAK = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_RATE = 3.35e12  # bytes/s
N_STEPS = 12
STEPS_PER_SIM_YEAR = 1460  # 6-hour steps
TRAIN_STEPS = 6  # per experiment in phase 11
CMP_STEPS = 3  # per experiment, kernels against the plain path, in phase 11 (c)
SPIN_CYCLES = 200_000_000  # about 0.1 s of torch.cuda._sleep at the H100's clocks
ROLLOUT_STEPS, ROLLOUT_WINDOW = 288, 96
CLI_STEPS = 24  # the inference command line's rollout in phase 12, in windows of 12
REF_STEPS = 12  # the reference checkpoint's window in phase 12
# phase 13: width, depth and grid of the option runs; the diagonal filter's
# width (at 256 its weight, 256 x 256 x 180 x 181 pairs, is 17.1 GB a block)
OPT_EMBED, OPT_LAYERS, OPT_SHAPE = 256, 8, (180, 360)
OPT_DIAG_EMBED = 64
REMAT_STEPS = 6  # per experiment in phase 13 (c)
REMAT_CMP_STEPS = 3  # per experiment, remat against no remat, in phase 13 (c)
# what the earlier phases may leave allocated when phase 13 (c) starts (the
# window inputs, about 20 MB, and small caches): its peak is read as the
# trainers' own
REMAT_LIVE_GB = 0.1
# phase 14: width, depth and grid of the training modes; steps of the bf16
# runs (c, d), of the fused epoch and the streamed one (a, b, batch 1), the
# streaming segment, the rollout validation's steps (e: two horizon-6
# windows) and the steps of the histogram fits (f)
MODES_EMBED, MODES_LAYERS, MODES_SHAPE = 256, 8, (180, 360)
MODES_STEPS, FUSED_STEPS, SEGMENT_SAMPLES = 3, 8, 4
ROLLOUT_VAL_STEPS, HIST_STEPS = 12, 4
# phase 14 (c): a bf16-compute step against the float32 step from the same
# weights and batch. The losses' relative gap was 4.8e-6 (forecaster) and
# 6.9e-6 (interpolator) at 256 x 8 on the H100 (this script's phase 14,
# PERF.md): held to BF16_VS_F32_LOSS. The gradient norms (before clipping)
# must differ by more than BF16_GRAD_NORM_FLOOR (relative), as the CPU test
# (tests/test_torch_port_train_modes.py, F32_VS_BF16) holds the bf16
# gradients apart from the float32 ones: a step that computed in float32
# through the same kernels repeats the norm up to the order of its float32
# sums (about 1e-7), so the floor shows that the bf16 path ran.
BF16_VS_F32_LOSS = 5e-5
BF16_GRAD_NORM_FLOOR = 1e-5
# The fused-tail window in bf16 against the plain path in bf16, as a
# multiple of the plain path's own bf16 error (bf16 against float32): the
# fused tail rounds the folded norm input to bf16 once more. The CPU test
# (tests/test_torch_port_tail.py, BF16_TAIL_VS_PLAIN) measured a ratio of
# 0.76 at debug size and holds it to 2; a ratio scales with width and depth
# where an absolute gap does not.
BF16_TAIL_VS_PLAIN = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def host_to_device():
    """A dispatch mode recording ``(op, bytes)`` for every host tensor that
    an aten op reads into a result on a CUDA device: ``.to``/``copy_`` from
    the host, a host tensor in an op on the card, and a tensor constructor
    (``torch.tensor``/``as_tensor``, its ``lift_fresh``) whose result is on
    the card (counted whole: its data may come from the host). Every op
    dispatched while it is on passes through it, the backward's too, so
    unlike a profiler trace it drops no record. Use as
    ``with host_to_device() as seen: ...``, then read ``seen.copies``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class HostToDevice(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            if any(isinstance(o, torch.Tensor) and o.is_cuda for o in tree_leaves(out)):
                fresh = func is torch.ops.aten.lift_fresh.default
                for a in ins:
                    if fresh or a.device.type == "cpu":
                        self.copies.append((str(func), a.numel() * a.element_size()))
            return out

    return HostToDevice()


def live_cuda_tensors(top: int = 10):
    """The CUDA storages that Python objects keep alive: (their bytes, the
    ``top`` largest as (GB, shape, dtype))."""
    import gc

    import torch

    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes() / 1e9, tuple(o.shape), str(o.dtype)))
    return (sum(v[0] for v in seen.values()) * 1e9,
            sorted(seen.values(), key=lambda v: -v[0])[:top])


def phase12(smi_line, wrappers, report, runs) -> None:
    """Phase 12: the product path from checkpoint files at 256 x 8 on 180 x
    360, in a temporary directory: (a) the train command line, (b) the
    inference command line from its checkpoint, (c) a reference Lightning
    checkpoint built from (a)'s networks, (d) the trained CP forecaster of
    ``results/skill_fast08`` decoded without flax."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import interface, main_path
    from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config
    from spherical_dyffusion_tpu_torch.train import run_model
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer
    from spherical_dyffusion_tpu_torch.utils import flax_msgpack
    from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
    from spherical_dyffusion_tpu_torch.utils.torch_convert import sfno_flax_to_torch

    cli = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    d = Path(tmp.name)

    def equal_sd(got, want):
        return set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k].cpu())
                                             for k in want)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    # (a) the train command line: the interpolator, then the forecaster,
    # two steps each; every step timed (synchronized) with its K1 launches,
    # those of the backward (dx) apart, and every checkpoint write timed
    common = [f"ckpt_dir={d}", f"++log_dir={d / 'logs'}", "trainer.epochs=1",
              "++trainer.steps_per_epoch=2", "datamodule.n_timesteps=8",
              "datamodule.height=180", "datamodule.width=360", "datamodule.channels=35",
              "datamodule.n_forcing=2", "datamodule.batch_size=1",
              "++datamodule.max_val_samples=1", "++trainer.num_predictions=2",
              "model.embed_dim=256", "model.num_layers=8", "++model.use_pallas=true",
              "verbose=false"]
    steps, writes = [], []
    real_step, real_save, real_grad = Trainer.train_step, Trainer.save_checkpoint, \
        torch.autograd.grad
    backward = [0]

    def timed_step(self, *a, **k):
        torch.cuda.synchronize()
        n0, b0, t0 = dhconv.launches, backward[0], time.perf_counter()
        out = real_step(self, *a, **k)
        torch.cuda.synchronize()
        steps.append(dict(exp=type(self.exp).__name__, ms=(time.perf_counter() - t0) * 1e3,
                          k1=dhconv.launches - n0, k1_backward=backward[0] - b0))
        return out

    def counted_grad(*a, **k):
        n0 = dhconv.launches
        out = real_grad(*a, **k)
        backward[0] += dhconv.launches - n0
        return out

    def timed_save(self, state, path):
        t0 = time.perf_counter()
        real_save(self, state, path)
        writes.append(dict(path=path, seconds=time.perf_counter() - t0,
                           bytes=os.path.getsize(path)))

    Trainer.train_step, Trainer.save_checkpoint = timed_step, timed_save
    torch.autograd.grad = counted_grad
    try:
        zero_counts()
        t0 = time.perf_counter()
        ip = run_model(None, ["experiment=debug_interpolation"] + common)
        fc = run_model(None, ["experiment=debug_dyffusion",
                              f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"]
                       + common)
        train_s = time.perf_counter() - t0
    finally:
        Trainer.train_step, Trainer.save_checkpoint = real_step, real_save
        torch.autograd.grad = real_grad
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"train command line launched kernels without a backward: {off}")
    per_step = {"InterpolationExperiment": (16, 8), "DYffusionForecastingExperiment": (24, 8)}
    for s in steps:
        check((s["k1"], s["k1_backward"]) == per_step[s["exp"]],
              f"train command line {s['exp']}: K1 launches {s['k1']} (backward "
              f"{s['k1_backward']}) a step, expected {per_step[s['exp']]} as in phase 11")
    check([s["exp"] for s in steps] == ["InterpolationExperiment"] * 2
          + ["DYffusionForecastingExperiment"] * 2, f"train command line steps {steps}")
    for name, run in (("interpolator", ip), ("forecaster", fc)):
        check(all(np.isfinite(run["history"]["step_losses"])), f"{name}: a non-finite loss")
        path = run["ckpt_path"]
        write = [w for w in writes if w["path"] == path][-1]
        t0 = time.perf_counter()
        Trainer.load_checkpoint(path)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp, params, ema, _ = interface.load_experiment_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = run["trainer"].state
        same = (equal_sd(params, state.model.state_dict())
                and equal_sd(exp.model.state_dict(), state.model.state_dict())
                and equal_sd(ema, state.ema.state_dict()))
        check(same, f"{name}: the reloaded parameters or EMA differ from the trainer's")
        ms = [s["ms"] for s in steps if (s["exp"] == "InterpolationExperiment") ==
              (name == "interpolator")]
        cli[name] = dict(step_ms=ms, losses=run["history"]["step_losses"],
                         ckpt_bytes=write["bytes"], write_s=write["seconds"], read_s=read_s,
                         load_experiment_s=load_s)
        log(f"train command line {name}: step ms {[round(v, 2) for v in ms]} (synchronized "
            f"around each step; phase 11's median "
            f"{report['training'][name]['step_ms']:.2f} ms), losses "
            f"{[round(v, 5) for v in run['history']['step_losses']]}; checkpoint "
            f"{write['bytes'] / 1e9:.3f} GB written in {write['seconds']:.2f} s, read "
            f"(torch.load) in {read_s:.2f} s, load_experiment_checkpoint {load_s:.2f} s; "
            f"params and EMA reload bit for bit; on {smi_line}")
        del exp, params, ema
    log(f"train command line: both experiments built, trained and saved in {train_s:.2f} s; "
        f"K1 launches a step {[s['k1'] for s in steps]} (backward "
        f"{[s['k1_backward'] for s in steps]})")
    fc_exp, fc_ema = fc["trainer"].exp, fc["trainer"].state.ema.state_dict()
    del ip
    torch.cuda.empty_cache()

    # (b) the inference command line from the forecaster's checkpoint (and,
    # through its config, the interpolator's): K1 and K3 in both networks,
    # bf16 compute and transforms, the EMA
    forwards = []
    real_forward = SFNO.forward

    def counted_forward(self, *a, **k):
        forwards.append(a[0].shape[0])
        return real_forward(self, *a, **k)

    def infer(model, out, **extra):
        over = {"model": model, "interpolator_model": model, **extra}
        return main_from_config({"checkpoint_path": fc["ckpt_path"], "use_ema": True,
                                 "n_forward_steps": CLI_STEPS, "forward_steps_in_memory": 12,
                                 "experiment_dir": str(d / out), "log_zonal_mean_images": False,
                                 "verbose": False, "overrides": over})

    bf16 = dict(use_pallas=True, fused_tail=True, compute_dtype="bfloat16",
                sht_matmul_dtype="bfloat16")
    zero_counts()
    SFNO.forward = counted_forward
    try:
        t0 = time.perf_counter()
        out = infer(bf16, "bf16")
        wall = time.perf_counter() - t0
    finally:
        SFNO.forward = real_forward
    launches = {k: fn.launches for k, fn in wrappers.items()}
    runs["cli"] = dict(launches=launches)
    summary = out["summary"]
    log(f"inference command line, {CLI_STEPS} steps in windows of 12 from the checkpoint, bf16, "
        f"K1 and K3, EMA: {wall:.2f} s with loading; duration {summary['duration_s']:.3f} s, "
        f"total {summary['total_steps_per_second']:.3f} steps/s, steady "
        f"{summary['steady_steps_per_second']:.3f} steps/s (phase 7's fused-tail window is "
        f"printed below); SFNO forwards {len(forwards)}, launches {launches}; on {smi_line}")
    for k, n in (("K1", 8), ("K3", 8), ("K2", 0), ("K4", 0)):
        check(bool(forwards) and launches[k] == n * len(forwards),
              f"inference command line: {k} launched {launches[k]} times in {len(forwards)} "
              f"SFNO forwards, expected {n} a forward")
    metrics = json.loads((d / "bf16" / "metrics.json").read_text())
    logs = {k: v for k, v in metrics.items() if k.startswith("inference/")}
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    check(len(logs) > 20 and not bad and metrics["n_forward_steps"] == CLI_STEPS,
          f"inference command line metrics.json: {len(logs)} metrics, non-finite {bad[:4]}")
    cli["inference"] = dict(steps=CLI_STEPS, wall_s=wall, forwards=len(forwards),
                            launches=launches, **{k: summary[k] for k in (
                                "duration_s", "total_steps_per_second",
                                "steady_steps_per_second")})
    del out

    # float32, the interpolator's dropout off: through the kernels and
    # through the plain path, final states and logs
    finals = []
    real_window = DYffusionStepper.run_window

    def recorded(self, *a, **k):
        result = real_window(self, *a, **k)
        finals.append(result[0])
        return result

    det = {}
    DYffusionStepper.run_window = recorded
    try:
        for kernels in (True, False):
            finals.clear()
            model = dict(use_pallas=kernels, fused_tail=kernels)
            det[kernels] = (infer(model, f"f32_{kernels}", diffusion={
                "enable_interpolator_dropout": False})["logs"], finals[-1])
    finally:
        DYffusionStepper.run_window = real_window
    (lk, xk), (lp, xp) = det[True], det[False]
    state_rel = float((xk - xp).abs().max() / xp.abs().max())
    log_rel = max(abs(lk[k] - v) / max(abs(v), 100.0 if "percent_diff" in k else 1.0)
                  for k, v in lp.items())
    log(f"inference command line float32, dropout off, {CLI_STEPS} steps: kernels against the "
        f"plain path: final state max gap {state_rel:.3e} of its largest value, logs max gap "
        f"{log_rel:.3e} of each value (or of 1; tolerance 1e-4, phase 7's)")
    check(set(lk) == set(lp) and state_rel <= 1e-4 and log_rel <= 1e-4,
          "inference command line: the kernels disagree with the plain path")
    cli["inference"].update(f32_state_rel=state_rel, f32_logs_rel=log_rel)
    del det, finals, xk, xp
    torch.cuda.empty_cache()

    # (c) a reference Lightning checkpoint from (a)'s networks, through the
    # upstream names (sfno_flax_to_torch): the forecaster under model.model,
    # the interpolator under model.interpolator.model, LitEma shadows
    nets = {"model.model.": fc_exp.model.state_dict(),
            "model.interpolator.model.": fc_exp.interpolator.model.state_dict()}
    sd = {}
    for prefix, net in list(nets.items()) + [("model_ema.", fc_ema)]:
        for k, v in sfno_flax_to_torch(state_dict_to_flax(net), mlp_dropout=True).items():
            key = "model_ema." + ("model." + k).replace(".", "") if prefix == "model_ema." \
                else prefix + k
            sd[key] = torch.from_numpy(v)
    names = list(fc_exp.in_packer.names)
    forcings = list(fc_exp.forcing_names)
    check(len(names) == 35 and len(forcings) == 2, f"state {len(names)}, forcings {forcings}")
    hp = {"model_config": {"_target_": "src.models.sfno.sfnonet."
                                       "SphericalFourierNeuralOperatorNet",
                           "embed_dim": 256, "num_layers": 8, "dropout_mlp": 0.1,
                           "drop_path_rate": 0.1},
          "datamodule_config": {"_target_": "src.datamodules.fv3gfs.FV3GFSDataModule",
                                "in_names": names + forcings, "forcing_names": forcings,
                                "out_names": names, "horizon": 6, "window": 1},
          "diffusion_config": {"_target_": "src.diffusion.dyffusion.DYffusion",
                               "forward_conditioning": "none", "time_encoding": "dynamics"}}
    ref_path = str(d / "reference.ckpt")
    t0 = time.perf_counter()
    torch.save({"state_dict": sd, "hyper_parameters": hp, "epoch": 1}, ref_path)
    ref_write = time.perf_counter() - t0
    ref_bytes = os.path.getsize(ref_path)
    del sd
    t0 = time.perf_counter()
    exp, _, ema, cfg = interface.load_experiment_checkpoint(
        ref_path, overrides={"model": {"use_pallas": True}})
    torch.cuda.synchronize()
    ref_load = time.perf_counter() - t0
    mc = exp.model.cfg
    check((mc.activation_function, mc.exact_norm, mc.exact_dropout) ==
          ("gelu_exact", True, True) and exp.interpolator.model.cfg.exact_dropout,
          f"reference checkpoint: the model is not the exact-form one: {mc}")
    check(equal_sd(exp.model.state_dict(), nets["model.model."])
          and equal_sd(exp.interpolator.model.state_dict(), nets["model.interpolator.model."])
          and equal_sd(ema, fc_ema), "reference checkpoint: the weights differ")
    log(f"reference checkpoint: {ref_bytes / 1e9:.3f} GB written in {ref_write:.2f} s, loaded "
        f"in {ref_load:.2f} s (gelu_exact, exact_norm, exact_dropout), weights and EMA equal "
        f"bit for bit")
    inp = main_path.window_inputs(REF_STEPS, seed=5, device="cuda")
    stepper = DYffusionStepper(exp, use_ema_params=True, ema_params=ema)

    def ref_window(st, seed=0):
        out = st.run_window(inp["x0"], inp["forcing"], None, None,
                            torch.Generator().manual_seed(seed), REF_STEPS)
        torch.cuda.synchronize()
        return out

    ref_window(stepper)  # warm-up: K1's images, cuBLAS
    zero_counts()
    t0 = time.perf_counter()
    x_out, preds = ref_window(stepper, 1)
    ref_s = time.perf_counter() - t0
    ref_launches = {k: fn.launches for k, fn in wrappers.items()}
    check(ref_launches["K1"] > 0 and bool(torch.isfinite(preds).all()),
          f"reference checkpoint window: launches {ref_launches}, finite "
          f"{bool(torch.isfinite(preds).all())}")
    # exact dropout draws its uniforms on the card: count the bytes copied
    # from the host in one window under the dispatch mode, beside a 1 MiB
    # copy made on purpose in it (the mode has to see that one)
    act_bytes = 180 * 360 * 256 * 4
    control = torch.ones(1 << 18)
    with host_to_device() as seen:
        control.to("cuda")
        ref_window(stepper, 2)
    h2d = [b for _, b in seen.copies]
    h2d_bytes = sum(h2d) - control.numel() * 4
    log(f"reference checkpoint, {REF_STEPS} steps with the interpolator's exact dropout live "
        f"(K1 on): {ref_s:.3f} s, launches {ref_launches}; host-to-device in one window: "
        f"{len(h2d)} copies, {sum(h2d)} bytes, {h2d_bytes} besides the 1 MiB control "
        f"(one activation is {act_bytes} bytes)")
    check(h2d.count(control.numel() * 4) == 1,
          "the dispatch mode did not see the 1 MiB control copy once")
    check(h2d_bytes < act_bytes // 100,
          f"exact dropout: {h2d_bytes} bytes copied from the host in one window")
    del stepper, exp, x_out, preds
    torch.cuda.empty_cache()

    def ref_det(kernels):
        e, _, e_ema, _ = interface.load_experiment_checkpoint(ref_path, overrides={
            "model": {"use_pallas": kernels}, "diffusion": {"enable_interpolator_dropout": False}})
        return ref_window(DYffusionStepper(e, use_ema_params=True, ema_params=e_ema))[1]

    pk, pp = ref_det(True), ref_det(False)
    ref_rel = float((pk - pp).abs().max() / pp.abs().max())
    log(f"reference checkpoint float32, dropout off: kernels against the plain path max gap "
        f"{ref_rel:.3e} of the largest prediction (tolerance 1e-4)")
    check(ref_rel <= 1e-4, "reference checkpoint: the kernels disagree with the plain path")
    cli["reference"] = dict(bytes=ref_bytes, write_s=ref_write, load_s=ref_load,
                            window_s=ref_s, launches=ref_launches, h2d_bytes=h2d_bytes,
                            f32_rel=ref_rel)
    del pk, pp, fc, fc_exp, fc_ema, nets
    os.remove(ref_path)
    torch.cuda.empty_cache()

    # (d) the trained CP forecaster, decoded by the port's reader
    path = Path(__file__).resolve().parent / "results" / "skill_fast08" / "forecaster.msgpack"
    t0 = time.perf_counter()
    tree = flax_msgpack.read(str(path))
    decode_s = time.perf_counter() - t0
    net = SFNO(SFNOConfig(img_shape=(64, 128), in_chans=4, out_chans=2, embed_dim=64,
                          num_layers=4, with_time_emb=True, min_time=0, max_time=5,
                          hard_thresholding_fraction=0.8, factorization="cp", rank=0.25))
    sd = flax_to_state_dict(tree)
    net.load_state_dict(sd, strict=True)
    leaves = len(sd)
    nbytes = sum(v.numel() * v.element_size() for v in sd.values())
    log(f"results/skill_fast08 forecaster: {path.stat().st_size} bytes decoded without flax in "
        f"{decode_s:.3f} s; {leaves} parameter leaves, {nbytes} bytes, loaded strictly")
    cli["skill_fast08"] = dict(leaves=leaves, bytes=nbytes, decode_s=decode_s)
    tmp.cleanup()
    report["cli"] = cli


def phase13(smi_line, wrappers, report, runs, drive, pair, other, device="cuda") -> None:
    """Phase 13: the model options at OPT_EMBED x OPT_LAYERS on OPT_SHAPE:
    (a) the Tucker window, (b) the folded window, (c) remat training, (d)
    one forward of each other option and one data+noise forecaster step.
    ``drive`` and ``pair`` are phase 6's window helpers, ``other`` the
    model-driven channels."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = OPT_LAYERS
    H, W = OPT_SHAPE
    opts = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def free():
        """Collect the dead networks of earlier phases (reference cycles
        keep some of them until the cyclic collector runs) and return the
        cache, so that a peak-memory figure counts only what is live."""
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def model_gap(kern, plain):
        """max |kernels - plain| over the largest model-driven prediction."""
        return (kern - plain).abs().max().item() / plain[..., other].abs().max().item()

    fused_tail_s = runs["fused_tail"]["seconds"]

    # (a) the Tucker window: the rank pipeline in blocks 1-6, K3 in every block
    tucker_kw = dict(main_path.TUCKER_WINDOW)
    run = drive("Tucker window", tucker_kw, {"K1": 0, "K2": 0, "K3": L, "K4": 0})
    runs["tucker"] = run
    log(f"Tucker window (rank 0.25, 2R = {OPT_EMBED // 2}): {N_STEPS} steps in "
        f"{run['seconds']:.3f} s against phase 7's fused-tail window {fused_tail_s:.3f} s "
        f"on {smi_line}")
    check(run["launches"]["K3"] == 24 * L and run["forwards"] == 24,
          f"Tucker window: K3 launched {run['launches']['K3']} times in {run['forwards']} "
          f"SFNO forwards, expected {24 * L}")
    pk, pp = pair("float32", tucker_kw, dict(tucker_kw, fused_tail=False))
    tucker_gap = model_gap(pk, pp)
    log(f"Tucker window float32, dropout off: max |K3 - plain| {tucker_gap:.3e} of the "
        f"largest model-driven prediction (tolerance 1e-4)")
    check(tucker_gap <= 1e-4, "Tucker window float32: K3 disagrees with the plain path")
    del pk, pp
    free()
    opts["tucker"] = dict(seconds=run["seconds"], steps_per_s=N_STEPS / run["seconds"],
                          phase7_seconds=fused_tail_s, launches=run["launches"],
                          f32_rel=tucker_gap)

    # (b) the folded window: phase 7's path with sht_fold_symmetry
    fold_kw = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True,
                   sht_fold_symmetry=True)
    run = drive("folded window", fold_kw, {"K1": L, "K2": 0, "K3": L, "K4": 0})
    runs["fold"] = run
    log(f"folded window: {N_STEPS} steps in {run['seconds']:.3f} s against phase 7's unfolded "
        f"fused-tail window {fused_tail_s:.3f} s ({run['seconds'] / fused_tail_s - 1:+.1%}) "
        f"on {smi_line}")
    check(run["launches"]["K1"] == run["launches"]["K3"] == 24 * L,
          f"folded window: launches {run['launches']}, expected K1 and K3 {24 * L}")
    pk, pp = pair("float32", fold_kw, dict(fold_kw, sht_fold_symmetry=False))
    fold_gap = model_gap(pk, pp)
    log(f"folded window float32, dropout off: max |folded - unfolded| {fold_gap:.3e} of the "
        f"largest model-driven prediction (tolerance 1e-4)")
    check(fold_gap <= 1e-4, "folded window float32: folded and unfolded disagree")
    del pk, pp
    free()
    opts["fold"] = dict(seconds=run["seconds"], steps_per_s=N_STEPS / run["seconds"],
                        phase7_seconds=fused_tail_s, launches=run["launches"],
                        f32_rel=fold_gap)

    # (c) remat training: scan_layers and checkpointing=3, float32, K1 on,
    # dropout and DropPath live
    size = dict(embed=OPT_EMBED, layers=L, img_shape=OPT_SHAPE, device=device)
    free()
    # the earlier phases drop what they built, so the peak below is the
    # trainers' own, as phase 11's
    live_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    if live_gb > REMAT_LIVE_GB:
        _, largest = live_cuda_tensors()
        log(f"remat training: the largest CUDA tensors still live: {largest}")
    log(f"remat training: {live_gb:.3f} GB allocated on the card before the trainers are built")
    check(live_gb <= REMAT_LIVE_GB,
          f"remat training: {live_gb:.3f} GB left live by the earlier phases, more than "
          f"{REMAT_LIVE_GB} GB")
    zero_counts()
    t0 = time.perf_counter()
    trainers = main_path.build_training(scan_layers=True, checkpointing=3,
                                        n_samples=REMAT_STEPS, **size)
    rec = main_path.train_steps(n_steps=REMAT_STEPS, trainers=trainers)
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"remat training launched kernels without a backward: {off}")
    log(f"remat training: {REMAT_STEPS} steps of each experiment, built and run in "
        f"{time.perf_counter() - t0:.2f} s")
    # per step: (K1 launches, those in the backward, dx): the forward, the
    # recompute and dx per trained SFNO; the frozen interpolator's forward
    # in a forecaster step
    per_step = {"interpolator": (3 * L, 2 * L, L), "forecaster": (4 * L, 2 * L, L)}
    remat = {}
    k1_total = 0
    for name, r in rec.items():
        med = float(np.median(r["step_ms"][2:]))
        peak = r["peak_bytes"] / 1e9 if r["peak_bytes"] is not None else float("nan")
        ref = report["training"][name]
        log(f"remat training {name}: losses {[round(v, 5) for v in r['losses']]}; step ms "
            f"{[round(v, 1) for v in r['step_ms']]}, median after 2 warm-up steps {med:.2f} ms "
            f"(phase 11 without remat {ref['step_ms']:.2f} ms, {med / ref['step_ms'] - 1:+.1%}); "
            f"peak device memory {peak:.3f} GB (phase 11 {ref['peak_gb']:.3f} GB); K1 launches "
            f"per step {r['k1_launches']} (backward {r['k1_backward']}, dx {r['k1_dx']}), "
            f"images per step {r['k1_images']} on {smi_line}")
        check(all(np.isfinite(v) for v in r["losses"]), f"remat training {name}: a non-finite loss")
        got = list(zip(r["k1_launches"], r["k1_backward"], r["k1_dx"]))
        check(got == [per_step[name]] * REMAT_STEPS,
              f"remat training {name}: K1 (launches, backward, dx) per step {got}, expected "
              f"{per_step[name]}")
        images = [2 * L] * REMAT_STEPS
        if name == "forecaster":
            images[0] += L
        check(r["k1_images"] == images,
              f"remat training {name}: K1 images per step {r['k1_images']}, expected {images}")
        k1_total += sum(r["k1_launches"])
        remat[name] = dict(step_ms=med, steps_per_s=1e3 / med, peak_gb=peak,
                           phase11_step_ms=ref["step_ms"], phase11_peak_gb=ref["peak_gb"],
                           live_gb_before=live_gb,
                           losses=r["losses"], k1_launches=sum(r["k1_launches"]),
                           k1_dx=sum(r["k1_dx"]))
    runs["remat"] = dict(launches={"K1": k1_total, "K2": 0, "K3": 0, "K4": 0})
    del trainers, rec
    free()

    # remat against no remat: the same weights, batches and generator seed,
    # dropout live; the gradients taken from inside each train step
    kw = dict(scan_layers=True, n_samples=REMAT_CMP_STEPS, **size)
    with_remat = main_path.build_training(checkpointing=3, **kw)
    without = main_path.build_training(checkpointing=0, **kw)
    real_grad = torch.autograd.grad
    grabbed = []

    def grab(*a, **k):
        out = real_grad(*a, **k)
        grabbed.append([g.detach().clone() for g in out])
        return out

    for name in ("interpolator", "forecaster"):
        a, b = with_remat[name], without[name]
        b.exp.model.load_state_dict(a.exp.model.state_dict())
        if name == "forecaster":
            b.exp.interpolator.model.load_state_dict(a.exp.interpolator.model.state_dict())
        states = (a.init_state(), b.init_state())
        gens = (torch.Generator().manual_seed(13), torch.Generator().manual_seed(13))
        l_rel = g_rel = 0.0
        same_gen = True
        batches = [x for _, x in zip(range(REMAT_CMP_STEPS), a.dm.train_batches(seed=0))]
        torch.autograd.grad = grab
        try:
            for batch in batches:
                losses = []
                for tr, state, gen in zip((a, b), states, gens):
                    dyn, cond, rt = tr.upload(batch)
                    losses.append(float(tr.train_step(state, dyn, cond, gen, rt)["loss"]))
                gb = grabbed.pop()
                ga = grabbed.pop()
                l_rel = max(l_rel, abs(losses[0] - losses[1]) / abs(losses[1]))
                for x, y in zip(ga, gb):
                    d, sc = float((x - y).abs().max()), float(y.abs().max())
                    g_rel = max(g_rel, d / sc if sc > 0 else (0.0 if d == 0 else float("inf")))
                same_gen &= torch.equal(gens[0].get_state(), gens[1].get_state())
                del ga, gb
        finally:
            torch.autograd.grad = real_grad
        log(f"remat against no remat, {name}, {REMAT_CMP_STEPS} steps, dropout live: losses max "
            f"rel gap {l_rel:.3e}, gradients max gap {g_rel:.3e} of each tensor's largest entry "
            f"(tolerance 1e-6), generator states {'equal' if same_gen else 'DIFFERENT'} after "
            f"every step")
        check(l_rel <= 1e-6 and g_rel <= 1e-6 and same_gen,
              f"remat {name}: losses, gradients or generator state differ from no remat")
        remat[name]["vs_no_remat"] = dict(steps=REMAT_CMP_STEPS, loss_rel=l_rel, grad_rel=g_rel,
                                          generator_equal=same_gen)
    del with_remat, without, states
    free()
    opts["remat"] = remat

    # (d) one float32 forward at batch 1 of each other option
    base = main_path.sfno_configs(OPT_EMBED, L, "float32", OPT_SHAPE, use_pallas=False,
                                  fused_mlp=False)[1]
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((1, H, W, base.out_chans), device=dev, generator=g)
    forcing = torch.randn((1, H, W, base.in_chans - base.out_chans), device=dev, generator=g)
    t = torch.ones(1, device=dev)
    cases = {
        "TT rank 0.25": dict(factorization="tt", rank=0.25),
        "Tucker rank 0.25 in spectral space": dict(factorization="tucker", rank=0.25,
                                                   rank_pipeline=False),
        "non-linear filter, shared (diagonal)": dict(filter_type="non-linear",
                                                     operator_type="diagonal"),
        "non-linear filter, per degree (l-dependant)": dict(filter_type="non-linear",
                                                            operator_type="l-dependant"),
        "layer norm": dict(normalization_layer="layer_norm"),
        "FFT transform, K1": dict(spectral_transform="fft", use_pallas=True),
        "SHT with lon_method fft, K1": dict(lon_method="fft", use_pallas=True),
        "merged dhconv": dict(merged_dhconv=True),
        "separable dhconv": dict(separable=True),
        f"diagonal filter at embed {OPT_DIAG_EMBED}": dict(operator_type="diagonal",
                                                           embed_dim=OPT_DIAG_EMBED),
    }
    log(f"option forwards: the diagonal filter runs at embed {OPT_DIAG_EMBED}: at "
        f"{OPT_EMBED} its weight (ci, co, l, m, 2) float32 is "
        f"{OPT_EMBED ** 2 * H * (W // 2 + 1) * 2 * 4 / 1e9:.1f} GB a block, "
        f"{L * OPT_EMBED ** 2 * H * (W // 2 + 1) * 2 * 4 / 1e9:.0f} GB over {L} blocks, "
        f"beyond the card's memory")
    forwards = {}
    for name, kw in cases.items():
        free()
        net = SFNO(dataclasses.replace(base, **kw)).to(dev)
        net.init_weights(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            net(x, time=t, static_condition=forcing)  # warm-up: K1's image, cuBLAS
            sync()
            zero_counts()
            t0 = time.perf_counter()
            y = net(x, time=t, static_condition=forcing)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        k1 = wrappers["K1"].launches
        finite = bool(torch.isfinite(y).all())
        log(f"option forward {name}: {ms:.2f} ms at batch 1, float32, output "
            f"{tuple(y.shape)} finite {finite}, K1 launches {k1} on {smi_line}")
        check(finite and tuple(y.shape) == (1, H, W, base.out_chans),
              f"option forward {name}: non-finite or misshapen output")
        check(k1 == (L if kw.get("use_pallas") else 0),
              f"option forward {name}: K1 launched {k1} times")
        forwards[name] = dict(ms=ms, k1_launches=k1)
        del net, y
    opts["forwards"] = forwards
    free()

    # a forecaster training step with data+noise-v2, the extra condition
    # channels built in; the noise is drawn on the card
    trs = main_path.build_training(forward_conditioning="data+noise-v2", n_samples=1, **size)
    tr = trs["forecaster"]
    state = tr.init_state()
    dyn, cond, rt = tr.upload(next(iter(tr.dm.train_batches(seed=0))))
    gen = torch.Generator().manual_seed(3)
    tr.train_step(state, dyn, cond, gen, rt)  # warm-up: K1's images, cuBLAS
    sync()
    act_bytes = H * W * OPT_EMBED * 4
    control = torch.ones(1 << 18)
    nbytes = control.numel() * 4
    # every aten op of the step passes through the dispatch mode (the
    # backward's too), so no host-to-device copy goes unseen, as a profiler
    # trace's could; the 1 MiB control copy before the step shows it counting
    with host_to_device() as seen:
        control.to(dev)
        t0 = time.perf_counter()
        loss = float(tr.train_step(state, dyn, cond, gen, rt)["loss"])
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
    h2d = seen.copies
    n_control = sum(b == nbytes for _, b in h2d)
    h2d_bytes = sum(b for _, b in h2d) - n_control * nbytes
    log(f"data+noise-v2 forecaster step (in_chans {tr.exp.model.cfg.in_chans}): loss {loss:.5f}, "
        f"{step_ms:.2f} ms under the dispatch mode; host-to-device {len(h2d)} copies, "
        f"{sorted({(op, b) for op, b in h2d})}, {h2d_bytes} bytes besides the 1 MiB control "
        f"(seen {n_control} time(s), expected 1; one activation is {act_bytes} bytes)")
    check(np.isfinite(loss), "data+noise-v2 forecaster step: a non-finite loss")
    check(not cuda or n_control == 1, f"the dispatch mode saw the control copy {n_control} times")
    check(h2d_bytes < act_bytes // 100,
          f"data+noise-v2: {h2d_bytes} bytes copied from the host in one training step")
    opts["data_noise"] = dict(loss=loss, step_ms=step_ms, h2d_bytes=h2d_bytes,
                              h2d_copies=len(h2d) - n_control,
                              in_chans=tr.exp.model.cfg.in_chans)
    del trs, tr, state, dyn, cond
    free()
    report["options"] = opts


def phase14(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 14: training's other modes at MODES_EMBED x MODES_LAYERS on
    MODES_SHAPE, batch 1, K1 on: (c) bf16-compute steps, (d) bf16 Adam
    moments, (a) the fused epoch, (b) streaming, (e) the rollout validation
    inside ``fit``, (f) gradient histograms, (g) the code snapshot (run in
    this order: (c) and (d) measure peak memory from a card that holds only
    their freshly built trainers, as phase 11 does)."""
    import contextlib
    import gc
    import io
    import tarfile
    import tempfile

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.training import trainer as trainer_mod
    from spherical_dyffusion_tpu_torch.training.optim import AdamWLowMu
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = MODES_LAYERS
    size = dict(embed=MODES_EMBED, layers=L, img_shape=MODES_SHAPE, device=device)
    modes = {}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        dhconv.dx_launches = 0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def no_sync(what):
        """Fail on any synchronizing CUDA call inside (the sync debug mode
        "error"), but for the epochs' ends: ``Trainer._read_epoch`` reads the
        losses with an ordinary copy, outside the check, and is counted in
        the list yielded (the caller holds it to the epochs run)."""
        reads = [0]
        real_read = Trainer._read_epoch

        def read_outside(*a):
            reads[0] += 1
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            try:
                return real_read(*a)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("error")

        Trainer._read_epoch = staticmethod(read_outside)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield reads
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: FAILED: {what} made a synchronizing CUDA call: {e}")
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            Trainer._read_epoch = staticmethod(real_read)

    def reinit(trainers):
        """The weights ``build_training`` draws (seed 0, interpolator first)."""
        gen = torch.Generator(device=dev).manual_seed(0)
        trainers["interpolator"].exp.model.init_weights(gen)
        trainers["forecaster"].exp.model.init_weights(gen)

    def rel(a, b):
        return abs(a - b) / abs(b)

    free()
    live_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    if live_gb > REMAT_LIVE_GB:
        _, largest = live_cuda_tensors()
        log(f"training modes: the largest CUDA tensors still live: {largest}")
    log(f"training modes: {live_gb:.3f} GB allocated on the card before phase 14")
    check(live_gb <= REMAT_LIVE_GB,
          f"training modes: {live_gb:.3f} GB left live by the earlier phases, more than "
          f"{REMAT_LIVE_GB} GB")
    ref11 = report["training"]

    # (c) bf16-compute training: 3 steps of each experiment, K1 float32
    zero_counts()
    bf = main_path.train_steps(n_steps=MODES_STEPS, trainers=main_path.build_training(
        dtype="bfloat16", n_samples=FUSED_STEPS, **size))
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"bf16 training launched kernels without a backward: {off}")
    k1_bf16 = sum(sum(r["k1_launches"]) for r in bf.values())
    bf_rows = {name: dict(losses=r["losses"], grad_norms=r["grad_norms"],
                          step_ms=float(np.median(r["step_ms"][1:])),
                          step_ms_all=r["step_ms"],
                          peak_gb=(r["peak_bytes"] or 0) / 1e9, k1=r["k1_launches"],
                          dx=r["k1_dx"], dtype=r["trainer"].exp.model.cfg.compute_dtype)
               for name, r in bf.items()}
    del bf
    free()
    f32 = main_path.build_training(n_samples=FUSED_STEPS, **size)
    # (d), timed: bf16 Adam moments on the fresh networks, whose peak counts
    # what phase 11's does (no K1 image is made before the first step)
    itr = f32["interpolator"]
    mu_cfg = TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS, scheduler="constant",
                           adam_mu_dtype="bfloat16")
    mu_live = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    timed_mu = main_path.train_steps(n_steps=MODES_STEPS, trainers={
        "interpolator": Trainer(itr.exp, itr.dm, mu_cfg)})["interpolator"]
    mu_ms = float(np.median(timed_mu["step_ms"][1:]))
    mu_opt_ms = float(np.median([s["optimizer"] for s in timed_mu["split_ms"][1:]]))
    mu_ms_all = timed_mu["step_ms"]
    mu_peak = timed_mu["peak_bytes"] / 1e9 if timed_mu["peak_bytes"] else float("nan")
    del timed_mu
    free()
    reinit(f32)
    ref = main_path.train_steps(n_steps=MODES_STEPS, trainers=f32)
    per_step = {"interpolator": (2 * L, L), "forecaster": (3 * L, L)}
    for name, r in bf_rows.items():
        gaps = [rel(a, b) for a, b in zip(r["losses"], ref[name]["losses"])]
        gn_gap = max(rel(a, b) for a, b in zip(r["grad_norms"], ref[name]["grad_norms"]))
        log(f"bf16 training {name}: losses {[round(v, 5) for v in r['losses']]} against float32 "
            f"{[round(v, 5) for v in ref[name]['losses']]} (max rel gap {max(gaps):.3e}, "
            f"tolerance {BF16_VS_F32_LOSS}); gradient norms max rel gap {gn_gap:.3e} (floor "
            f"{BF16_GRAD_NORM_FLOOR}); median step after the first {r['step_ms']:.2f} ms "
            f"(steps {[round(v, 2) for v in r['step_ms_all']]} ms; phase 11 float32 {ref11[name]['step_ms']:.2f} ms); peak {r['peak_gb']:.3f} GB "
            f"(phase 11 {ref11[name]['peak_gb']:.3f} GB); K1 launches per step {r['k1']} "
            f"(dx {r['dx']}) on {smi_line}")
        check(r["dtype"] == "bfloat16" and all(np.isfinite(r["losses"])),
              f"bf16 training {name}: not bf16, or a non-finite loss")
        check(max(gaps) <= BF16_VS_F32_LOSS,
              f"bf16 training {name}: loss {max(gaps):.3e} from the float32 run's")
        check(gn_gap > BF16_GRAD_NORM_FLOOR,
              f"bf16 training {name}: gradient norms {gn_gap:.3e} from the float32 run's, "
              f"not above {BF16_GRAD_NORM_FLOOR}: the step did not compute in bf16")
        want = per_step[name]
        check(list(zip(r["k1"], r["dx"])) == [want] * MODES_STEPS,
              f"bf16 training {name}: K1 (launches, dx) per step {list(zip(r['k1'], r['dx']))}, "
              f"expected {want}")
        r.update(f32_losses=ref[name]["losses"], loss_rel=max(gaps), grad_norm_rel=gn_gap,
                 phase11_step_ms=ref11[name]["step_ms"], phase11_peak_gb=ref11[name]["peak_gb"])
    modes["bf16_compute"] = bf_rows
    runs["bf16"] = dict(launches={"K1": k1_bf16, "K2": 0, "K3": 0, "K4": 0})
    del ref, r
    free()  # the float32 run's states (moments, EMA) sit in reference cycles

    # (d) bf16 Adam moments: the same 3 steps again with the gradients and
    # weight decays the optimizer saw kept on the host, against float64 optax
    reinit(f32)
    mu_tr = Trainer(itr.exp, itr.dm, mu_cfg)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in itr.exp.model.named_parameters()}
    seen = []
    real_step = AdamWLowMu.step

    def record_step(self, closure=None):
        seen.append([(p.grad.to("cpu"), g["weight_decay"], g["lr"])
                     for g in self.param_groups for p in g["params"]])
        return real_step(self, closure)

    AdamWLowMu.step = record_step
    try:
        mu = main_path.train_steps(n_steps=MODES_STEPS, trainers={"interpolator": mu_tr})
    finally:
        AdamWLowMu.step = real_step
    st = mu["interpolator"]["state"]
    order = [p for g in st.optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in itr.exp.model.named_parameters()}
    all_bf16 = all(st.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16 for p in order)
    b1, b2, eps = 0.9, 0.999, 1e-8
    b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16))
    worst = 0.0
    for i, p in enumerate(order):
        # optax's rule in float64: mu = (1 - b1) g + bf16(bf16(b1) mu_stored),
        # the update from that mu, then mu rounded to bf16 for storage
        x = p0[names[id(p)]].to(dev, torch.float64)
        m_st = torch.zeros_like(x)
        v = torch.zeros_like(x)
        for k, rec in enumerate(seen, start=1):
            g, wd, lr = rec[i]
            g = g.to(dev, torch.float64)
            m = (1 - b1) * g + (b1_mu * m_st.to(torch.bfloat16).float()).to(
                torch.bfloat16).double()
            v = (1 - b2) * g * g + b2 * v
            upd = (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + eps) + wd * x
            x = x - lr * upd
            m_st = m.to(torch.bfloat16).double()
        # 1e-6 of the tensor plus AdamW's response to one bf16 step of mu at
        # each update (|mu_hat / sqrt(nu_hat)| is at most about 1)
        tol = 1e-6 * float(x.abs().max()) + len(seen) * seen[0][i][2] * 2.0 ** -7
        err = float((p.detach().double() - x).abs().max())
        worst = max(worst, err / tol)
    r = mu["interpolator"]
    mu_row = dict(losses=r["losses"], step_ms=mu_ms, step_ms_all=mu_ms_all, peak_gb=mu_peak,
                  phase11_peak_gb=ref11["interpolator"]["peak_gb"],
                  phase11_step_ms=ref11["interpolator"]["step_ms"], live_gb_before=mu_live,
                  optimizer_ms=mu_opt_ms,
                  phase11_optimizer_ms=ref11["interpolator"]["split_ms"]["optimizer"],
                  all_exp_avg_bf16=all_bf16,
                  param_err_over_tol=worst, updates=len(seen))
    log(f"bf16 Adam moments: {len(seen)} updates at lr 4e-4, every exp_avg bf16: {all_bf16}; the "
        f"parameters against float64 optax with mu rounded to bf16: max error {worst:.3f} of "
        f"its tolerance (1e-6 of the tensor plus one bf16 step of mu per update); peak "
        f"{mu_row['peak_gb']:.3f} GB ({mu_live:.3f} GB live before it: both networks, as in "
        f"phase 11) against "
        f"phase 11's {mu_row['phase11_peak_gb']:.3f} GB "
        f"({mu_row['peak_gb'] - mu_row['phase11_peak_gb']:+.3f} GB); median step after the "
        f"first {mu_row['step_ms']:.2f} ms (steps {[round(v, 2) for v in mu_ms_all]} ms; phase "
        f"11 {mu_row['phase11_step_ms']:.2f} ms; both "
        f"from the run without the gradients kept), its optimizer and EMA "
        f"{mu_opt_ms:.2f} ms (phase 11 {mu_row['phase11_optimizer_ms']:.2f} ms) on {smi_line}")
    check(all_bf16 and len(seen) == MODES_STEPS, "bf16 Adam moments: an exp_avg is not bf16")
    check(worst <= 1.0, f"bf16 Adam moments: parameters {worst:.3f} x their tolerance from optax")
    modes["bf16_mu"] = mu_row
    del mu, mu_tr, st, order, seen, p0, r
    free()

    # (a) the fused epoch: FUSED_STEPS interpolator steps over a dataset
    # uploaded once; timed, then again under the dispatch mode, then fit
    # over the same rows with the epoch's generator
    reinit(f32)
    zero_counts()
    fused = main_path.fused_epoch(n_steps=FUSED_STEPS, trainer=itr)
    k1_fused, dx_fused = wrappers["K1"].launches, dhconv.dx_launches
    steps = fused["steps"]
    med = float(np.median(fused["step_ms"][1:]))
    log(f"fused epoch: {steps} steps in {fused['wall_s']:.3f} s (the call, dataset read and "
        f"upload included), median step after the first {med:.2f} ms (phase 11's "
        f"interpolator step {ref11['interpolator']['step_ms']:.2f} ms); the dataset "
        f"{fused['upload_bytes'] / 1e9:.3f} GB read, stacked and pinned in "
        f"{fused['upload_host_s']:.3f} s, copied in {fused['upload_copy_s']:.4f} s "
        f"({fused['upload_bytes'] / 1e9 / fused['upload_copy_s']:.1f} GB/s); K1 launches "
        f"{k1_fused} (dx {dx_fused}) on {smi_line}")
    check(steps == FUSED_STEPS and all(np.isfinite(fused["losses"])),
          f"fused epoch: {steps} steps or a non-finite loss")
    check(k1_fused == 2 * L * steps and dx_fused == L * steps,
          f"fused epoch: K1 {k1_fused} launches ({dx_fused} dx), expected {2 * L} ({L}) a step")
    reinit(f32)
    control = torch.ones(1 << 18)
    with host_to_device() as seen_h2d:
        control.to(dev)
        counted = main_path.fused_epoch(n_steps=FUSED_STEPS, trainer=itr)
    h2d = seen_h2d.copies
    nbytes = control.numel() * 4
    n_control = sum(b == nbytes for _, b in h2d)
    total = sum(b for _, b in h2d) - n_control * nbytes
    idx_bytes = FUSED_STEPS * 8
    per_step_bytes = total - counted["upload_bytes"] - idx_bytes
    log(f"fused epoch under the dispatch mode: {len(h2d) - n_control} host-to-device copies, "
        f"{total} bytes: the dataset {counted['upload_bytes']}, the permutation index "
        f"{idx_bytes}, the steps {per_step_bytes} (the 1 MiB control seen {n_control} time(s)); "
        f"copies (op, bytes): {sorted({(op, b) for op, b in h2d if b != nbytes})}; "
        f"losses {'equal' if counted['losses'] == fused['losses'] else 'DIFFERENT'} bit for bit "
        f"to the timed epoch's")
    check(not cuda or n_control == 1, f"the dispatch mode saw the control copy {n_control} times")
    check(per_step_bytes == 0, f"fused epoch: the steps copied {per_step_bytes} bytes from "
                               f"the host")
    check(counted["losses"] == fused["losses"], "fused epoch: a rerun from the same weights "
                                                "gave other losses")
    del counted
    reinit(f32)
    fit_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    fit_tr.generator = fit_tr.epoch_generator(0)
    by_fit = fit_tr.fit(val_every=2, verbose=False)["step_losses"]
    fit_gap = max(rel(a, b) for a, b in zip(fused["losses"], by_fit))
    log(f"fused epoch against fit over the same rows and generator: losses max rel gap "
        f"{fit_gap:.3e} (tolerance 1e-5)")
    check(len(by_fit) == steps and fit_gap <= 1e-5, "fused epoch: losses differ from fit's")
    modes["fused_epoch"] = dict(steps=steps, wall_s=fused["wall_s"], step_ms=med,
                                step_ms_all=fused["step_ms"], losses=fused["losses"],
                                upload_bytes=fused["upload_bytes"],
                                upload_host_s=fused["upload_host_s"],
                                upload_copy_s=fused["upload_copy_s"],
                                h2d_step_bytes=per_step_bytes, h2d_index_bytes=idx_bytes,
                                fit_loss_rel=fit_gap, k1_launches=k1_fused, k1_dx=dx_fused,
                                phase11_step_ms=ref11["interpolator"]["step_ms"])
    runs["fused_epoch"] = dict(launches={"K1": k1_fused, "K2": 0, "K3": 0, "K4": 0})
    del fused, fit_tr
    free()

    # (b) streaming: FUSED_STEPS samples in segments of SEGMENT_SAMPLES, no
    # synchronizing call; against the same rows run by hand with each
    # segment's generator
    reinit(f32)
    zero_counts()
    st_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    t0 = time.perf_counter()
    with no_sync("streaming") as reads:
        hist = st_tr.fit_in_memory(epochs=1, val_every=2, verbose=False,
                                   segment_samples=SEGMENT_SAMPLES)
    check(reads == [1], f"streaming: {reads[0]} epoch-end reads in one epoch")
    stream_s = time.perf_counter() - t0
    k1_stream = wrappers["K1"].launches
    streamed = hist["step_losses"]
    waits = hist["segment_wait_s"][0]
    reinit(f32)
    ref_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    state = ref_tr.init_state()
    ds = itr.dm.dataset("train")
    perm = np.random.default_rng(0).permutation(len(ds))[:FUSED_STEPS]
    keyed = []
    for si in range(FUSED_STEPS // SEGMENT_SAMPLES):
        gen = ref_tr.epoch_generator(0, si)
        for row in perm[si * SEGMENT_SAMPLES:(si + 1) * SEGMENT_SAMPLES]:
            b = ref_tr._read_rows(ds, [row], ["dynamics", "dynamical_condition"])
            keyed.append(ref_tr.train_step(state, b["dynamics"].to(dev),
                                           b["dynamical_condition"].to(dev), gen)["loss"])
    keyed = [float(v) for v in keyed]
    stream_gap = max(rel(a, b) for a, b in zip(streamed, keyed))
    log(f"streaming: {len(streamed)} steps in {len(waits)} segments of {SEGMENT_SAMPLES} in "
        f"{stream_s:.3f} s, no synchronizing CUDA call (sync debug mode 'error'); the host's "
        f"wait for each segment {[round(w, 4) for w in waits]} s; losses against the same rows "
        f"keyed the same way max rel gap {stream_gap:.3e} (tolerance 1e-5); K1 launches "
        f"{k1_stream} on {smi_line}")
    check(len(streamed) == FUSED_STEPS and len(waits) == FUSED_STEPS // SEGMENT_SAMPLES,
          f"streaming: {len(streamed)} steps in {len(waits)} segments")
    check(stream_gap <= 1e-5, "streaming: losses differ from the same rows keyed the same way")
    check(k1_stream == 2 * L * FUSED_STEPS, f"streaming: K1 launched {k1_stream} times")
    modes["streaming"] = dict(steps=len(streamed), seconds=stream_s, segment_wait_s=waits,
                              loss_rel=stream_gap, k1_launches=k1_stream)
    runs["streaming"] = dict(launches={"K1": k1_stream, "K2": 0, "K3": 0, "K4": 0})
    del st_tr, ref_tr, state, hist
    free()

    # (e) the rollout validation of the forecaster inside fit, on its EMA
    # weights: ROLLOUT_VAL_STEPS steps, no synchronizing call in the rollout
    reinit(f32)
    ftr = f32["forecaster"]
    rv_tr = Trainer(ftr.exp, ftr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS,
                                                   rollout_val_every=1,
                                                   rollout_val_steps=ROLLOUT_VAL_STEPS))
    nets = (ftr.exp.model, ftr.exp.interpolator.model)
    rollout = {}
    real_run = trainer_mod.run_inference

    def counted_run(*a, **k):
        forwards = [0]
        hooks = [n.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
                 for n in nets]
        zero_counts()
        t0 = time.perf_counter()
        try:
            with no_sync("the rollout validation"):
                out = real_run(*a, **k)
        finally:
            for h in hooks:
                h.remove()
        rollout.update(seconds=time.perf_counter() - t0, forwards=forwards[0],
                       k1=wrappers["K1"].launches)
        return out

    trainer_mod.run_inference = counted_run
    try:
        hist = rv_tr.fit(val_every=2, verbose=False)
    finally:
        trainer_mod.run_inference = real_run
    rv = hist["rollout_val"][0]
    # the key set: the port's at debug size on the CPU (held to the JAX
    # package's there by tests/test_torch_port_train_modes.py), its names
    # those of this run
    debug = main_path.build_training(embed=16, layers=2, img_shape=(16, 32), horizon=3,
                                     n_state=5, n_samples=12, device="cpu")["forecaster"]
    debug = Trainer(debug.exp, debug.dm, TrainerConfig(rollout_val_steps=6))
    debug_names = list(debug.exp.out_packer.names)
    debug_keys = debug.rollout_validate(debug.init_state())
    groups = {k.rsplit("/", 1)[0] for k in debug_keys if k.rsplit("/", 1)[1] in debug_names}
    want = ({k for k in debug_keys if k.rsplit("/", 1)[1] not in debug_names}
            | {f"{g}/{n}" for g in groups for n in ftr.exp.out_packer.names})
    finite = all(np.isfinite(v) for v in rv.values())
    rate = ROLLOUT_VAL_STEPS / rollout["seconds"]
    log(f"rollout validation (EMA weights, {ROLLOUT_VAL_STEPS} steps): {len(rv)} keys, equal to "
        f"the expected set: {set(rv) == want}; finite {finite}; val/avg/rmse "
        f"{rv.get('val/avg/rmse', float('nan')):.5f}; {rollout['seconds']:.3f} s = {rate:.3f} "
        f"steps/s with no synchronizing CUDA call; {rollout['forwards']} SFNO forwards, K1 "
        f"launches {rollout['k1']} on {smi_line}")
    check(set(rv) == want and finite, f"rollout validation: keys {sorted(set(rv) ^ want)[:6]} "
                                      f"differ, or a value is not finite")
    check(rollout["k1"] == L * rollout["forwards"] and rollout["forwards"] > 0,
          f"rollout validation: K1 launched {rollout['k1']} times in {rollout['forwards']} "
          f"forwards")
    modes["rollout_val"] = dict(steps=ROLLOUT_VAL_STEPS, seconds=rollout["seconds"],
                                steps_per_s=rate, keys=len(rv), forwards=rollout["forwards"],
                                k1_launches=rollout["k1"], rmse=rv.get("val/avg/rmse"))
    runs["rollout_val"] = dict(launches={"K1": rollout["k1"], "K2": 0, "K3": 0, "K4": 0})
    del rv_tr, hist, debug
    free()

    # (f) gradient histograms: fit, log_every 2, HIST_STEPS steps, against
    # the same steps without them; no synchronizing call in the fit
    class Rows:
        def __init__(self):
            self.rows = []

        def log(self, row, step=None):
            self.rows.append((step, row))

    hist_dm = DebugDataModule(channels=35, height=MODES_SHAPE[0], width=MODES_SHAPE[1],
                              horizon=6, n_forcing=2, batch_size=1, n_timesteps=6 + HIST_STEPS,
                              seed=0)
    step_ms, logs = {}, {}
    for watch in (False, True):
        reinit(f32)
        tr = Trainer(itr.exp, hist_dm, TrainerConfig(epochs=1, log_every=2, warmup_steps=1,
                                                     watch_histograms=watch))
        marks = []
        step = tr.train_step

        def timed_step(*a, step=step, marks=marks, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
            for e in ev[:1]:
                e.record()
            t = time.perf_counter()
            out = step(*a, **k)
            for e in ev[1:]:
                e.record()
            marks.append((ev, time.perf_counter() - t))
            return out

        tr.train_step = timed_step
        rows = Rows()
        with no_sync("a fit with gradient histograms" if watch else "a fit") as reads:
            tr.fit(val_every=2, verbose=False, logger=rows)
        check(reads == [1], f"histograms: {reads[0]} epoch-end reads in one epoch")
        step_ms[watch] = [ev[0].elapsed_time(ev[1]) if ev else host * 1e3 for ev, host in marks]
        logs[watch] = rows.rows
        del tr, step, timed_step
    logged = [s for s, r in logs[True] if any(k.startswith("train/grad_hist/") for k in r)]
    groups = {}
    for n, p in itr.exp.model.named_parameters():
        groups.setdefault(trainer_mod.subtree(itr.exp.model, n), 0)
        groups[trainer_mod.subtree(itr.exp.model, n)] += p.numel()
    sums_ok = True
    for s, r in logs[True]:
        for k, v in r.items():
            if k.startswith("train/grad_hist/"):
                sums_ok &= sum(v["values"]) == groups[k.split("/", 2)[2]] and len(v["bins"]) == 65
    with_h = [step_ms[True][i] for i in range(0, HIST_STEPS, 2)]
    without_h = [step_ms[False][i] for i in range(0, HIST_STEPS, 2)]
    # the logged steps after the first (the first also makes the K1 images)
    over = float(np.mean(np.subtract(with_h[1:], without_h[1:])))
    max_bin = max(max(v["values"]) for _, r in logs[True] for k, v in r.items()
                  if k.startswith("train/grad_hist/"))
    log(f"gradient histograms: logged at steps {logged}, {len(groups)} subtrees, counts summing "
        f"to each subtree's parameter count: {sums_ok}; the logged steps took "
        f"{[round(v, 2) for v in with_h]} ms with histograms and {[round(v, 2) for v in without_h]} "
        f"ms without (the first of each with the epoch's first K1 images): overhead "
        f"{over:.2f} ms a logged step after the first, by CUDA events; no synchronizing CUDA "
        f"call in either fit; the largest bin holds {max_bin} values (2^24 = {2 ** 24}) on "
        f"{smi_line}")
    check(logged == list(range(0, HIST_STEPS, 2)) and sums_ok,
          f"gradient histograms: logged at {logged}, or counts not summing to the parameters")
    modes["histograms"] = dict(logged_steps=logged, subtrees=len(groups), step_ms=step_ms[True],
                               step_ms_without=step_ms[False], overhead_ms=over,
                               max_bin=max_bin)

    # (g) the code snapshot: two fits into one checkpoint directory
    one = DebugDataModule(channels=35, height=MODES_SHAPE[0], width=MODES_SHAPE[1], horizon=6,
                          n_forcing=2, batch_size=1, n_timesteps=7, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tars = []
        for _ in range(2):
            Trainer(itr.exp, one, TrainerConfig(epochs=1, warmup_steps=1, ckpt_dir=tmp)).fit(
                val_every=2, verbose=False)
            with open(os.path.join(tmp, "code.tar.gz"), "rb") as f:
                tars.append(f.read())
        with tarfile.open(fileobj=io.BytesIO(tars[0])) as tar:
            members = set(tar.getnames())
    csrc = os.path.join(os.path.dirname(os.path.abspath(main_path.__file__)), "csrc")
    kernels = sorted(f"spherical_dyffusion_tpu_torch/csrc/{fn}" for fn in os.listdir(csrc)
                     if fn.endswith(".cu"))
    log(f"code snapshot: two fits into one directory left {len(tars[0])} and {len(tars[1])} "
        f"bytes, identical: {tars[0] == tars[1]}; {len(members)} files, holding "
        f"{[k for k in kernels if k in members]}")
    check(tars[0] == tars[1] and all(k in members for k in kernels),
          "code snapshot: not byte-stable, or a kernel source is missing")
    modes["code_snapshot"] = dict(bytes=len(tars[0]), files=len(members), kernels=kernels)
    del f32, itr, ftr, nets
    free()
    report["modes"] = modes


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from spherical_dyffusion_tpu_torch import main_path
        from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
        from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
        from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
        from spherical_dyffusion_tpu_torch.models.sfno import SFNO
        from spherical_dyffusion_tpu_torch.ops import _cuda
        from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
            fused_block_tail,
            fused_block_tail_plain,
            fused_mlp,
            fused_mlp_plain,
            weight_image,
            weight_image_plain,
        )
        from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
        from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
            conj_transpose,
            dhconv,
            dhconv_plain,
            dhconv_weight_grad,
            dhconv_weight_image,
            dhconv_weight_image_plain,
        )
        from spherical_dyffusion_tpu_torch.ops.sht import (
            InverseRealSHT,
            RealSHT,
            legendre_l_first,
        )
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    wrappers = {"K1": dhconv, "K2": fused_mlp, "K3": fused_block_tail, "K4": fused_rank}

    def timed(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps: int) -> float:
        """Device time per call of ``fn`` (a wrapper that launches one
        kernel): CUDA events around ``reps`` calls queued behind a spin
        kernel of about 0.1 s, so that the host has queued every launch
        before the device reaches the first and the wrapper's host work
        between launches, which a fast kernel may wait on in a plain loop of
        events, does not count; checked by the start event not yet reached
        when the last call returns. (Counting the profiler's records instead
        lost some of a profiling pass's launches in three of four runs.)"""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        check(not start.query(), "the device reached the timed launches before the host had "
                                 "queued them all; lengthen the spin")
        end.synchronize()
        return start.elapsed_time(end) / reps

    def errs(got, want):
        d = (got.float() - want.float()).abs().max().item()
        return d, d / want.float().abs().max().item()

    with Phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
        smi_line = smi.stdout.strip().splitlines()[0]
        log(f"device: {kind} (count {count}); nvidia-smi: {smi_line}")
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}")

    with Phase("1 build"):
        info = _cuda.build_info()
        log(f"build: {info['seconds']:.2f} s (cached: {info['cached']}) -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "C7512",
                                       "setmaxnreg")):
                log("  ptxas " + line.strip())
        check("C7512" not in info["ptxas"], "ptxas serialized the wgmma of a bf16 kernel")
        cuobjdump = os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True,
                              text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()[:200]}")
        hgmma, fn = {}, None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                hgmma[fn] = 0
            elif fn is not None and "HGMMA" in line:
                hgmma[fn] += 1
        for kernel, n in (("dhconv_tc_kernel", 1), ("fused_mlp_tc_kernel", 4),
                          ("fused_rank_tc_kernel", 2)):
            tc = {k: v for k, v in hgmma.items() if kernel in k}
            for k, v in tc.items():
                log(f"  sass: {v} HGMMA (wgmma) instructions in {k}")
            check(len(tc) == n and all(v > 0 for v in tc.values()),
                  f"the {n} instance(s) of {kernel} should run their products as HGMMA")

    report = {}

    with Phase("11 training (K1 forward and backward, the trainer at 256 x 8)"):
        # (a) K1's backward at the main path's shapes: dx is K1 over the
        # conjugate-transposed image, dW a float32 torch.bmm
        g = torch.Generator(device=dev).manual_seed(11)
        L, M, CI, CO = 180, 181, 256, 256
        w = torch.randn((CI, CO, L, 2), device=dev, generator=g) / (CI * CO)
        img_t = dhconv_weight_image(w, conj_t=True)
        torch.cuda.synchronize()
        check(torch.equal(img_t, dhconv_weight_image_plain(w, conj_t=True)),
              "the conjugate-transposed K1 image differs from its plain version")
        image_t_ms = timed(lambda: dhconv_weight_image(w, conj_t=True), 5)
        wct = conj_transpose(w).contiguous()  # its forward image is img_t
        bwd = {}
        for B in (1, 2):
            x = torch.randn((B, L, M, CI, 2), device=dev, generator=g)
            gy = torch.randn((B, L, M, CO, 2), device=dev, generator=g)
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(dhconv(xl, wl), (xl, wl), gy)
            want_dx, want_dw = torch.autograd.grad(dhconv_plain(xl, wl), (xl, wl), gy)
            torch.cuda.synchronize()
            dx_err, dx_rel = errs(dx, want_dx)
            dw_err, dw_rel = errs(dw, want_dw)
            log(f"K1 backward B={B}: dx max abs err {dx_err:.3e} (rel {dx_rel:.3e}), dW max abs "
                f"err {dw_err:.3e} (rel {dw_rel:.3e}) against autograd of the plain version "
                f"(tolerance 1e-5 of the largest entry)")
            check(dx_rel <= 1e-5 and dw_rel <= 1e-5,
                  f"K1's backward disagrees with autograd of its plain version (B={B})")
            ms = timed(lambda: dhconv(gy, wct, img_t), 20)
            dev_ms = device_ms(lambda: dhconv(gy, wct, img_t), 20)
            plain_ms = timed(lambda: dhconv_plain(gy, conj_transpose(w)), 5)
            dw_ms = timed(lambda: dhconv_weight_grad(x, gy), 10)
            gc = torch.view_as_complex(gy)
            wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())
            library_ms = timed(lambda: torch.matmul(gc, wc.conj().transpose(-1, -2)), 20)
            xc = torch.view_as_complex(x).detach().requires_grad_()
            wcl = wc.detach().requires_grad_()
            yc = torch.matmul(xc, wcl)
            autograd_ms = timed(lambda: torch.autograd.grad(yc, (xc, wcl), gc,
                                                            retain_graph=True), 10)
            flops = 8.0 * B * L * M * CI * CO
            bound_ms, bound_by = bound(flops, 4.0 * (2 * gy.numel() + w.numel()), TF32_PEAK)
            # dW's bound on the yardstick of K1's: the TF32 tensor cores, one
            # pass (three for float32 accuracy as 3xTF32 beside it)
            dw_bytes = 4.0 * (x.numel() + gy.numel() + w.numel())
            dw_bound, dw_by = bound(flops, dw_bytes, TF32_PEAK)
            dw_bound3, dw_by3 = bound(3 * flops, dw_bytes, TF32_PEAK)
            log(f"K1 backward B={B}: dx kernel {ms:.4f} ms a call in a loop through the "
                f"wrapper ({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, "
                f"complex torch.matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); the backward image {image_t_ms:.4f} ms (once per step per "
                f"filter); dW torch.bmm {dw_ms:.4f} ms, its bound {dw_bound:.4f} ms "
                f"({dw_by}; {dw_bound3:.4f} ms as 3xTF32, {dw_by3}); autograd of complex "
                f"torch.matmul (dx and dW) {autograd_ms:.4f} ms "
                f"against dx + dW here {ms + dw_ms:.4f} ms, on {smi_line}")
            bwd[B] = dict(max_abs_err=dx_err, max_rel_err=dx_rel, dw_max_rel_err=dw_rel, ms=ms,
                          device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, dw_ms=dw_ms,
                          dw_bound_ms=dw_bound, dw_bound_ms_3xtf32=dw_bound3,
                          autograd_complex_matmul_ms=autograd_ms)
            del x, gy, xl, wl, dx, dw, want_dx, want_dw, gc, wc, xc, wcl, yc
        report["K1_bwd"] = dict(bwd[1], image_t_ms=image_t_ms,
                                **{f"{k}_b2": v for k, v in bwd[2].items()})
        del w, wct, img_t
        torch.cuda.empty_cache()

        # (b) the trainer at 256 x 8 on 180 x 360, float32, K1 on: the
        # interpolator, then the forecaster with it frozen in p_losses
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        train = main_path.train_steps(n_steps=TRAIN_STEPS, device="cuda")
        off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
        check(not any(off.values()), f"training launched kernels without a backward: {off}")
        log(f"training: {TRAIN_STEPS} steps of each experiment, built and run in "
            f"{time.perf_counter() - t0:.2f} s")
        per_step = {"interpolator": (16, 8), "forecaster": (24, 8)}
        train_report = {}
        for name, rec in train.items():
            steady = rec["step_ms"][2:]
            med = float(np.median(steady))
            split = {p: float(np.median([s[p] for s in rec["split_ms"][2:]]))
                     for p in ("forward", "backward", "optimizer")}
            log(f"training {name}: losses {[round(v, 5) for v in rec['losses']]}; step ms "
                f"{[round(v, 1) for v in rec['step_ms']]}, median after 2 warm-up steps "
                f"{med:.2f} ms = {1e3 / med:.3f} steps/s at batch 1; median split forward "
                f"{split['forward']:.2f}, backward {split['backward']:.2f}, optimizer and EMA "
                f"{split['optimizer']:.2f} ms (CUDA events); peak device memory "
                f"{rec['peak_bytes'] / 1e9:.3f} GB; K1 launches per step {rec['k1_launches']} "
                f"(backward {rec['k1_backward']}), K1 images made per step {rec['k1_images']} "
                f"on {smi_line}")
            check(all(np.isfinite(v) for v in rec["losses"]), f"training {name}: a non-finite loss")
            k1, dx = per_step[name]
            check(all(n == k1 for n in rec["k1_launches"]) and
                  all(n == dx for n in rec["k1_backward"]),
                  f"training {name}: K1 launches {rec['k1_launches']} (backward "
                  f"{rec['k1_backward']}), expected {k1} ({dx}) a step")
            # a new forward and backward image per filter after every update;
            # the frozen interpolator's, once, at the forecaster's first step
            images = [16] * TRAIN_STEPS
            if name == "forecaster":
                images[0] += 8
            check(rec["k1_images"] == images,
                  f"training {name}: K1 images per step {rec['k1_images']}, expected {images}")
            train_report[name] = dict(step_ms=med, steps_per_s=1e3 / med, split_ms=split,
                                      peak_gb=rec["peak_bytes"] / 1e9, losses=rec["losses"],
                                      k1_launches=sum(rec["k1_launches"]),
                                      k1_backward=sum(rec["k1_backward"]))
        report["K1_bwd"]["launches"] = sum(r["k1_backward"] for r in train_report.values())
        del train, rec  # rec holds the last trainer and its state
        torch.cuda.empty_cache()

        # the same batch 10 times, dropout off, constant lr: the loss at a
        # fixed timestep draw falls
        tr = main_path.build_training(dropout=False, scheduler="constant", n_samples=1,
                                      device="cuda")["interpolator"]
        dyn, cond, _ = tr.upload(next(iter(tr.dm.train_batches(seed=0))))

        def fixed_loss():
            with torch.no_grad():
                return float(tr.exp.train_loss(tr.normalizer.normalize(dyn),
                                               torch.Generator().manual_seed(123),
                                               dynamical_condition=cond)[0])

        before = fixed_loss()
        rep = main_path.train_steps(n_steps=10, repeat=True, trainers={"interpolator": tr})
        after = fixed_loss()
        log(f"repeated batch, dropout off, constant lr 4e-4: the loss at a fixed timestep "
            f"{before:.5f} before, {after:.5f} after 10 steps; the training losses "
            f"{[round(v, 5) for v in rep['interpolator']['losses']]}")
        check(after < before, "training on a repeated batch did not lower its loss")
        del tr, rep, dyn, cond
        torch.cuda.empty_cache()

        # (c) CMP_STEPS steps at constant lr through the kernels against as
        # many through the plain path (use_pallas=False), from the same
        # weights, on the same batches, dropout off, the same generators (so
        # the same timesteps). By the last step the filter weights have moved
        # far from their small initial values, so its loss and gradients
        # lean on K1's forward and dx over the images made after each update.
        kw = dict(dropout=False, scheduler="constant", n_samples=CMP_STEPS, device="cuda")
        fast = main_path.build_training(**kw)
        plain = main_path.build_training(use_pallas=False, **kw)
        for name in fast:
            plain[name].exp.model.load_state_dict(fast[name].exp.model.state_dict())

        def loss_grads(tr, batch, seed):
            """The loss, its gradients, and the trained network's output with
            that output's cotangent (the graph kept for one more product)."""
            outs, cots = [], []

            def keep(module, args, out):
                outs.append(out)
                out.register_hook(cots.append)

            hook = tr.exp.model.register_forward_hook(keep)
            dyn, cond, _ = tr.upload(batch)
            loss, _ = tr.exp.train_loss(tr.normalizer.normalize(dyn),
                                        torch.Generator().manual_seed(seed),
                                        dynamical_condition=cond)
            hook.remove()
            grads = torch.autograd.grad(loss, tr._params, retain_graph=True)
            check(len(outs) == 1 and len(cots) == 1, "one call of the trained network a loss")
            return float(loss.detach()), grads, outs[0], cots[0]

        for name in ("interpolator", "forecaster"):
            ftr, ptr = fast[name], plain[name]
            p0 = [p.detach().clone() for p in ftr.exp.model.parameters() if p.requires_grad]
            names = [n for n, p in ftr.exp.model.named_parameters() if p.requires_grad]
            states = (ftr.init_state(), ptr.init_state())
            lk, lp, gk, gp, flips = [], [], [], [], []
            g_rel = 0.0
            bad, zero = set(), set()
            for s, batch in zip(range(CMP_STEPS), ptr.dm.train_batches(seed=0)):
                lp_s, gp_s, op, cp = loss_grads(ptr, batch, 7 + s)
                lk_s, gk_s, ok, ck = loss_grads(ftr, batch, 7 + s)
                # the L1 loss's sign differs where a prediction meets its
                # target within rounding: there the two paths' output
                # cotangents differ, and the plain path's gradients are taken
                # at the kernels' cotangent (the same product, J^T c)
                delta = ck - cp
                flips.append(int((delta != 0).sum()))
                check(flips[-1] <= max(1, 1e-5 * delta.numel()),
                      f"training {name}: the loss cotangents differ at {flips[-1]} entries")
                gp_at_k = gp_s
                if flips[-1]:
                    vjp = torch.autograd.grad(op, ptr._params, delta)
                    gp_at_k = [a + b for a, b in zip(gp_s, vjp)]
                    del vjp
                del op, ok, cp, ck, delta
                # F5: every parameter a finite gradient and every filter
                # weight a non-zero one, through the kernels
                bad |= {n for n, a in zip(names, gk_s) if not bool(torch.isfinite(a).all())}
                zero |= {n for n, a in zip(names, gk_s)
                         if n.endswith("filter.weight") and float(a.abs().max()) == 0.0}
                top = max(float(b.abs().max()) for b in gp_at_k)
                g_rel = max(g_rel, max(float((a - b).abs().max()) /
                                       max(float(b.abs().max()), 1e-4 * top)
                                       for a, b in zip(gk_s, gp_at_k)))
                del gp_at_k
                lk.append(lk_s)
                lp.append(lp_s)
                gk.append(gk_s)
                gp.append(gp_s)
                for tr, state in zip((ftr, ptr), states):
                    dyn, cond, _ = tr.upload(batch)
                    tr.train_step(state, dyn, cond, torch.Generator().manual_seed(7 + s))
            check(not bad and not zero and sum(n.endswith("filter.weight") for n in names) == 8,
                  f"training {name}: non-finite gradients {sorted(bad)[:3]}, zero filter "
                  f"gradients {sorted(zero)[:3]}")
            l_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
            # post-step parameters: within 1e-6 plus AdamW's response to the
            # gradient difference measured here (where a gradient entry is
            # rounding, as for a bias that an instance norm removes, the
            # update follows the rounding's sign): per entry lr times the sum
            # over steps of min(2.5, 3 E / (sqrt(v_hat) + eps)), E the largest
            # difference over the steps, v_hat Adam's bias-corrected second
            # moment of the plain gradients (2 E / ... to first order; clipping
            # only raises the effective eps)
            lr = ftr.schedule(0)
            pk = [p.detach() for p in ftr._params]
            pp = [p.detach() for p in ptr._params]
            p_ratio = p_err = moved = 0.0
            n_over = n_all = 0
            for i, (a, b) in enumerate(zip(pk, pp)):
                e = torch.stack([(sk[i] - sp[i]).abs() for sk, sp in zip(gk, gp)]).amax(0)
                v, sens = torch.zeros_like(b), torch.zeros_like(b)
                for t, sp in enumerate(gp, 1):
                    v = 0.999 * v + 0.001 * sp[i] ** 2
                    sens += (3 * e / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)).clamp(max=2.5)
                d = (a - b).abs()
                p_ratio = max(p_ratio, float((d / (1e-6 + lr * sens)).max()))
                p_err = max(p_err, float(d.max()))
                moved = max(moved, float((b - p0[i]).abs().max()))
                n_over += int((d > 1e-6).sum())
                n_all += d.numel()
            fw = [k for k, n in enumerate(names) if n.endswith("filter.weight")]
            rms = [float(torch.cat([q[k].flatten() for k in fw]).square().mean().sqrt())
                   for q in (p0, pp)]
            log(f"training {name}, {CMP_STEPS} steps at constant lr {lr:g} through the kernels "
                f"against the plain path: losses {[round(v, 6) for v in lk]} vs "
                f"{[round(v, 6) for v in lp]} (max rel {l_rel:.3e}, tolerance 1e-5); L1 signs "
                f"flipped at {flips} output entries a step; gradients, the plain path's taken "
                f"at the kernels' output cotangent, max err {g_rel:.3e} of each tensor's "
                f"largest entry, or of 1e-4 of the network's largest where a tensor's "
                f"gradient cancels below that (tolerance 1e-4), at every step; post-step "
                f"parameters max abs diff {p_err:.3e} ({n_over} of {n_all} entries beyond "
                f"1e-6), {p_ratio:.3f} of the tolerance (1e-6 plus AdamW's response to the "
                f"measured gradient difference); the largest move of a parameter {moved:.3e}, "
                f"the filter weights' rms {rms[0]:.3e} -> {rms[1]:.3e}; all {len(names)} "
                f"gradients finite, the 8 filter weights' non-zero")
            check(l_rel <= 1e-5 and g_rel <= 1e-4 and p_ratio <= 1.0,
                  f"training {name}: the kernels disagree with the plain path")
            train_report[name]["kernels_vs_plain"] = dict(
                steps=CMP_STEPS, lr=lr, loss_rel=l_rel, grad_rel=g_rel, l1_flips=flips,
                param_abs=p_err, param_tol_ratio=p_ratio, params_beyond_1e6=n_over,
                params=n_all, moved=moved)
            del gk, gp, gk_s, gp_s, sp, pk, pp, p0, states, a, b, d, e, v, sens
        # the last loop's trainers and batch too: phase 13 (c) measures its
        # peak memory from an empty card
        del fast, plain, ftr, ptr, tr, state, dyn, cond, batch
        torch.cuda.empty_cache()
        report["training"] = train_report

    runs = {}
    with Phase("12 checkpoints and command lines at 256 x 8"):
        phase12(smi_line, wrappers, report, runs)

    with Phase("2 K1 dhconv"):
        g = torch.Generator(device=dev).manual_seed(0)
        L, M, CI, CO = 180, 181, 256, 256
        w = torch.randn((CI, CO, L, 2), device=dev, generator=g) / (CI * CO)
        img = dhconv_weight_image(w)
        torch.cuda.synchronize()
        check(torch.equal(img, dhconv_weight_image_plain(w)),
              "the K1 weight image kernel differs from its plain version")
        image_ms = timed(lambda: dhconv_weight_image(w), 5)
        log(f"K1 weight image {tuple(img.shape)} float32 (hi and lo, "
            f"{img.numel() * 4 / 1e6:.1f} MB): equal to its plain version; made once per "
            f"model in {image_ms:.4f} ms")
        # a 512-term float32 sum per output, in another order than cuBLAS's,
        # and 3xTF32 drops about 2^-22 of each product
        tol = 1e-5
        k1 = {}
        for B in (1, 2):
            x = torch.randn((B, L, M, CI, 2), device=dev, generator=g)
            y = dhconv(x, w, img)
            torch.cuda.synchronize()
            want = dhconv_plain(x, w)
            abs_err, rel_err = errs(y, want)
            log(f"K1 ({B},{L},{M},{CI})->{CO} f32: max abs err {abs_err:.3e}, "
                f"max rel err {rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K1 disagrees with its plain version (B={B})")
            ms = timed(lambda: dhconv(x, w, img), 20)
            dev_ms = device_ms(lambda: dhconv(x, w, img), 20)
            plain_ms = timed(lambda: dhconv_plain(x, w), 5)
            xc = torch.view_as_complex(x)
            wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())
            library_ms = timed(lambda: torch.matmul(xc, wc), 20)
            flops = 8.0 * B * L * M * CI * CO
            xy_bytes = 4.0 * (x.numel() + y.numel())
            # the function's bound (x, w and y once, its products at the TF32
            # peak); the bound of this algorithm (three TF32 passes over the
            # hi/lo image); and that of a float32 CUDA-core kernel
            bound_ms, bound_by = bound(flops, xy_bytes + 4.0 * w.numel(), TF32_PEAK)
            tc3_ms, tc3_by = bound(3 * flops, xy_bytes + 4.0 * img.numel(), TF32_PEAK)
            simt_ms, simt_by = bound(flops, xy_bytes + 4.0 * w.numel(), F32_PEAK)
            log(f"K1 B={B}: kernel {ms:.4f} ms a call in a loop through the wrapper "
                f"({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, complex "
                f"matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.2f} GFLOP at the TF32 peak, "
                f"{(xy_bytes + 4.0 * w.numel()) / 1e6:.1f} MB), 3xTF32 bound {tc3_ms:.4f} ms "
                f"({tc3_by}; 3 x {flops / 1e9:.2f} GFLOP, "
                f"{(xy_bytes + 4.0 * img.numel()) / 1e6:.1f} MB), float32 CUDA-core bound "
                f"{simt_ms:.4f} ms ({simt_by}) on {smi_line}")
            k1[B] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_ms_3xtf32=tc3_ms, bound_ms_simt=simt_ms)
            del x, y, want, xc, wc
        report["K1"] = dict(k1[1], image_ms=image_ms, **{f"{k}_b2": v for k, v in k1[2].items()})
        del w, img

    N, C, Hd = 180 * 360, 256, 512  # 64,800 rows: the last 64-row tile holds 32
    g = torch.Generator(device=dev).manual_seed(1)
    w1 = torch.randn((C, Hd), device=dev, generator=g) / 16
    w2 = torch.randn((Hd, C), device=dev, generator=g) / 22
    b1 = torch.randn(Hd, device=dev, generator=g) * 0.1
    b2 = torch.randn(C, device=dev, generator=g) * 0.1
    w1b, w2b = w1.bfloat16(), w2.bfloat16()
    b1b, b2b = b1.bfloat16(), b2.bfloat16()
    flops1 = 2.0 * N * (C * Hd + Hd * C)  # one sample's two products
    # bf16 rounding of the hidden tensor may fall on the other side of a
    # tie in the two versions; the outputs then move by about one bf16 ulp
    # of a hidden value times a weight. float32: sums in another order.
    tol_bf16, tol_f32 = 1e-2, 1e-5

    with Phase("3 K2 fused MLP"):
        x = torch.randn((N, C), device=dev, generator=g).bfloat16()
        res = torch.randn((N, C), device=dev, generator=g)
        xi = torch.randn((2 * N, C), device=dev, generator=g).bfloat16()  # the double batch
        tol = tol_bf16
        img = weight_image(w1, w2)
        torch.cuda.synchronize()
        check(torch.equal(img, weight_image_plain(w1, w2).to(torch.bfloat16)),
              "the weight repack kernel differs from its plain permutation")
        log(f"K2 weight repack {tuple(img.shape)} bf16: equal to its plain permutation")
        cases = {
            "residual f32 (main path)": dict(residual=res),
            "no residual, bf16 out (main path)": dict(),
            "partial tile, 77 rows": dict(rows=77, residual=res),
            "erf gelu": dict(residual=res, exact_gelu=True),
            "dropout 0.1 on": dict(residual=res, seed=20260101, drop_rate=0.1),
            "interpolator call: 129,600 rows, no residual, dropout 0.1":
                dict(x=xi, seed=20260104, drop_rate=0.1),
        }
        k2_err = None
        for name, kw in cases.items():
            xx = kw.pop("x", x)
            rows = kw.pop("rows", xx.shape[0])
            if "residual" in kw:
                kw["residual"] = kw["residual"][:rows]
            y = fused_mlp(xx[:rows], w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            want = fused_mlp_plain(xx[:rows], w1, b1, w2, b2, **kw)
            check(y.dtype == want.dtype, f"K2 {name}: dtype {y.dtype} vs {want.dtype}")
            abs_err, rel_err = errs(y, want)
            log(f"K2 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
                f"{rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K2 disagrees with its plain version ({name})")
            if "seed" in kw:
                check(torch.equal(y == 0, want == 0), "K2 dropout mask differs from the plain")
            if k2_err is None:
                k2_err = (abs_err, rel_err)

        # dropout statistics: t = round(0.9 * 256) = 230
        t = 230
        p = t / 256
        zero_x = torch.zeros((N, C), device=dev, dtype=torch.bfloat16)
        zres = torch.zeros((N, C), device=dev)
        y = fused_mlp(zero_x, torch.zeros_like(w1), torch.zeros_like(b1), torch.zeros_like(w2),
                      torch.ones_like(b2), residual=zres, seed=7, drop_rate=0.1)
        n = y.numel()
        keep = (y != 0).float().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        log(f"K2 output mask: keep rate {keep:.6f} vs {p:.6f} (4 sigma {4 * sigma:.2e}); "
            f"mean of qdrop(1) {y.mean().item():.6f} vs 1 (4 sigma {4 * sigma / p:.2e})")
        check(abs(keep - p) <= 4 * sigma, "K2 output keep rate off by more than 4 sigma")
        check(abs(y.mean().item() - 1.0) <= 4 * sigma / p, "K2 mean of qdrop(1) is biased")
        eye = torch.zeros_like(w2)
        eye[:C] = torch.eye(C, device=dev)
        y = fused_mlp(zero_x, torch.zeros_like(w1), torch.ones_like(b1), eye,
                      torch.zeros_like(b2), residual=zres, seed=8, drop_rate=0.1)
        keep2 = (y != 0).float().mean().item()
        sigma2 = (p * p * (1 - p * p) / n) ** 0.5
        log(f"K2 hidden and output masks: keep rate {keep2:.6f} vs {p * p:.6f} "
            f"(4 sigma {4 * sigma2:.2e})")
        check(abs(keep2 - p * p) <= 4 * sigma2, "K2 hidden keep rate off by more than 4 sigma")

        ms = timed(lambda: fused_mlp(x, w1, b1, w2, b2, residual=res), 10)
        plain_ms = timed(lambda: fused_mlp_plain(x, w1, b1, w2, b2, residual=res), 3)
        library_ms = timed(
            lambda: F.gelu(torch.matmul(x, w1b) + b1b, approximate="tanh") @ w2b + b2b, 10)
        ms_nores = timed(lambda: fused_mlp(x, w1, b1, w2, b2), 10)
        repack_ms = timed(lambda: weight_image(w1, w2), 20)
        nbytes = 2.0 * (x.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C) \
            + 4.0 * res.numel() + 4.0 * N * C
        bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
        nb_nores = 2.0 * (x.numel() + w1.numel() + w2.numel() + N * C) + 4.0 * (Hd + C)
        bound_nores, by_nores = bound(flops1, nb_nores, BF16_PEAK)
        log(f"K2 (64800,256)->512->256 bf16, f32 residual: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul chain {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {flops1 / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) on {smi_line}")
        log(f"K2 no residual, bf16 out: kernel {ms_nores:.4f} ms, bound {bound_nores:.4f} ms "
            f"({by_nores}); of each call, the weight repack kernel {repack_ms:.4f} ms")
        # the interpolator's call: the dropout mask is drawn, not read, so
        # the bound is the same with it on
        drop_kw = dict(seed=20260105, drop_rate=0.1)
        ms_i = timed(lambda: fused_mlp(xi, w1, b1, w2, b2), 10)
        ms_i_drop = timed(lambda: fused_mlp(xi, w1, b1, w2, b2, **drop_kw), 10)
        library_i = timed(lambda: F.gelu(torch.matmul(xi, w1b) + b1b, approximate="tanh")
                          @ w2b + b2b, 10)
        nb_i = 2.0 * (2 * xi.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C)
        bound_i, by_i = bound(2 * flops1, nb_i, BF16_PEAK)
        philox_share = (ms_i_drop - ms_i) / ms_i_drop
        log(f"K2 interpolator call (129600,256)->512->256, no residual, bf16 out: kernel "
            f"{ms_i:.4f} ms with dropout off, {ms_i_drop:.4f} ms with dropout 0.1 (the Philox "
            f"draws and masks {philox_share:.1%} of it), torch.matmul chain without dropout "
            f"{library_i:.4f} ms, bound {bound_i:.4f} ms ({by_i}; {2 * flops1 / 1e9:.2f} GFLOP, "
            f"{nb_i / 1e6:.1f} MB) on {smi_line}")
        report["K2"] = dict(max_abs_err=k2_err[0], max_rel_err=k2_err[1], ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ms_nores=ms_nores, repack_ms=repack_ms,
                            ms_interp=ms_i, ms_interp_dropout=ms_i_drop,
                            library_ms_interp=library_i, bound_ms_interp=bound_i,
                            philox_share=philox_share)
        del x, res, xi, y, want, zero_x, zres, img

    with Phase("4 K3 fused block tail"):
        g = torch.Generator(device=dev).manual_seed(2)

        def operands(B):
            return (torch.randn((B, N, C), device=dev, generator=g).bfloat16(),
                    1.0 + 0.1 * torch.randn((B, 1, C), device=dev, generator=g),
                    0.1 * torch.randn((B, 1, C), device=dev, generator=g),
                    torch.randn((B, N, C), device=dev, generator=g))

        x1, a1, c1, res1 = operands(1)  # the forecaster's call: f32 residual stream
        x2, a2, c2, res2 = operands(2)  # the interpolator's double batch
        cases = {
            "B=1, f32 residual (forecaster)": (x1, a1, c1, dict(residual=res1), tol_bf16),
            "B=2, no residual, bf16 out (interpolator)": (x2, a2, c2, {}, tol_bf16),
            "B=2, 77 rows per sample (tiles straddle samples)":
                (x2[:, :77], a2, c2, dict(residual=res2[:, :77]), tol_bf16),
            "erf gelu": (x1, a1, c1, dict(residual=res1, exact_gelu=True), tol_bf16),
            "dropout 0.1 on, B=2": (x2, a2, c2, dict(seed=20260102, drop_rate=0.1), tol_bf16),
            "float32 in and out, B=2, 77 rows": (x2[:, :77].float(), a2, c2,
                                                 dict(residual=res2[:, :77]), tol_f32),
        }
        k3_err = None
        for name, (xx, aa, cc, kw, tol) in cases.items():
            y = fused_block_tail(xx, aa, cc, w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            want = fused_block_tail_plain(xx, aa, cc, w1, b1, w2, b2, **kw)
            check(y.dtype == want.dtype and y.shape == want.shape,
                  f"K3 {name}: {y.dtype} {tuple(y.shape)} vs {want.dtype} {tuple(want.shape)}")
            abs_err, rel_err = errs(y, want)
            log(f"K3 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
                f"{rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K3 disagrees with its plain version ({name})")
            if "seed" in kw:
                # no residual: a dropped output element is exactly 0
                dropped = (y == 0).float().mean().item()
                check(torch.equal(y == 0, want == 0), "K3 dropout mask differs from the plain")
                log(f"K3 dropout: the kernel drops the plain version's elements "
                    f"({dropped:.6f} of the outputs)")
            if k3_err is None:
                k3_err = (abs_err, rel_err)
        kw = dict(seed=20260103, drop_rate=0.1)
        y3 = fused_block_tail(x2, torch.ones_like(a2), torch.zeros_like(c2), w1, b1, w2, b2,
                              **kw)
        y2 = fused_mlp(x2.reshape(-1, C), w1, b1, w2, b2, **kw)
        check(torch.equal(y3.reshape(-1, C), y2), "K3 with A = 1, C = 0 differs from K2")
        log("K3 with A = 1, C = 0 equals K2 bit for bit (B=2, dropout on)")

        ms = timed(lambda: fused_block_tail(x1, a1, c1, w1, b1, w2, b2, residual=res1), 10)
        plain_ms = timed(lambda: fused_block_tail_plain(x1, a1, c1, w1, b1, w2, b2,
                                                        residual=res1), 3)
        library_ms = timed(lambda: F.gelu(torch.matmul((x1.float() * a1 + c1).bfloat16(), w1b)
                                          + b1b, approximate="tanh") @ w2b + b2b + res1, 10)
        ms_b2 = timed(lambda: fused_block_tail(x2, a2, c2, w1, b1, w2, b2), 10)
        ms_b2_drop = timed(lambda: fused_block_tail(x2, a2, c2, w1, b1, w2, b2,
                                                    seed=20260106, drop_rate=0.1), 10)
        plain_b2 = timed(lambda: fused_block_tail_plain(x2, a2, c2, w1, b1, w2, b2), 3)
        library_b2 = timed(lambda: F.gelu(torch.matmul((x2.float() * a2 + c2).bfloat16(), w1b)
                                          + b1b, approximate="tanh") @ w2b + b2b, 10)
        nbytes = 2.0 * (x1.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C) \
            + 4.0 * (a1.numel() + c1.numel()) + 4.0 * res1.numel() + 4.0 * N * C
        bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
        nb_b2 = 2.0 * (x2.numel() + w1.numel() + w2.numel() + 2 * N * C) + 4.0 * (Hd + C) \
            + 4.0 * (a2.numel() + c2.numel())
        bound_b2, by_b2 = bound(2 * flops1, nb_b2, BF16_PEAK)
        log(f"K3 B=1 (64800,256)->512->256 bf16, f32 residual: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, affine + torch.matmul chain + residual {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {flops1 / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) on {smi_line}")
        log(f"K3 B=2 no residual, bf16 out: kernel {ms_b2:.4f} ms, plain {plain_b2:.4f} ms, "
            f"affine + torch.matmul chain {library_b2:.4f} ms, bound {bound_b2:.4f} ms "
            f"({by_b2}; {2 * flops1 / 1e9:.2f} GFLOP, {nb_b2 / 1e6:.1f} MB)")
        log(f"K3 B=2 with dropout 0.1: kernel {ms_b2_drop:.4f} ms, bound {bound_b2:.4f} ms "
            f"(the mask is drawn, not read); Philox and masks "
            f"{(ms_b2_drop - ms_b2) / ms_b2_drop:.1%} of it")
        report["K3"] = dict(max_abs_err=k3_err[0], max_rel_err=k3_err[1], ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ms_b2=ms_b2, plain_ms_b2=plain_b2,
                            library_ms_b2=library_b2, bound_ms_b2=bound_b2, bound_by_b2=by_b2,
                            ms_b2_dropout=ms_b2_drop)
        del x1, a1, c1, res1, x2, a2, c2, res2, y, want, y2, y3

    with Phase("5 K4 fused rank pipeline"):
        g = torch.Generator(device=dev).manual_seed(3)

        def rank_operands(B, H, L, M, R, dtype, grid=None):
            """xf (B, H, M, 2R, 2) and the (M, H, L) Legendre matrices of a
            2H-longitude ``grid`` in dtype (random matrices without one), C
            (L, R, 2) float32, and l_first (M,) int32: the transforms' record
            (m on the Legendre grids), or read from random matrices (0)."""
            xf = torch.randn((B, H, M, 2 * R, 2), device=dev, generator=g).to(dtype)
            C = torch.randn((L, R, 2), device=dev, generator=g) * 0.5
            if grid is None:
                A = (torch.randn((M, H, L), device=dev, generator=g) * 0.2).to(dtype)
                S = (torch.randn((M, H, L), device=dev, generator=g) * 0.2).to(dtype)
                l_first = legendre_l_first(A, S)
            else:
                kw = dict(grid=grid, matmul_dtype=dtype, kernel_layout=True)
                fwd, inv = RealSHT(H, 2 * H, L, M, **kw), InverseRealSHT(H, 2 * H, L, M, **kw)
                A, S = fwd.analysis_mhl.to(dev), inv.synthesis_mhl.to(dev)
                l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first).to(dev)
            return xf, A, S, C, l_first

        def rank_library(xf, A, S, C):
            """The yardstick: the bf16 (or float32) torch.bmm chain, batched
            over m, with the float32 CP scale between the two products and
            the layout permutes to and from the port's layout."""
            B, H, M, R2, _ = xf.shape
            R, L = R2 // 2, A.shape[2]
            xm = xf.permute(2, 1, 0, 3, 4).reshape(M, H, B * R2 * 2)
            t = torch.bmm(A.transpose(1, 2), xm).view(M, L, B, R2, 2).float()
            Sr, Si = t[..., :R, :], t[..., R:, :]
            p_re, p_im = Sr[..., 0] - Si[..., 1], Sr[..., 1] + Si[..., 0]
            Cr, Ci = C[:, None, :, 0], C[:, None, :, 1]
            s_re, s_im = p_re * Cr - p_im * Ci, p_re * Ci + p_im * Cr
            s = torch.cat([torch.stack([s_re, s_im], -1), torch.stack([-s_im, s_re], -1)], -2)
            y = torch.bmm(S, s.to(xf.dtype).reshape(M, L, B * R2 * 2))
            return y.view(M, H, B, R2, 2).permute(2, 1, 0, 3, 4).contiguous()

        def rank_bound(xf, A, S, C, l_first, dense=False):
            """Over what these inputs need: the rows l >= l_first[m] of A[m]
            and S[m] (the triangle; dense=True: all of them), xf and y once,
            C."""
            B, H, M, R2, _ = xf.shape
            L = A.shape[2]
            rows = M * L if dense else int((L - l_first.clamp(0, L)).sum())
            flops = 2 * 2.0 * H * rows * 2 * R2 * B
            nbytes = xf.element_size() * (2 * xf.numel() + 2 * H * rows) + 4.0 * C.numel()
            return bound(flops, nbytes, BF16_PEAK if xf.dtype == torch.bfloat16 else F32_PEAK)

        cases = {
            "fast shape B=1 bf16 (the forecaster)": ((1, 180, 144, 144, 64), torch.bfloat16,
                                                      "legendre-gauss", tol_bf16),
            "fast shape B=2 bf16 (the interpolator)": ((2, 180, 144, 144, 64), torch.bfloat16,
                                                       "legendre-gauss", tol_bf16),
            "fast shape B=1 float32": ((1, 180, 144, 144, 64), torch.float32,
                                       "legendre-gauss", tol_f32),
            "fast shape B=2 float32": ((2, 180, 144, 144, 64), torch.float32,
                                       "legendre-gauss", tol_f32),
            "prototype shape l=m=181 bf16": ((1, 180, 181, 181, 64), torch.bfloat16,
                                             "equiangular", tol_bf16),
            "prototype shape l=m=181 float32": ((1, 180, 181, 181, 64), torch.float32,
                                                "equiangular", tol_f32),
            "0.25-degree grid h 721 (h in chunks), l=m=144 bf16": (
                (1, 721, 144, 144, 64), torch.bfloat16, "equiangular", tol_bf16),
            "ragged h 37, l=m=29, R 5 bf16": ((2, 37, 29, 29, 5), torch.bfloat16, None, tol_bf16),
            "ragged h 37, l=m=29, R 5 float32": ((2, 37, 29, 29, 5), torch.float32, None,
                                                 tol_f32),
        }
        k4 = {}
        for name, (shape, dtype, grid, tol) in cases.items():
            ops = rank_operands(*shape, dtype, grid)
            y = fused_rank(*ops)
            torch.cuda.synchronize()
            want = fused_rank_plain(*ops[:4])
            check(y.dtype == want.dtype and y.shape == want.shape,
                  f"K4 {name}: {y.dtype} {tuple(y.shape)} vs {want.dtype} {tuple(want.shape)}")
            abs_err, rel_err = errs(y, want)
            log(f"K4 {name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                f"(tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K4 disagrees with its plain version ({name})")
            if name.startswith("fast shape") and dtype == torch.bfloat16:
                lib_err = errs(rank_library(*ops[:4]), want)[1]
                ms = timed(lambda: fused_rank(*ops), 20)
                dev_ms = device_ms(lambda: fused_rank(*ops), 20)
                plain_ms = timed(lambda: fused_rank_plain(*ops[:4]), 5)
                library_ms = timed(lambda: rank_library(*ops[:4]), 20)
                bound_ms, bound_by = rank_bound(*ops)
                dense_ms, _ = rank_bound(*ops, dense=True)
                log(f"K4 {name}: kernel {ms:.4f} ms a call in a loop through the wrapper "
                    f"({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, "
                    f"bf16 torch.bmm chain {library_ms:.4f} ms (its max rel err {lib_err:.3e}), "
                    f"bound over the triangle {bound_ms:.4f} ms ({bound_by}), dense bound "
                    f"{dense_ms:.4f} ms on {smi_line}")
                k4[shape[0]] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                                    device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    bound_ms_dense=dense_ms)
            del ops, y, want
        report["K4"] = dict(k4[1], **{f"{k}_b2": v for k, v in k4[2].items()})

    inp = main_path.window_inputs(N_STEPS, seed=0, device="cuda")
    other = [c for c in range(35) if c != 1]  # the channels the models drive

    def window(st, seed):
        out = st.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                            torch.Generator().manual_seed(seed), N_STEPS)
        torch.cuda.synchronize()
        return out

    def drive(name, path_kw, per_forward):
        """Build the path at full width, warm it up, and run one counted,
        timed 12-step window with dropout live. ``per_forward`` maps each
        kernel to the launches the path must make per SFNO forward."""
        t0 = time.perf_counter()
        stepper = main_path.build(embed=256, layers=8, dtype="bfloat16", device="cuda", seed=0,
                                  **path_kw)
        log(f"{name} built in {time.perf_counter() - t0:.2f} s")
        nets = {"forecaster": stepper.exp.model, "interpolator": stepper.exp.interpolator.model}
        batches = {k: [] for k in nets}
        for k, net in nets.items():
            net.register_forward_pre_hook(lambda mod, args, k=k: batches[k].append(
                args[0].shape[0]))
        t0 = time.perf_counter()
        window(stepper, 1)  # first window: cuBLAS and allocator warm-up
        log(f"{name} warm-up window: {time.perf_counter() - t0:.2f} s")
        for k in batches:
            batches[k].clear()
        for fn in (*wrappers.values(), weight_image, dhconv_weight_image):
            fn.launches = 0
        t0 = time.perf_counter()
        x_out, preds = window(stepper, 2)
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        check(weight_image.launches == launches["K2"] + launches["K3"],
              f"{name}: {weight_image.launches} weight repacks for "
              f"{launches['K2'] + launches['K3']} bf16 K2/K3 launches")
        check(dhconv_weight_image.launches == 0,
              f"{name}: {dhconv_weight_image.launches} K1 weight images made in a window after "
              f"the first (each filter makes its image once)")
        forwards = sum(len(b) for b in batches.values())
        log(f"{name} window: {N_STEPS} steps in {seconds:.3f} s = {N_STEPS / seconds:.3f} "
            f"steps/s at batch 1 on {smi_line}")
        log(f"{name} SFNO forwards {forwards}, batch sizes {batches} -> launches {launches}")
        for k, n in per_forward.items():
            want = n * forwards
            check(forwards > 0 and launches[k] == want,
                  f"{name}: {k} launched {launches[k]} times, expected {want}")
        check(preds.shape == (1, N_STEPS, 180, 360, 35), f"preds shape {tuple(preds.shape)}")
        check(bool(torch.isfinite(preds).all()) and bool(torch.isfinite(x_out).all()),
              f"{name}: non-finite predictions")
        return dict(seconds=seconds, forwards=forwards, launches=launches, batches=batches)

    def pair(dtype, path_kw, plain_kw):
        """The same window with dropout off through the kernels and through
        the plain path, same weights; returns (kernels, plain) predictions."""
        kern = main_path.build(dtype=dtype, device="cuda", seed=0,
                               enable_interpolator_dropout=False, **path_kw)
        plain = main_path.build(dtype=dtype, device="cuda", seed=0,
                                enable_interpolator_dropout=False, **plain_kw)
        plain.exp.model.load_state_dict(kern.exp.model.state_dict())
        plain.exp.interpolator.model.load_state_dict(kern.exp.interpolator.model.state_dict())
        t0 = time.perf_counter()
        _, pk = window(kern, 3)
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, pp = window(plain, 3)
        tp = time.perf_counter() - t0
        check(bool(torch.isfinite(pk).all()), f"non-finite {dtype} predictions")
        log(f"deterministic window {dtype}: kernels {tk:.3f} s, plain path {tp:.3f} s")
        return pk, pp

    with Phase("6 window path (K1, K2, scan sampler)"):
        runs["window"] = drive("window path", {}, {"K1": 8, "K2": 8, "K3": 0, "K4": 0})
        # two horizon-6 segments: one double-batch interpolation per step
        check(runs["window"]["batches"]["interpolator"] == [2] * N_STEPS,
              "the scan sampler should run every interpolation on the double batch")
        # dropout off: kernels against the plain path (K1 -> einsum
        # contraction, K2 -> unfused MLP), same weights, same inputs. The
        # scale is the largest prediction outside the prescribed SST channel
        # (the model-driven values). float32 must agree to float32 rounding;
        # bf16 rounds the MLP at other places in the two paths (once after
        # the fused second product vs after each Dense and its bias), which
        # measured 1-2% of that scale at debug size on the CPU.
        for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-4)):
            pk, pp = pair(dtype, {}, dict(use_pallas=False, fused_mlp=False))
            scale = pp[..., other].abs().max().item()
            diff = (pk - pp).abs().max().item()
            log(f"window path {dtype}: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
                f"of the largest model-driven prediction {scale:.3e} (tolerance {tol:g})")
            check(diff <= tol * scale, f"window path {dtype}: kernels disagree with the plain path")
            del pk, pp

    tail_kw = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True)
    with Phase("7 fused-tail path (K1, K3, peeled sampler)"):
        runs["fused_tail"] = drive("fused-tail path", tail_kw,
                                   {"K1": 8, "K2": 0, "K3": 8, "K4": 0})
        # per segment: single-batch ends, the double batch in between
        check(runs["fused_tail"]["batches"]["interpolator"] == ([1] + [2] * 4 + [1]) * 2,
              "the peeled sampler's interpolator batches are not 1, 2, 2, 2, 2, 1 per segment")
        plain_kw = dict(use_pallas=False, fused_mlp=False, fused_tail=False, peel=True,
                        scan_layers=True)
        pk32, pp32 = pair("float32", tail_kw, plain_kw)
        scale = pp32[..., other].abs().max().item()
        diff = (pk32 - pp32).abs().max().item()
        log(f"fused-tail path float32: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
            f"of the largest model-driven prediction {scale:.3e} (tolerance 1e-4)")
        check(diff <= 1e-4 * scale, "fused-tail path float32: kernels disagree with the plain path")
        del pk32
        pk, pp = pair("bfloat16", tail_kw, plain_kw)
        gap = (pk - pp).abs().max().item()
        noise = (pp - pp32).abs().max().item()
        log(f"fused-tail path bf16: max |kernels - plain| {gap:.3e} = {gap / scale:.3e} of the "
            f"largest model-driven prediction; the plain path's own bf16 error "
            f"max |plain bf16 - plain float32| {noise:.3e} = {noise / scale:.3e}; ratio "
            f"{gap / noise:.3f} (tolerance {BF16_TAIL_VS_PLAIN:g})")
        check(gap <= BF16_TAIL_VS_PLAIN * noise,
              "fused-tail path bf16: kernels disagree with the plain path")
        del pk, pp, pp32

    fast_kw = dict(main_path.FAST_WINDOW)
    with Phase("8 fast window (K4, CP rank pipeline, peeled sampler)"):
        # blocks 1-6 take the rank pipeline; blocks 0 and 7 change grid and
        # contract in spectral space; the block MLP is unfused
        runs["fast"] = drive("fast window", fast_kw, {"K1": 0, "K2": 0, "K3": 0, "K4": 6})
        check(runs["fast"]["launches"]["K4"] == 144, "the fast window should launch K4 144 x")
        check(runs["fast"]["batches"]["interpolator"] == ([1] + [2] * 4 + [1]) * 2,
              "the peeled sampler's interpolator batches are not 1, 2, 2, 2, 2, 1 per segment")
        # dropout off, K4 against the plain path (same weights, fused_rank
        # off). K4 computes in float32 throughout or rounds like bf16 matmul
        # dtype with bf16 spectral IO, so the float32 pair runs without the
        # spectral-IO emit; bf16 is held, as the fused-tail path, to a
        # multiple of the plain path's own bf16 error
        f32_kw = dict(fast_kw, spectral_io="")
        pk32, pp32 = pair("float32", f32_kw, dict(f32_kw, fused_rank=False))
        scale = pp32[..., other].abs().max().item()
        diff = (pk32 - pp32).abs().max().item()
        log(f"fast window float32: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
            f"of the largest model-driven prediction {scale:.3e} (tolerance 1e-4)")
        check(diff <= 1e-4 * scale, "fast window float32: K4 disagrees with the plain path")
        del pk32
        pk, pp = pair("bfloat16", fast_kw, dict(fast_kw, fused_rank=False))
        gap = (pk - pp).abs().max().item()
        noise = (pp - pp32).abs().max().item()
        log(f"fast window bf16: max |kernels - plain| {gap:.3e} = {gap / scale:.3e} of the "
            f"largest model-driven prediction; the plain path's own bf16 error "
            f"max |plain bf16 - plain float32| {noise:.3e} = {noise / scale:.3e}; ratio "
            f"{gap / noise:.3f} (tolerance {BF16_TAIL_VS_PLAIN:g})")
        check(gap <= BF16_TAIL_VS_PLAIN * noise, "fast window bf16: K4 disagrees with the plain path")
        del pk, pp, pp32

    with Phase("10 rollout (run_inference, aggregator, 96-step windows)"):
        names = main_path.state_names()
        rollout_kw = dict(embed=256, layers=8, dtype="bfloat16", device="cuda", seed=0,
                          params_dtype="bfloat16", preds_dtype="bfloat16", **tail_kw)
        ema_net = SFNO(main_path.sfno_configs(fused_tail=True, scan_layers=True)[1]).to(dev)
        ema_net.init_weights(torch.Generator(device=dev).manual_seed(1))
        rollout_kw["ema_params"] = ema_net.state_dict()
        t0 = time.perf_counter()
        stepper = main_path.build(**rollout_kw)
        del ema_net
        log(f"rollout stepper built in {time.perf_counter() - t0:.2f} s (EMA forecaster from "
            f"seed 1, weights rounded to bf16, bf16 predictions)")
        last = {}
        run = stepper.run_window

        def record_state(*args, **kwargs):
            out = run(*args, **kwargs)
            last["x"] = out[0]
            return out

        stepper.run_window = record_state

        def zero_counts():
            for fn in (*wrappers.values(), weight_image, dhconv_weight_image):
                fn.launches = 0

        t0 = time.perf_counter()
        summary, logs = main_path.product_rollout(stepper, n_steps=ROLLOUT_STEPS,
                                                  window=ROLLOUT_WINDOW, before_timed=zero_counts)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        n_windows = ROLLOUT_STEPS // ROLLOUT_WINDOW
        per_window = {k: v / n_windows for k, v in launches.items()}
        steady = summary["steady_steps_per_second"]
        log(f"rollout: warm-up window and {ROLLOUT_STEPS} timed steps in "
            f"{time.perf_counter() - t0:.2f} s")
        log(f"rollout {ROLLOUT_STEPS} steps in {n_windows} windows of {ROLLOUT_WINDOW}, batch 1, "
            f"aggregator on: duration {summary['duration_s']:.3f} s, total "
            f"{summary['total_steps_per_second']:.3f} steps/s, steady {steady:.3f} steps/s = "
            f"{steady * 86400 / STEPS_PER_SIM_YEAR:.1f} sim-yr/day; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in summary.items() if k.startswith("time/"))
            + f"; upload cache skips {summary['upload_cache_skips']} on {smi_line}")
        log(f"rollout launches per timed window {per_window}; K1 weight images made in the "
            f"timed windows: {dhconv_weight_image.launches}; K2/K3 weight repacks "
            f"{weight_image.launches}")
        for k, n in (("K1", 1536), ("K2", 0), ("K3", 1536), ("K4", 0)):
            check(launches[k] == n * n_windows,
                  f"rollout: {k} launched {launches[k]} times in {n_windows} windows, "
                  f"expected {n} a window")
        check(dhconv_weight_image.launches == 0,
              f"rollout: {dhconv_weight_image.launches} K1 weight images made in timed windows")
        check(weight_image.launches == launches["K3"], "rollout: one weight repack per K3 launch")
        check(summary["n_forward_steps"] == ROLLOUT_STEPS, f"rollout summary {summary}")
        bad = {k: v for k, v in logs.items() if not np.isfinite(v)}
        check(len(logs) > 0 and not bad, f"rollout: non-finite logs {list(bad)[:5]}")
        check(bool(torch.isfinite(last["x"]).all()), "rollout: non-finite final state")
        log(f"rollout logs: {len(logs)}, all finite; inference/avg/rmse "
            f"{logs['inference/avg/rmse']:.4f}, time-mean rmse of v0 "
            f"{logs['inference/time_mean/rmse/v0']:.4f}; final state finite")
        runs["rollout"] = dict(launches=launches, summary=summary)

        t0 = time.perf_counter()
        _, logs2 = main_path.product_rollout(stepper, n_steps=N_STEPS, window=N_STEPS,
                                             n_ensemble=2)
        ens = {k: logs2.get(f"inference/avg/{k}") for k in ("crps", "ssr")}
        check(all(v is not None and np.isfinite(v) for v in ens.values()),
              f"ensemble 2: CRPS and SSR missing or not finite: {ens}")
        log(f"rollout at ensemble 2, {N_STEPS} steps ({time.perf_counter() - t0:.2f} s with its "
            f"warm-up): inference/avg/crps {ens['crps']:.4e}, inference/avg/ssr {ens['ssr']:.4e}")
        stepper.run_window = run
        del stepper, last

        # dropout off: run_inference against run_window chained by hand on
        # inputs read from the source here (the main path's normalizers are
        # the identity, so the raw fields are the normalized inputs)
        det = main_path.build(**dict(rollout_kw, enable_interpolator_dropout=False))
        n_det = 2 * N_STEPS
        src = SyntheticTimeSeries(names + list(main_path.FORCING_NAMES) + [main_path.MASK_NAME],
                                  n_timesteps=n_det + 1)
        outs = []
        run = det.run_window

        def record(*args, **kwargs):
            out = run(*args, **kwargs)
            outs.append(out)
            return out

        det.run_window = record
        agg = InferenceAggregator(names, src.horizontal.area_weights(),
                                  log_zonal_mean_images=False)
        # the source does not repeat, so every window misses the upload
        # cache; the sync debug mode raises on any synchronizing CUDA call
        # (a pageable upload, a device-to-host copy) before the end sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_inference(det, src, InferenceConfig(n_forward_steps=n_det,
                                                    forward_steps_in_memory=N_STEPS),
                          aggregator=agg, mask_name=main_path.MASK_NAME, verbose=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log(f"dropout off, {n_det} steps, no repeats: run_inference issued no synchronizing "
            f"CUDA call before its end sync (sync debug mode 'error')")
        det.run_window = run
        raw_np = src.read_window(0, n_det + 1, src.names)
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
        x = torch.stack([raw[n][0] for n in names], -1)[None]
        forcing = torch.stack([raw[n] for n in main_path.FORCING_NAMES], -1)[None]
        chained = []
        for w in range(2):
            sl = slice(N_STEPS * w, N_STEPS * (w + 1) + 1)
            x, p = det.run_window(x, forcing[:, sl], raw["surface_temperature"][None, sl],
                                  raw[main_path.MASK_NAME][None, sl],
                                  torch.Generator().manual_seed(0), N_STEPS,
                                  apply_inputs_noise=(w == 0))
            chained.append(p)
        torch.cuda.synchronize()
        loop_preds = torch.cat([o[1] for o in outs], dim=1)
        chained = torch.cat(chained, dim=1)
        same = torch.equal(outs[-1][0], x) and torch.equal(loop_preds, chained)
        gap = max(errs(outs[-1][0], x)[1], errs(loop_preds, chained)[1])
        log(f"dropout off, {n_det} steps in two windows: run_inference against chained "
            f"run_window: {'equal bit for bit' if same else 'not bit-equal'}, max gap "
            f"{gap:.3e} of the largest value (tolerance: bit for bit, or 1e-6 if a library "
            f"call is not deterministic)")
        check(same or gap <= 1e-6, "run_inference differs from chained run_window calls")
        # the aggregator's per-step tables against float64 numpy
        p64 = chained[0].float().cpu().numpy().astype(np.float64)
        y64 = np.stack([raw_np[n][1:n_det + 1] for n in names], -1).astype(np.float64)
        lat = src.horizontal.lat
        w64 = np.cos(np.deg2rad(lat))[:, None] * np.ones((1, len(src.horizontal.lon)))
        w64 = (w64 / w64.sum())[None, :, :, None]
        diff = p64 - y64
        ref = {"rmse": np.sqrt((w64 * diff ** 2).sum((1, 2)) / w64.sum()),
               "bias": (w64 * diff).sum((1, 2)) / w64.sum()}
        series = agg.reduced.series()
        for k, want in ref.items():
            got = series[k]
            check(got.shape == want.shape, f"{k} table {got.shape} vs {want.shape}")
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            log(f"aggregator {k} table ({got.shape[0]} steps x {got.shape[1]} channels) against "
                f"float64 numpy: max gap {rel:.3e} of its largest value (tolerance 1e-4)")
            check(rel <= 1e-4, f"aggregator {k} table differs from float64 numpy")
        # run and record hold det's bound method, rollout_kw the EMA weights
        del det, run, record, outs, chained, loop_preds, raw, p64, y64, diff, agg, x, forcing
        del p, rollout_kw

    with Phase("9 profile (one window of each path)"):
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities):  # the profiler's own start-up, not measured
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        for name, run, path_kw in (("window path", "window", {}),
                                   ("fused-tail path", "fused_tail", tail_kw),
                                   ("fast window", "fast", fast_kw)):
            stepper = main_path.build(embed=256, layers=8, dtype="bfloat16", device="cuda",
                                      seed=0, **path_kw)
            window(stepper, 1)
            t0 = time.perf_counter()
            with profile(activities=activities) as prof:
                window(stepper, 2)
            wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if "cuda" in str(getattr(e, "device_type", "")).lower()]
            dev_us = {e.key: (e.count, getattr(e, "self_device_time_total",
                                               getattr(e, "self_cuda_time_total", 0)))
                      for e in events}
            busy = sum(us for _, us in dev_us.values()) / 1e6
            unprofiled = runs[run]["seconds"]
            log(f"{name} profile: {len(events)} CUDA kernels, device kernel time {busy:.3f} s "
                f"= {busy / unprofiled:.1%} of the unprofiled window ({unprofiled:.3f} s; "
                f"{wall:.3f} s with the profiler on); top 10 CUDA kernels by total time:")
            for key, (cnt, us) in sorted(dev_us.items(), key=lambda kv: -kv[1][1])[:10]:
                log(f"  {us / 1e3:10.2f} ms  {us / 1e6 / max(busy, 1e-12):6.1%}  x{cnt:<5d} "
                    f"{key[:110]}")
            groups = {}
            for key, (cnt, us) in dev_us.items():
                group = ("K1 weight image" if "dhconv_weight_image" in key else
                         "K1" if "dhconv" in key else
                         "K4" if "fused_rank" in key else
                         "K3" if re.search(r"fused_mlp(_tc)?_kernel<true", key) else
                         "K2" if re.search(r"fused_mlp(_tc)?_kernel<false", key) else
                         "K2/K3 weight repack" if "weight_image_kernel" in key else
                         "cuBLAS GEMM" if any(w in key.lower() for w in
                                              ("gemm", "nvjet", "xmma", "cutlass")) else
                         "copies" if "copy" in key.lower() else
                         "reductions" if "reduce" in key.lower() else "other elementwise")
                groups[group] = groups.get(group, 0.0) + us / 1e6
            log(f"{name} kernel time by group: " + ", ".join(
                f"{k} {v:.3f} s ({v / max(busy, 1e-12):.1%})"
                for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
            del stepper, prof

    with Phase("13 model options at 256 x 8 (Tucker, fold, remat, the other options)"):
        phase13(smi_line, wrappers, report, runs, drive, pair, other)

    with Phase("14 training modes at 256 x 8 (bf16, bf16 moments, fused, streaming, rollout "
               "validation, histograms, code snapshot)"):
        phase14(smi_line, wrappers, report, runs)

    sources = {"K1": "spherical_dyffusion_tpu_torch/csrc/dhconv.cu",
               "K2": "spherical_dyffusion_tpu_torch/csrc/fused_mlp.cu",
               "K3": "spherical_dyffusion_tpu_torch/csrc/fused_mlp.cu",
               "K4": "spherical_dyffusion_tpu_torch/csrc/fused_rank.cu"}
    replaces = {"K1": "spherical_dyffusion_tpu/ops/pallas_contractions.py:72",
                "K2": "spherical_dyffusion_tpu/ops/fused_mlp.py:125",
                "K3": "spherical_dyffusion_tpu/ops/fused_mlp.py:212",
                "K4": "scripts/proto_fused_rank.py:94"}
    names = {"K1": "dhconv", "K2": "fused_mlp", "K3": "fused_block_tail", "K4": "fused_rank"}
    own_path = {"K1": "window", "K2": "window", "K3": "fused_tail", "K4": "fast"}
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        kernels.append(dict(
            name=names[k], route="cuda", source=sources[k], replaces=replaces[k],
            launches=runs[own_path[k]]["launches"][k],
            launches_by_path={p: r["launches"][k] for p, r in runs.items()},
            kernel_ms=report[k]["ms"], **report[k]))
    # K1 run by the backward for dx (JAX's custom VJP, whose dx is XLA's
    # einsum and whose forward is the Pallas kernel); launches over the
    # training steps of phase 11
    kernels.append(dict(name="dhconv_backward_dx", route="cuda", source=sources["K1"],
                        replaces="spherical_dyffusion_tpu/ops/pallas_contractions.py:94",
                        kernel_ms=report["K1_bwd"]["ms"], **report["K1_bwd"]))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    fused_tail_rate = N_STEPS / runs["fused_tail"]["seconds"]
    report["cli"]["inference"]["phase7_fused_tail_steps_per_second"] = fused_tail_rate
    log(f"inference command line: steady {report['cli']['inference']['steady_steps_per_second']:.3f}"
        f" steps/s against phase 7's fused-tail window {fused_tail_rate:.3f} steps/s")
    print(json.dumps({"training": report["training"]}))
    print(json.dumps({"cli": report["cli"]}))
    print(json.dumps({"options": report["options"]}))
    print(json.dumps({"modes": report["modes"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
