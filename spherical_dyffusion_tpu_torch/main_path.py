"""The port's main path: the DYffusion window rollout of ``bench.py:build()``.

Builds the same system as the JAX package's benchmark builder, with the
configuration written here in Python (no YAML): two SFNOs at 180 x 360 with
a time embedding, bf16 compute with the transforms and spectral products
rounding their operands to bf16 (``sht_matmul_dtype=dtype``, as
``bench.py:build()`` sets it), the interpolator (72 -> 35 channels) with MLP
dropout and DropPath 0.1 live at inference, the deterministic forecaster
(37 -> 35), DYffusion at horizon 6 with ``forward_conditioning="none"`` and
``time_encoding="dynamics"``, and the SST prescriber. ``use_pallas`` and
``fused_mlp`` route the dense spectral contraction and the block MLP through
the hand-written kernels K1 and K2; ``fused_tail`` routes norm1, the time
scale-shift, the MLP and the outer skip of every block through K3 instead
of K2 (``bench.py``'s ``BENCH_FUSED_TAIL=1``). ``factorization``, ``rank``,
``thresh`` and ``spectral_io`` are ``bench.py``'s CP filter, spectral
truncation and spectral-IO dtype, and ``fused_rank`` routes the CP rank
pipeline's spectral middle through K4; ``FAST_WINDOW`` is the JAX bench's
fast product compose (CP rank 0.25, truncation 0.8, bf16 spectral IO, scan
and peel on, no fused MLP) with K4 on, and ``TUCKER_WINDOW`` its compose
with ``BENCH_FACT=tucker BENCH_RANK=0.25`` (the Tucker rank pipeline, scan
and peel on) with K3 on. ``sht_fold_symmetry`` is ``BENCH_FOLD``. The window is cold-sampled
by the double-batch scan sampler, peeled with ``peel`` (``BENCH_PEEL``);
``scan_layers`` (``BENCH_SCAN_LAYERS``) is accepted and runs the blocks as
the same plain loop. ``fused_tail``, ``peel``, ``scan_layers``, folding
and the factorized filters default to off, as in ``bench.py:build()``.

Weights come from a seeded ``torch.Generator`` or from JAX-package parameter
trees (``utils/convert.py``); ``ema_params`` replaces the forecaster's with
its EMA tree, and ``params_dtype`` / ``preds_dtype`` are the stepper's
options of the 10-year config. ``build`` runs on ``device="cuda"`` unless
the caller asks for another device; without CUDA that default raises rather
than falling back to the CPU.

``product_rollout`` is the product path of ``bench.py:product_bench``
without the writer: ``run_inference`` over an aligned ``SyntheticTimeSeries``
with the ``InferenceAggregator`` reducing on the card.

``train_steps`` is the training path of ``bench.py:train_bench``: both
experiments of the paper at their full width, in float32 with K1 on (its
forward, and its backward's dx), K2-K4 off as the JAX trainer keeps them,
the trainer settings of ``configs/trainer/default.yaml``, batch 1 from a
``DebugDataModule`` at 180 x 360: the interpolator trains first, then the
forecaster with it frozen inside ``p_losses``; ``scan_layers`` and
``checkpointing=3`` are ``bench.py``'s training at paper scale with remat
(``BENCH_SCAN_LAYERS=1 BENCH_CKPT=3``). ``fused_epoch`` is the fused-epoch
part of ``bench.py:train_bench`` (``bench.py:459-467``): one
``Trainer.fit_in_memory`` epoch of the interpolator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .data.datamodule import DebugDataModule
from .data.datasets import SyntheticTimeSeries
from .data.normalization import StandardNormalizer
from .data.packer import Packer
from .diffusion.dyffusion import DYffusionConfig
from .evaluation.aggregators import InferenceAggregator
from .inference.loop import InferenceConfig, run_inference
from .inference.prescriber import PrescriberConfig
from .inference.stepper import DYffusionStepper
from .models.sfno import SFNO, SFNOConfig
from .ops.pallas_contractions import dhconv, dhconv_weight_image
from .training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from .training.trainer import Trainer, TrainerConfig
from .utils.convert import flax_to_state_dict

__all__ = ["state_names", "FORCING_NAMES", "MASK_NAME", "FAST_WINDOW", "TUCKER_WINDOW",
           "sfno_configs",
           "build", "window_inputs", "product_rollout", "build_training", "train_steps",
           "fused_epoch"]

FORCING_NAMES = ("DSWRFtoa", "HGTsfc")
MASK_NAME = "ocean_fraction"
# bench.py's fast product compose (BENCH_FACT=cp BENCH_RANK=0.25
# BENCH_THRESH=0.8 BENCH_SPECTRAL_IO=bfloat16, scan and peel on), with the
# rank pipeline's spectral middle on K4; build(**FAST_WINDOW, fused_rank=False)
# is its plain path
FAST_WINDOW = dict(use_pallas=False, fused_mlp=False, fused_tail=False, factorization="cp",
                   rank=0.25, thresh=0.8, spectral_io="bfloat16", scan_layers=True,
                   peel=True, fused_rank=True)
# bench.py's compose with BENCH_FACT=tucker BENCH_RANK=0.25 (scan and peel
# on): the Tucker rank pipeline (2R = 128 channels through the SHTs) in the
# middle blocks, with every block's tail on K3
TUCKER_WINDOW = dict(use_pallas=False, fused_mlp=False, fused_tail=True,
                     factorization="tucker", rank=0.25, scan_layers=True, peel=True)


def state_names(n: int = 35) -> list:
    """The benchmark's packed state: v0..v{n-1}, with channel 1 the
    prescribed surface temperature."""
    names = [f"v{i}" for i in range(n)]
    names[1] = "surface_temperature"
    return names


def sfno_configs(embed: int = 256, layers: int = 8, dtype: str = "bfloat16",
                 img_shape: Tuple[int, int] = (180, 360), horizon: int = 6,
                 n_state: int = 35, use_pallas: bool = True,
                 fused_mlp: bool = True, fused_tail: bool = False,
                 scan_layers: bool = False, factorization: str = "", rank: float = 1.0,
                 thresh: float = 1.0, spectral_io: str = "",
                 sht_fold_symmetry: bool = False,
                 checkpointing: int = 0) -> Tuple[SFNOConfig, SFNOConfig]:
    """(interpolator, forecaster) configs of ``bench.py:build()``."""
    C, CF = n_state, len(FORCING_NAMES)
    common = dict(img_shape=img_shape, out_chans=C, embed_dim=embed, num_layers=layers,
                  operator_type="dhconv", with_time_emb=True, data_grid="equiangular",
                  compute_dtype=dtype, sht_matmul_dtype=dtype, use_pallas=use_pallas,
                  fused_mlp=fused_mlp, hard_thresholding_fraction=thresh,
                  factorization=factorization, rank=rank, spectral_io_dtype=spectral_io,
                  fused_tail=fused_tail, scan_layers=scan_layers,
                  sht_fold_symmetry=sht_fold_symmetry, checkpointing=checkpointing)
    interp = SFNOConfig(in_chans=2 * C + CF, dropout_mlp=0.1, drop_path_rate=0.1,
                        min_time=1, max_time=horizon - 1, **common)
    fcast = SFNOConfig(in_chans=C + CF, min_time=0, max_time=horizon - 1, **common)
    return interp, fcast


def build(embed: int = 256, layers: int = 8, dtype: str = "bfloat16",
          img_shape: Tuple[int, int] = (180, 360), horizon: int = 6, n_state: int = 35,
          use_pallas: bool = True, fused_mlp: bool = True, fused_tail: bool = False,
          peel: bool = False, scan_layers: bool = False, factorization: str = "",
          rank: float = 1.0, thresh: float = 1.0, spectral_io: str = "",
          fused_rank: bool = False, sht_fold_symmetry: bool = False, device: str = "cuda",
          seed: int = 0, flax_params: Optional[Mapping[str, Mapping]] = None,
          enable_interpolator_dropout: bool = True, params_dtype: Optional[str] = None,
          preds_dtype: Optional[str] = None,
          ema_params: Optional[Mapping] = None) -> DYffusionStepper:
    """The window stepper of the main path.

    ``flax_params``: optional ``{"interpolator": ..., "forecaster": ...}``
    JAX-package variable trees; otherwise weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. ``ema_params``
    (a flax tree or a ``state_dict``) turns on ``use_ema_params``: the
    forecaster runs its EMA weights, as the 10-year config's ``use_ema``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    names = state_names(n_state)
    unit = StandardNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names},
                                         names)
    funit = StandardNormalizer.from_dicts({n: 0.0 for n in FORCING_NAMES},
                                          {n: 1.0 for n in FORCING_NAMES}, FORCING_NAMES)
    packer = Packer(names)
    icfg, fcfg = sfno_configs(embed, layers, dtype, img_shape, horizon, n_state,
                              use_pallas, fused_mlp, fused_tail, scan_layers, factorization,
                              rank, thresh, spectral_io, sht_fold_symmetry)
    imodel = SFNO(icfg, fused_rank=fused_rank).to(device)
    fmodel = SFNO(fcfg, fused_rank=fused_rank).to(device)
    if flax_params is not None:
        imodel.load_state_dict(flax_to_state_dict(flax_params["interpolator"]))
        fmodel.load_state_dict(flax_to_state_dict(flax_params["forecaster"]))
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        imodel.init_weights(gen)
        fmodel.init_weights(gen)
    imodel.eval()
    fmodel.eval()
    interp = InterpolationExperiment(
        imodel, ExperimentConfig(horizon=horizon, enable_inference_dropout=True),
        packer, packer, unit)
    dcfg = DYffusionConfig(timesteps=horizon, forward_conditioning="none",
                           time_encoding="dynamics", peel_sampler=peel,
                           enable_interpolator_dropout=enable_interpolator_dropout)
    exp = DYffusionForecastingExperiment(
        fmodel, interp, dcfg, ExperimentConfig(horizon=horizon), packer, packer, unit,
        forcing_names=FORCING_NAMES, forcing_normalizer=funit)
    prescriber = PrescriberConfig("surface_temperature", MASK_NAME, 1).build(names)
    return DYffusionStepper(exp, prescriber=prescriber, use_ema_params=ema_params is not None,
                            ema_params=ema_params, params_dtype=params_dtype,
                            preds_dtype=preds_dtype)


def window_inputs(n_steps: int, img_shape: Tuple[int, int] = (180, 360),
                  n_state: int = 35, batch: int = 1, seed: int = 0,
                  device: str = "cuda") -> dict:
    """Synthetic normalized inputs for one window, made with numpy from
    ``seed``: the initial state (B, H, W, C), forcings (B, T+1, H, W, 2),
    the prescribed SST target (B, T+1, H, W) and a static 0/1 ocean mask
    (B, H, W)."""
    rng = np.random.default_rng(seed)
    H, W = img_shape
    T = n_steps + 1

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return {
        "x0": t(rng.standard_normal((batch, H, W, n_state))),
        "forcing": t(rng.standard_normal((batch, T, H, W, len(FORCING_NAMES)))),
        "sst": t(rng.standard_normal((batch, T, H, W))),
        "mask": t((rng.random((batch, H, W)) < 0.7).astype(np.float32)),
    }


def product_rollout(stepper: DYffusionStepper, n_steps: int = 288, window: int = 96,
                    n_ensemble: int = 1,
                    before_timed: Optional[Callable[[], None]] = None) -> Tuple[dict, dict]:
    """The product path of ``bench.py:product_bench`` without the writer:
    ``run_inference`` of ``n_steps`` steps in windows of ``window`` over a
    ``SyntheticTimeSeries`` of the state, forcing and mask names that is
    ``window`` frames long (aligned: every window hits one read-cache and one
    upload-cache entry), looped ``n_steps // window + 2`` times, with an
    ``InferenceAggregator`` over the output names (zonal means off, as the
    10-year config sets them). One untimed warm-up window runs first (the
    K1 weight images, cuBLAS and the allocator), then ``before_timed`` if
    given (``chip_smoke.py`` zeroes the kernels' launch counts there). Runs
    on the stepper's device; returns (the timed run's summary, its
    aggregator's logs)."""
    exp = stepper.exp
    names = list(exp.out_packer.names)
    src = SyntheticTimeSeries(list(exp.in_packer.names) + list(exp.forcing_names) + [MASK_NAME],
                              n_timesteps=window, spatial_shape=exp.model.cfg.img_shape)

    def aggregator():
        return InferenceAggregator(names, src.horizontal.area_weights(),
                                   log_zonal_mean_images=False)

    run_inference(stepper, src,
                  InferenceConfig(n_forward_steps=window, forward_steps_in_memory=window,
                                  n_ensemble=n_ensemble, n_repeats=3),
                  aggregator=aggregator(), mask_name=MASK_NAME, verbose=False)
    if before_timed is not None:
        before_timed()
    agg = aggregator()
    cfg = InferenceConfig(n_forward_steps=n_steps, forward_steps_in_memory=window,
                          n_ensemble=n_ensemble, n_repeats=n_steps // window + 2)
    summary = run_inference(stepper, src, cfg, aggregator=agg, mask_name=MASK_NAME,
                            verbose=False)
    return summary, agg.get_logs()


def build_training(embed: int = 256, layers: int = 8, img_shape: Tuple[int, int] = (180, 360),
                   horizon: int = 6, n_state: int = 35, use_pallas: bool = True,
                   dropout: bool = True, n_samples: int = 8, scheduler: str = "warmup_cosine",
                   scan_layers: bool = False, checkpointing: int = 0,
                   forward_conditioning: str = "none", dtype: str = "float32",
                   forecaster: bool = True, device: str = "cuda") -> Dict[str, Trainer]:
    """The two trainers of the training path, ``{"interpolator": ...,
    "forecaster": ...}`` (the interpolator's alone with ``forecaster=False``), over one ``DebugDataModule`` (``n_state`` state
    channels, two forcings, ``n_samples`` samples of batch 1): the
    interpolator (72 -> 35 channels, MLP dropout and DropPath 0.1 with
    ``dropout``) and the forecaster (37 -> 35) of ``fv3gfs_interpolation``
    and ``fv3gfs_dyffusion``, ``dtype`` compute (float32, or bfloat16 with
    the transforms' operands in bf16 as ``build`` sets them; K1 takes
    float32 either way), weights from a ``torch.Generator`` seeded with 0;
    the forecaster's loss runs the interpolator frozen.
    ``dropout=False`` turns the interpolator's dropout off in both losses.
    ``scan_layers`` and ``checkpointing`` (remat from 3) are the SFNO
    fields of both networks. ``forward_conditioning`` is DYffusion's; other
    than "none" the forecaster gets the ``n_state`` condition channels that
    its forecasts feed it (for "data+noise-*" too, where the JAX package's
    experiment builder leaves them out: ROADMAP Queue 3)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    dm = DebugDataModule(channels=n_state, height=img_shape[0], width=img_shape[1],
                         horizon=horizon, n_forcing=len(FORCING_NAMES), batch_size=1,
                         n_timesteps=horizon + n_samples, seed=0)
    icfg, fcfg = sfno_configs(embed, layers, dtype, img_shape, horizon, n_state,
                              use_pallas=use_pallas, fused_mlp=False, scan_layers=scan_layers,
                              checkpointing=checkpointing)
    if not dropout:
        icfg = dataclasses.replace(icfg, dropout_mlp=0.0, drop_path_rate=0.0)
    if forward_conditioning != "none":
        fcfg = dataclasses.replace(fcfg, in_chans=fcfg.in_chans + n_state)
    imodel = SFNO(icfg).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    imodel.init_weights(gen)
    interp = InterpolationExperiment(
        imodel, ExperimentConfig(horizon=horizon, enable_inference_dropout=True),
        dm.in_packer, dm.out_packer, dm.normalizer)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=n_samples, scheduler=scheduler)
    if not forecaster:
        return {"interpolator": Trainer(interp, dm, tcfg)}
    fmodel = SFNO(fcfg).to(device)
    fmodel.init_weights(gen)
    dcfg = DYffusionConfig(timesteps=horizon, forward_conditioning=forward_conditioning,
                           time_encoding="dynamics")
    fexp = DYffusionForecastingExperiment(
        fmodel, interp, dcfg, ExperimentConfig(horizon=horizon), dm.in_packer, dm.out_packer,
        dm.normalizer, forcing_names=dm.cfg.forcing_names,
        forcing_normalizer=dm.forcing_normalizer)
    return {"interpolator": Trainer(interp, dm, tcfg), "forecaster": Trainer(fexp, dm, tcfg)}


def train_steps(n_steps: int = 6, embed: int = 256, layers: int = 8,
                img_shape: Tuple[int, int] = (180, 360), horizon: int = 6, n_state: int = 35,
                repeat: bool = False, device: str = "cuda",
                trainers: Optional[Dict[str, Trainer]] = None) -> Dict[str, dict]:
    """``n_steps`` training steps of the interpolator, then of the
    forecaster, through ``Trainer.train_step`` (``build_training``'s
    trainers unless ``trainers`` is given). The batches are read first (set
    up), ``n_steps`` distinct ones, or the first one every step with
    ``repeat``. Per experiment it returns the per-step ``losses`` and
    ``grad_norms`` (before clipping), ``step_ms``
    (host clock to the end-synced step), ``split_ms`` (forward, backward,
    optimizer and EMA per step: CUDA events recorded between the parts on
    the card, the host clock on the CPU), ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` over the steps; None on the CPU), and
    per step the K1 launches (``k1_launches``; ``k1_backward``: those made
    in the backward, which under remat include the recompute's forwards;
    ``k1_dx``: the backward's dx products) and K1 weight images made
    (``k1_images``), with the ``trainer`` and its ``state``."""
    if trainers is None:
        trainers = build_training(embed, layers, img_shape, horizon, n_state,
                                  n_samples=max(n_steps, 1), device=device)
    out = {}
    for name, tr in trainers.items():
        cuda = tr.device.type == "cuda"
        batches = [b for _, b in zip(range(n_steps), tr.dm.train_batches(seed=0))]
        if repeat:
            batches = [batches[0]] * n_steps
        state = tr.init_state()
        gen = torch.Generator().manual_seed(1)
        rec = {k: [] for k in ("losses", "step_ms", "split_ms", "k1_launches", "k1_backward",
                               "k1_dx", "k1_images")}
        if cuda:
            torch.cuda.synchronize(tr.device)
            torch.cuda.reset_peak_memory_stats(tr.device)
        metrics = []
        for batch in batches:
            marks = []

            def mark(part, marks=marks):
                if cuda:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    marks.append((part, ev, dhconv.launches))
                else:
                    marks.append((part, time.perf_counter(), dhconv.launches))

            dhconv.launches = dhconv.dx_launches = dhconv_weight_image.launches = 0
            t0 = time.perf_counter()
            mark("start")
            dyn, cond, rt = tr.upload(batch)
            metrics.append(tr.train_step(state, dyn, cond, gen, rt, mark=mark))
            if cuda:
                torch.cuda.synchronize(tr.device)
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["k1_launches"].append(dhconv.launches)
            rec["k1_dx"].append(dhconv.dx_launches)
            rec["k1_images"].append(dhconv_weight_image.launches)
            rec["split_ms"].append({
                part: (a.elapsed_time(b) if cuda else (b - a) * 1e3)
                for (_, a, _), (part, b, _) in zip(marks, marks[1:])})
            rec["k1_backward"].append(marks[2][2] - marks[1][2])
        rec["losses"] = [float(m["loss"]) for m in metrics]
        rec["grad_norms"] = [float(m["grad_norm"]) for m in metrics]
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(tr.device) if cuda else None
        rec.update(trainer=tr, state=state)
        out[name] = rec
    return out


def fused_epoch(n_steps: int = 8, embed: int = 256, layers: int = 8,
                img_shape: Tuple[int, int] = (180, 360), horizon: int = 6, n_state: int = 35,
                device: str = "cuda", trainer: Optional[Trainer] = None) -> dict:
    """One ``fit_in_memory`` epoch of the interpolator (``bench.py:459-467``):
    batch 1, ``n_steps`` steps over a dataset of ``n_steps`` samples uploaded
    once, validation beyond the epoch; ``build_training``'s interpolator
    trainer unless ``trainer`` is given. Returns the epoch's ``wall_s``
    (host clock, from the call to the epoch's end read), ``steps``, the
    per-step ``losses``, ``step_ms`` per step (CUDA events recorded after
    each step's work is queued, the host clock on the CPU; the first step
    from the epoch's start), the dataset's ``upload_bytes``,
    ``upload_host_s`` (reading, stacking, pinning) and ``upload_copy_s``
    (its copy to the device), and the ``trainer``."""
    if trainer is None:
        trainer = build_training(embed, layers, img_shape, horizon, n_state,
                                 n_samples=n_steps, forecaster=False,
                                 device=device)["interpolator"]
    cuda = trainer.device.type == "cuda"
    marks = []

    def stamp():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    def mark(part):
        if part == "optimizer":  # a step's end
            stamp()

    t0 = time.perf_counter()
    stamp()
    hist = trainer.fit_in_memory(epochs=1, val_every=2, verbose=False, steps_per_epoch=n_steps,
                                 mark=mark)
    wall = time.perf_counter() - t0
    step_ms = [(a.elapsed_time(b) if cuda else (b - a) * 1e3) for a, b in zip(marks, marks[1:])]
    up = hist["upload"]
    return dict(wall_s=wall, steps=len(hist["step_losses"]), losses=hist["step_losses"],
                step_ms=step_ms, upload_bytes=up["bytes"], upload_host_s=up["host_s"],
                upload_copy_s=up["copy_s"], trainer=trainer)
