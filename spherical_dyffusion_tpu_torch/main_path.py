"""The port's main path: the DYffusion window rollout of ``bench.py:build()``.

Builds the same system as the JAX package's benchmark builder, with the
configuration written here in Python (no YAML): two SFNOs at 180 x 360 with
a time embedding, bf16 compute with the transforms and spectral products
rounding their operands to bf16 (``sht_matmul_dtype=dtype``, as
``bench.py:build()`` sets it; ``dtype`` may be float32, bfloat16 or
float16), the interpolator (72 -> 35 channels) with MLP
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
and peel on, no fused MLP) with K4 on, ``FAST_WINDOW_F16`` the same in
float16 (``dtype="float16"``, float16 spectral IO, K4's float16 instance),
and ``TUCKER_WINDOW`` its compose
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

``product_rollout`` is the product path of ``bench.py:product_bench``:
``run_inference`` over an aligned ``SyntheticTimeSeries`` with the
``InferenceAggregator`` reducing on the card, and with ``writer_dir`` the
prediction writer that ``product_bench`` runs by default.

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

``ace_rollout`` is the port's counterpart of ``bench.py:ace_bench``
(``BENCH_ACE=1``), the paper's ACE baseline: ``build_ace``'s single-step
stepper (an SFNO at embed 256 x 8 with the dense dhconv, no time embedding,
36 -> 35 channels on 180 x 360; ace_bench's names, normalizer, sigma, data
recipe (``AceBenchSource``), dry-air corrector and prescribed ocean) rolled
out by ``run_ace_inference`` with the aggregator on; ``kernels`` routes the
dhconv through K1 and each block's tail through K3 (norm1's affine alone).
``simultaneous_steps`` trains the simultaneous forecaster (the ACE-style
training baseline) through ``Trainer.train_step`` at the same width.

``build_unet``, ``unet_window`` and ``unet_train_steps`` run the same
DYffusion window and training with the UNet backbone at the published
width of ``configs/model/unet.json`` (dim 64, ``dim_mults`` (1, 2, 4, 8),
dropouts 0.1, bilinear outer resampling 180 x 360 -> 184 x 368), batch 1,
float32. The UNet has no hand-written kernel: every kernel launch of these
paths is cuDNN's, cuBLAS's or PyTorch's own.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .data.datamodule import DebugDataModule
from .data.datasets import SyntheticTimeSeries
from .data.coords import HorizontalCoordinates, SigmaCoordinates
from .data.datasets import TimeSeriesSource
from .data.normalization import StandardNormalizer
from .data.packer import Packer
from .diffusion.dyffusion import DYffusionConfig
from .evaluation.aggregators import InferenceAggregator
from .evaluation.metrics import spherical_area_weights
from .inference.ace_stepper import (
    SingleStepStepper,
    SingleStepStepperConfig,
    ace_scored_names,
    run_ace_inference,
)
from .inference.corrector import CorrectorConfig
from .inference.loop import InferenceConfig, run_inference
from .inference.ocean import OceanConfig, SlabOceanConfig
from .inference.prescriber import PrescriberConfig
from .inference.stepper import DYffusionStepper
from .inference.writers import DataWriter, DataWriterConfig
from .models.sfno import SFNO, SFNOConfig
from .models.unet import UNet, UNetConfig
from .parallel.mesh import Mesh
from .ops.pallas_contractions import dhconv, dhconv_weight_grad, dhconv_weight_image
from .training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
    SimultaneousForecastingExperiment,
)
from .training.trainer import Trainer, TrainerConfig
from .utils.convert import flax_to_state_dict

__all__ = ["state_names", "FORCING_NAMES", "MASK_NAME", "FAST_WINDOW", "FAST_WINDOW_F16",
           "TUCKER_WINDOW",
           "sfno_configs",
           "build", "window_inputs", "product_rollout", "build_training", "train_steps",
           "fused_epoch", "ace_names", "SLAB_FLUXES", "SLAB_FIELDS", "AceBenchSource",
           "build_ace", "ace_rollout", "build_simultaneous", "simultaneous_steps",
           "unet_configs", "build_unet", "unet_window", "unet_train_steps"]

FORCING_NAMES = ("DSWRFtoa", "HGTsfc")
MASK_NAME = "ocean_fraction"
# bench.py's fast product compose (BENCH_FACT=cp BENCH_RANK=0.25
# BENCH_THRESH=0.8 BENCH_SPECTRAL_IO=bfloat16, scan and peel on), with the
# rank pipeline's spectral middle on K4; build(**FAST_WINDOW, fused_rank=False)
# is its plain path
FAST_WINDOW = dict(use_pallas=False, fused_mlp=False, fused_tail=False, factorization="cp",
                   rank=0.25, thresh=0.8, spectral_io="bfloat16", scan_layers=True,
                   peel=True, fused_rank=True)
# the same compose in float16: build(dtype="float16", **FAST_WINDOW_F16) runs
# the compute, the transforms' operands and the spectral IO in float16, with
# K4's float16 instance
FAST_WINDOW_F16 = dict(FAST_WINDOW, spectral_io="float16")
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
          ema_params: Optional[Mapping] = None, mesh: Optional[Mesh] = None) -> DYffusionStepper:
    """The window stepper of the main path.

    ``flax_params``: optional ``{"interpolator": ..., "forecaster": ...}``
    JAX-package variable trees; otherwise weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. ``ema_params``
    (a flax tree or a ``state_dict``) turns on ``use_ema_params``: the
    forecaster runs its EMA weights, as the 10-year config's ``use_ema``.
    ``mesh``: the stepper's process mesh (``parallel/mesh.py``; rows over
    "data", the grid over "h" and "w")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
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
    return _window_stepper(imodel, fmodel, horizon, n_state, peel, enable_interpolator_dropout,
                           params_dtype=params_dtype, preds_dtype=preds_dtype,
                           ema_params=ema_params, mesh=mesh)


def _window_stepper(imodel, fmodel, horizon: int, n_state: int, peel: bool = False,
                    enable_interpolator_dropout: bool = True, **stepper_kw) -> DYffusionStepper:
    """The main path's experiments and stepper around two networks: unit
    statistics, DYffusion at ``horizon`` (``forward_conditioning="none"``,
    ``time_encoding="dynamics"``), the SST prescriber; ``stepper_kw`` go to
    ``DYffusionStepper`` (``mesh`` among them)."""
    names = state_names(n_state)
    unit = StandardNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names},
                                         names)
    funit = StandardNormalizer.from_dicts({n: 0.0 for n in FORCING_NAMES},
                                          {n: 1.0 for n in FORCING_NAMES}, FORCING_NAMES)
    packer = Packer(names)
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
    ema_params = stepper_kw.pop("ema_params", None)
    return DYffusionStepper(exp, prescriber=prescriber, use_ema_params=ema_params is not None,
                            ema_params=ema_params, **stepper_kw)


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
                    before_timed: Optional[Callable[[], None]] = None,
                    writer_dir: Optional[str] = None
                    ) -> Tuple[dict, InferenceAggregator]:
    """The product path of ``bench.py:product_bench``: ``run_inference`` of
    ``n_steps`` steps in windows of ``window`` over a ``SyntheticTimeSeries``
    of the state, forcing and mask names that is ``window`` frames long
    (aligned: every window hits one read-cache and one upload-cache entry),
    looped ``n_steps // window + 2`` times, with an ``InferenceAggregator``
    over the output names (zonal means off, as the 10-year config sets
    them). With ``writer_dir`` the timed run also writes the predictions,
    as ``product_bench`` does by default: a
    ``DataWriter(DataWriterConfig(save_prediction_files=True))`` into
    ``writer_dir`` (``autoregressive_predictions.nc``), closed after the
    rollout (aborted if it fails), and the summary gains ``writer_close_s`` (the index and the
    headers) and ``writer_bytes`` (the file's size); without it there is no
    writer (``BENCH_WRITER=0``). One untimed warm-up window runs first (the
    K1 weight images, cuBLAS and the allocator), then ``before_timed`` if
    given (``chip_smoke.py`` zeroes the kernels' launch counts there). Runs
    on the stepper's device; returns (the timed run's summary, its
    aggregator), and reads nothing from the card."""
    exp = stepper.exp
    names = list(exp.out_packer.names)
    src = SyntheticTimeSeries(list(exp.in_packer.names) + list(exp.forcing_names) + [MASK_NAME],
                              n_timesteps=window, spatial_shape=exp.model.cfg.img_shape)

    def new_aggregator():
        return InferenceAggregator(names, src.horizontal.area_weights(),
                                   log_zonal_mean_images=False)

    run_inference(stepper, src,
                  InferenceConfig(n_forward_steps=window, forward_steps_in_memory=window,
                                  n_ensemble=n_ensemble, n_repeats=3),
                  aggregator=new_aggregator(), mask_name=MASK_NAME, verbose=False)
    if before_timed is not None:
        before_timed()
    agg = new_aggregator()
    cfg = InferenceConfig(n_forward_steps=n_steps, forward_steps_in_memory=window,
                          n_ensemble=n_ensemble, n_repeats=n_steps // window + 2)
    writer = None
    if writer_dir is not None:
        writer = DataWriter(DataWriterConfig(save_prediction_files=True), writer_dir, names,
                            src.horizontal.lat, src.horizontal.lon, n_ensemble)
    try:
        summary = run_inference(stepper, src, cfg, aggregator=agg, writer=writer,
                                mask_name=MASK_NAME, verbose=False)
    except BaseException:
        if writer is not None:
            writer.abort()
        raise
    if writer is not None:
        t0 = time.perf_counter()
        writer.close()
        summary["writer_close_s"] = time.perf_counter() - t0
        summary["writer_bytes"] = os.path.getsize(
            os.path.join(writer_dir, "autoregressive_predictions.nc"))
    return summary, agg


def build_training(embed: int = 256, layers: int = 8, img_shape: Tuple[int, int] = (180, 360),
                   horizon: int = 6, n_state: int = 35, use_pallas: bool = True,
                   dropout: bool = True, n_samples: int = 8, scheduler: str = "warmup_cosine",
                   scan_layers: bool = False, checkpointing: int = 0,
                   forward_conditioning: str = "none", dtype: str = "float32",
                   forecaster: bool = True, device: str = "cuda",
                   unet: Optional[Mapping] = None) -> Dict[str, Trainer]:
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
    experiment builder leaves them out: ROADMAP Queue 3). ``unet`` (keyword
    arguments of ``unet_configs``) builds both networks as UNets instead;
    ``dropout=False`` then turns their dropouts off."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    dm = DebugDataModule(channels=n_state, height=img_shape[0], width=img_shape[1],
                         horizon=horizon, n_forcing=len(FORCING_NAMES), batch_size=1,
                         n_timesteps=horizon + n_samples, seed=0)
    if unet is not None:
        icfg, fcfg = unet_configs(img_shape, n_state, **dict(
            unet, **({} if dropout else {"dropout": 0.0})))
        net = UNet
    else:
        icfg, fcfg = sfno_configs(embed, layers, dtype, img_shape, horizon, n_state,
                                  use_pallas=use_pallas, fused_mlp=False,
                                  scan_layers=scan_layers, checkpointing=checkpointing)
        if not dropout:
            icfg = dataclasses.replace(icfg, dropout_mlp=0.0, drop_path_rate=0.0)
        net = SFNO
    if forward_conditioning != "none":
        fcfg = dataclasses.replace(fcfg, in_chans=fcfg.in_chans + n_state)
    imodel = net(icfg).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    imodel.init_weights(gen)
    interp = InterpolationExperiment(
        imodel, ExperimentConfig(horizon=horizon, enable_inference_dropout=True),
        dm.in_packer, dm.out_packer, dm.normalizer)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=n_samples, scheduler=scheduler)
    if not forecaster:
        return {"interpolator": Trainer(interp, dm, tcfg)}
    fmodel = net(fcfg).to(device)
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
    ``k1_dx``: the backward's dx products), the weight-gradient kernel's
    launches (``k1_dw``) and K1 weight images made (``k1_images``), with the
    ``trainer`` and its ``state``."""
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
                               "k1_dx", "k1_dw", "k1_images")}
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
            dhconv_weight_grad.launches = 0
            t0 = time.perf_counter()
            mark("start")
            dyn, cond, rt = tr.upload(batch)
            metrics.append(tr.train_step(state, dyn, cond, gen, rt, mark=mark))
            if cuda:
                torch.cuda.synchronize(tr.device)
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["k1_launches"].append(dhconv.launches)
            rec["k1_dx"].append(dhconv.dx_launches)
            rec["k1_dw"].append(dhconv_weight_grad.launches)
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



# ---------------------------------------------------------------------------
# the ACE family: bench.py:ace_bench, and the simultaneous forecaster
# ---------------------------------------------------------------------------


# the slab ocean's inputs: the six surface energy fluxes of
# ClimateData.net_surface_energy_flux_without_frozen_precip (W m-2), which the
# network predicts, and the mixed-layer depth (m) and Q-flux (W m-2) it reads
# from the data; each with a mean and spread of realistic size
SLAB_FLUXES = ("DLWRFsfc", "ULWRFsfc", "DSWRFsfc", "USWRFsfc", "LHTFLsfc", "SHTFLsfc")
SLAB_FIELDS = ("mixed_layer_depth", "q_flux")
_SLAB_STATS = {"DLWRFsfc": (350.0, 50.0), "ULWRFsfc": (400.0, 50.0),
               "DSWRFsfc": (200.0, 100.0), "USWRFsfc": (30.0, 20.0),
               "LHTFLsfc": (80.0, 40.0), "SHTFLsfc": (15.0, 10.0),
               "mixed_layer_depth": (50.0, 20.0), "q_flux": (0.0, 30.0)}


def ace_names(levels: int = 8, n_other: int = 25,
              slab: bool = False) -> Tuple[list, list, list]:
    """ace_bench's (in_names, out_names, all_names): the surface pressure,
    the surface temperature, ``levels`` water levels and ``n_other`` more
    prognostics (35 at the defaults); the forcing ``DSWRFtoa``; the mask
    ``ocean_fraction``. With ``slab`` the first six of the other prognostics
    are the surface fluxes the slab ocean reads (``SLAB_FLUXES``; ``n_other``
    at least 6) and all_names ends with its data fields (``SLAB_FIELDS``)."""
    other = [f"v{i}" for i in range(n_other)]
    if slab:
        if n_other < len(SLAB_FLUXES):
            raise ValueError(f"the slab ocean's six fluxes need n_other >= 6, got {n_other}")
        other[:len(SLAB_FLUXES)] = SLAB_FLUXES
    out = (["PRESsfc", "surface_temperature"]
           + [f"specific_total_water_{k}" for k in range(levels)] + other)
    inp = out + ["DSWRFtoa"]
    return inp, out, inp + [MASK_NAME] + (list(SLAB_FIELDS) if slab else [])


def _ace_mean(n: str) -> float:
    # realistic magnitudes: water about 1e-3 keeps the dry-air denominator
    # 1 - sum(bk_diff * q) away from zero under an untrained network
    if n in _SLAB_STATS:
        return _SLAB_STATS[n][0]
    return 1e5 if n == "PRESsfc" else 1e-3 if "water" in n else 1.0


def _ace_std(n: str) -> float:
    if n in _SLAB_STATS:
        return _SLAB_STATS[n][1]
    return 1e3 if n == "PRESsfc" else 1e-4 if "water" in n else 0.5


class AceBenchSource(TimeSeriesSource):
    """ace_bench's data recipe as a source of ``n_timesteps`` frames, made in
    bulk from ``seed``: |N(0, 1)| + 1 for every name in order, then the
    surface pressure 1e5 + 1e3 x, water 1e-3 x, and the mask x > 1.8. With
    ``n_timesteps = window + 1`` the frames are ace_bench's window. The slab
    ocean's fluxes and fields (``SLAB_FLUXES``, ``SLAB_FIELDS``) are their
    mean + spread (x - 2): a mixed layer 30 m deep or more."""

    def __init__(self, names, n_timesteps: int, spatial_shape: Tuple[int, int] = (180, 360),
                 seed: int = 0):
        self.names = list(names)
        self.n_timesteps = n_timesteps
        self.spatial_shape = tuple(spatial_shape)
        rng = np.random.default_rng(seed)
        self._data = {}
        for n in self.names:
            x = np.abs(rng.standard_normal((n_timesteps,) + self.spatial_shape,
                                           np.float32)) + 1.0
            if n == "PRESsfc":
                x = 1e5 + 1e3 * x
            elif "water" in n:
                x = 1e-3 * x
            elif n == MASK_NAME:
                x = x > 1.8
            elif n in _SLAB_STATS:
                mean, spread = _SLAB_STATS[n]
                x = mean + spread * (x - 2.0)
            self._data[n] = x.astype(np.float32)

    @property
    def horizontal(self) -> HorizontalCoordinates:
        return HorizontalCoordinates.regular(*self.spatial_shape)

    def read_window(self, start: int, length: int, names) -> Dict[str, np.ndarray]:
        return {n: self._data[n][start:start + length] for n in names}


def build_ace(embed: int = 256, layers: int = 8, dtype: str = "bfloat16",
              img_shape: Tuple[int, int] = (180, 360), levels: int = 8, n_other: int = 25,
              kernels: bool = True, exact: bool = False, slab: bool = False,
              device: str = "cuda") -> SingleStepStepper:
    """ace_bench's stepper: the SFNO (dense dhconv, ``dtype`` compute with the
    transforms' operands in ``dtype``, no time embedding) with weights from
    a ``torch.Generator`` seeded with 0 on ``device``, the dry-air
    corrector, the prescribed ocean, ak = linspace(0, 100, K + 1) and bk =
    linspace(0, 1, K + 1), ace_bench's normalizer. ``kernels`` sets
    ``use_pallas`` and ``fused_tail`` (K1 and K3); ``exact`` takes erf gelu
    and two-pass norm statistics, which ``interface.load_ace_stepper_checkpoint``
    builds for every ACE checkpoint. ``slab`` takes ``ace_names(slab=True)``
    and the slab ocean over ``SLAB_FIELDS`` in place of the prescribed one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    in_names, out_names, all_names = ace_names(levels, n_other, slab)
    H, W = img_shape
    model = SFNO(SFNOConfig(
        img_shape=img_shape, in_chans=len(in_names), out_chans=len(out_names),
        embed_dim=embed, num_layers=layers, operator_type="dhconv", data_grid="equiangular",
        compute_dtype=dtype, sht_matmul_dtype=dtype, use_pallas=kernels, fused_tail=kernels,
        activation_function="gelu_exact" if exact else "gelu", exact_norm=exact)).to(device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    model.eval()

    def model_fn(x_norm: torch.Tensor) -> torch.Tensor:
        return model(x_norm, deterministic=True)

    norm = StandardNormalizer.from_dicts({n: _ace_mean(n) for n in all_names},
                                         {n: _ace_std(n) for n in all_names}, all_names)
    sigma = SigmaCoordinates(ak=np.linspace(0.0, 100.0, levels + 1),
                             bk=np.linspace(0.0, 1.0, levels + 1))
    cfg = SingleStepStepperConfig(in_names=in_names, out_names=out_names,
                                  corrector=CorrectorConfig(conserve_dry_air=True),
                                  ocean=OceanConfig("surface_temperature", MASK_NAME,
                                                    slab=SlabOceanConfig(*SLAB_FIELDS)
                                                    if slab else None))
    area = spherical_area_weights(np.linspace(-89.5, 89.5, H), W)
    return SingleStepStepper(cfg, model_fn, norm, area, sigma, device=device, module=model)


def ace_rollout(n_steps: int = 48, window: int = 12, dtype: str = "bfloat16",
                kernels: bool = True, before_timed: Optional[Callable[[], None]] = None,
                device: str = "cuda", **size) -> dict:
    """``bench.py:ace_bench`` through the port's entry point:
    ``build_ace(dtype=dtype, kernels=kernels, **size)``, one untimed warm-up
    window (the K1 weight images, cuBLAS, the allocator), then
    ``before_timed`` if given, then ``run_ace_inference`` of ``n_steps`` in
    windows of ``window`` over an ``AceBenchSource`` of ``2 * window``
    frames (the rollout loops it, so the later windows hit the upload
    cache), with an ``InferenceAggregator`` over ``ace_scored_names`` and
    the diagnostics. Returns ``summary``, ``window_seconds`` (each window's
    seconds on the device), ``gen`` (the last window's generated fields,
    initial state first), ``logs``, ``stepper`` and ``source``."""
    stepper = build_ace(dtype=dtype, kernels=kernels, device=device, **size)
    n_timesteps = 2 * window
    src = AceBenchSource(stepper.cfg.all_names, n_timesteps, tuple(stepper.area.shape))
    run_ace_inference(stepper, src, window, window, verbose=False)
    if before_timed is not None:
        before_timed()
    agg = InferenceAggregator(ace_scored_names(stepper, src, derived=True),
                              src.horizontal.area_weights(), log_zonal_mean_images=False)
    last = {}
    summary = run_ace_inference(
        stepper, src, n_steps, window, n_repeats=-(-(n_steps + 1) // n_timesteps),
        aggregator=agg, derived=True, verbose=False,
        on_window=lambda start, out: last.update(gen=out.gen_data))
    return dict(summary=summary, window_seconds=summary["window_seconds"], gen=last["gen"],
                logs=agg.get_logs(), stepper=stepper, source=src)


def build_simultaneous(embed: int = 256, layers: int = 8,
                       img_shape: Tuple[int, int] = (180, 360), horizon: int = 2,
                       horizon_at_once: int = 1, n_state: int = 35, use_pallas: bool = True,
                       n_samples: int = 8, scheduler: str = "warmup_cosine",
                       dtype: str = "float32", device: str = "cuda") -> Trainer:
    """The trainer of the simultaneous forecaster over a ``DebugDataModule``
    of ``build_training``'s data (``n_state`` state channels, two forcings,
    ``n_samples`` samples of batch 1) at ``horizon``: an SFNO of ``window *
    C + CF`` -> ``horizon_at_once * C`` channels (dense dhconv, no time
    embedding, K1 with ``use_pallas``) with weights from a
    ``torch.Generator`` seeded with 0, the trainer settings of
    ``build_training``. ``dtype`` is the model config's ``compute_dtype``
    and the transforms' ``sht_matmul_dtype`` (float32, bfloat16 or
    float16), as ``build`` sets them; K1 takes float32 either way."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    dm = DebugDataModule(channels=n_state, height=img_shape[0], width=img_shape[1],
                         horizon=horizon, n_forcing=len(FORCING_NAMES), batch_size=1,
                         n_timesteps=horizon + n_samples, seed=0)
    C, CF = n_state, len(FORCING_NAMES)
    model = SFNO(SFNOConfig(img_shape=img_shape, in_chans=C + CF,
                            out_chans=horizon_at_once * C, embed_dim=embed, num_layers=layers,
                            operator_type="dhconv", data_grid="equiangular",
                            compute_dtype=dtype, sht_matmul_dtype=dtype,
                            use_pallas=use_pallas)).to(device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    exp = SimultaneousForecastingExperiment(
        model, ExperimentConfig(horizon=horizon), dm.in_packer, dm.out_packer, dm.normalizer,
        horizon_at_once=horizon_at_once, forcing_names=dm.cfg.forcing_names,
        forcing_normalizer=dm.forcing_normalizer)
    return Trainer(exp, dm, TrainerConfig(epochs=1, steps_per_epoch=n_samples,
                                          scheduler=scheduler))


def simultaneous_steps(n_steps: int = 3, horizon: int = 2, horizon_at_once: int = 1,
                       device: str = "cuda", **size) -> dict:
    """``n_steps`` training steps of ``build_simultaneous``'s trainer through
    ``train_steps``: the per-step losses, ``step_ms``, ``split_ms``,
    ``peak_bytes`` and K1 counts of ``train_steps``."""
    trainer = build_simultaneous(horizon=horizon, horizon_at_once=horizon_at_once,
                                 n_samples=max(n_steps, 1), device=device, **size)
    return train_steps(n_steps, trainers={"simultaneous": trainer})["simultaneous"]


# ---------------------------------------------------------------------------
# the UNet backbone at its published width (configs/model/unet.json)
# ---------------------------------------------------------------------------


def unet_configs(img_shape: Tuple[int, int] = (180, 360), n_state: int = 35, dim: int = 64,
                 dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
                 upsample_dims: Optional[Tuple[int, int]] = (184, 368),
                 dropout: float = 0.1) -> Tuple[UNetConfig, UNetConfig]:
    """(interpolator, forecaster) UNet configs with ``build``'s channels
    (2C + CF -> C and C + CF -> C) and ``configs/model/unet.json``'s
    settings: ``dim``, ``dim_mults``, every dropout at ``dropout``, bilinear
    outer resampling to ``upsample_dims`` (None: no resampling)."""
    C, CF = n_state, len(FORCING_NAMES)
    common = dict(img_shape=tuple(img_shape), out_chans=C, dim=dim,
                  dim_mults=tuple(dim_mults), with_time_emb=True, block_dropout=dropout,
                  block_dropout1=dropout, attn_dropout=dropout, input_dropout=0.0,
                  outer_sample_mode="bilinear" if upsample_dims else None,
                  upsample_dims=tuple(upsample_dims) if upsample_dims else None)
    return UNetConfig(in_chans=2 * C + CF, **common), UNetConfig(in_chans=C + CF, **common)


def build_unet(img_shape: Tuple[int, int] = (180, 360), n_state: int = 35, dim: int = 64,
               dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
               upsample_dims: Optional[Tuple[int, int]] = (184, 368),
               device: str = "cuda", mesh: Optional[Mesh] = None) -> DYffusionStepper:
    """``build``'s window stepper at horizon 6 with UNet interpolator and
    forecaster (``unet_configs``, every dropout 0.1), float32, weights from
    a ``torch.Generator`` seeded with 0 on ``device``; the interpolator's
    dropout live at inference; ``mesh`` as ``build``'s. Raises without CUDA
    unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("main path: CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    icfg, fcfg = unet_configs(img_shape, n_state, dim, dim_mults, upsample_dims)
    imodel, fmodel = UNet(icfg).to(device), UNet(fcfg).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    imodel.init_weights(gen)
    fmodel.init_weights(gen)
    return _window_stepper(imodel, fmodel, 6, n_state, mesh=mesh)


def unet_window(stepper: DYffusionStepper, n_steps: int = 12) -> dict:
    """One ``n_steps`` window of ``stepper`` (``build_unet``'s) from
    ``window_inputs`` on its device, after one untimed warm-up window:
    ``seconds`` (host clock to the synced end), ``steps_per_s``, the
    network forwards counted by forward hooks (``forwards``:
    ``{"interpolator": n, "forecaster": n}``), the final state and the
    predictions."""
    exp = stepper.exp
    dev = next(exp.model.parameters()).device
    img_shape = tuple(exp.model.cfg.img_shape)
    inp = window_inputs(n_steps, img_shape, len(exp.in_packer.names), device=dev)
    args = (inp["x0"], inp["forcing"], inp["sst"], inp["mask"])
    stepper.run_window(*args, torch.Generator().manual_seed(0), n_steps)
    counts = {"interpolator": 0, "forecaster": 0}
    hooks = [net.register_forward_hook(lambda *a, k=k: counts.__setitem__(k, counts[k] + 1))
             for k, net in (("interpolator", exp.interpolator.model), ("forecaster", exp.model))]
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, preds = stepper.run_window(*args, torch.Generator().manual_seed(1), n_steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    return dict(seconds=seconds, steps_per_s=n_steps / seconds, forwards=counts, state=x,
                preds=preds)


def unet_train_steps(n_steps: int = 3, img_shape: Tuple[int, int] = (180, 360),
                     n_state: int = 35, device: str = "cuda", **unet) -> Dict[str, dict]:
    """``n_steps`` training steps of the interpolation and the DYffusion
    experiments on ``build_training``'s data with UNet networks
    (``unet_configs(**unet)``), through ``train_steps``: per experiment the
    losses, ``step_ms``, ``split_ms`` and ``peak_bytes``."""
    trainers = build_training(img_shape=img_shape, n_state=n_state,
                              n_samples=max(n_steps, 1), device=device, unet=unet)
    return train_steps(n_steps, trainers=trainers)
