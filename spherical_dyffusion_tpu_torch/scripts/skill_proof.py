"""Skill proof: train the two-stage DYffusion pipeline on learnable
stochastic spherical dynamics and score its forecasts, on the port.

Counterpart of the JAX package's ``scripts/skill_proof.py``, with its
presets, arguments and defaults. The system
(``data/datasets.py:StochasticModalTimeSeries``, or with ``--system
chaotic`` ``ChaoticModalTimeSeries``) is a solid-body rotation plus modal
noise, so the deterministic part is exactly learnable and the OU system's
conditional spread has a closed form. Four stages:

1. the interpolator (MLP dropout live at inference) trained by
   ``Trainer.fit_in_memory`` (``--fused``, the default) or ``fit``, EMA on,
   seed 0; its validation against climatology (the time mean of the first
   256 training frames) and linear interpolation between the two
   conditioning frames;
2. the DYffusion forecaster trained with that interpolator frozen
   (``forward_conditioning="data"``), seed 1;
3. per-horizon ensembles over ``eval_batches`` validation batches, cold
   against naive sampling: ensemble-mean RMSE, CRPS, SSR, persistence and
   climatology, with ``--inputs-noise`` per member, members tiled along the
   batch in chunks of ``ens_chunk``; the SSR calibration gate ([0.8, 1.15]
   at every horizon), the OU system's analytic spread and the chaotic
   system's perturbation growth;
4. the rollout's stability: ``DYffusionStepper.run_window`` in segments of
   ``12 * horizon`` steps (the inputs noise on the first only), finite and
   within 3 x the data's own max.

The dense dhconv runs through K1 (``SFNOConfig.use_pallas``; on the CPU its
plain version): forward, dx and dW in every training step, the forward in
every evaluation. Randomness comes from ``torch.Generator``s seeded as the
JAX script seeds its keys: ``seed + i`` for validation batch i (the members'
dropout on the host generator, their inputs noise on one on the device),
``fold_in(123, k)`` for rollout segment k.

Writes ``metrics.json`` and ``report.md`` in the JAX script's layout (no
plots), and the EMA weights as ``interpolator.msgpack`` and
``forecaster.msgpack`` in flax's msgpack layout (``{"params": ...}``, by
``utils/flax_msgpack.py``); ``--reuse`` reads these or the JAX package's
own. ``metrics.json`` also holds ``timing`` (each stage's seconds, the
median step ms, the training set's upload).

Run:  python -m spherical_dyffusion_tpu_torch.scripts.skill_proof            (the card, full)
      python -m spherical_dyffusion_tpu_torch.scripts.skill_proof --preset=mini --platform=cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.datamodule import StochasticDataModule
from ..diffusion.dyffusion import DYffusionConfig
from ..evaluation import metrics as M
from ..inference.stepper import DYffusionStepper
from ..models.sfno import SFNO, SFNOConfig
from ..training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
    fold_in,
    stack_window,
)
from ..training.trainer import Trainer, TrainerConfig, ensemble_members
from ..utils import flax_msgpack
from ..utils.convert import flax_to_state_dict, state_dict_to_flax
from ..utils.device import to_device
from . import StepClock, device_for

__all__ = ["main", "PRESETS", "SSR_BOUNDS", "parser", "preset", "datamodule", "sfno_config",
           "interp_baselines", "horizon_table", "run_eval", "rollout_stability",
           "climatology_field"]

PRESETS = {
    "full": dict(height=64, width=128, channels=2, horizon=6,
                 embed=64, layers=4, batch=16, steps_per_epoch=150,
                 epochs_interp=24, epochs_fc=24, n_timesteps=8192,
                 n_val_timesteps=512, lr_interp=2e-3, lr_fc=1e-3,
                 dropout=0.15, eval_batches=4, eval_bs=8, ens_chunk=2,
                 all_samples=True),
    "mini": dict(height=16, width=32, channels=2, horizon=4,
                 embed=16, layers=2, batch=8, steps_per_epoch=40,
                 epochs_interp=4, epochs_fc=3, n_timesteps=512,
                 n_val_timesteps=128, lr_interp=5e-3, lr_fc=3e-3,
                 dropout=0.15, eval_batches=2, eval_bs=4, ens_chunk=3),
}
SSR_BOUNDS = (0.8, 1.15)
ROLLOUT_SEED = 123


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu to run on the CPU; absent, the CUDA card (raises without one)")
    ap.add_argument("--preset", choices=["full", "mini"], default="full")
    ap.add_argument("--out", default="results/torch_skill")
    ap.add_argument("--ensemble", type=int, default=10)
    ap.add_argument("--rollout-steps", type=int, default=504)
    # the interpolator's MLP dropout: the spread source, the calibration knob
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--epochs-interp", type=int, default=None)
    ap.add_argument("--epochs-fc", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--n-timesteps", type=int, default=None,
                    help="training frames (the preset's by default): a cut of scale")
    # per-member gaussian input perturbation at prediction time (the
    # reference's prediction_inputs_noise), the second calibration knob
    ap.add_argument("--inputs-noise", type=float, default=0.0)
    ap.add_argument("--reuse", default=None,
                    help="out dir of a previous run (the port's or the JAX package's): "
                         "load its weights and skip training")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction, default=True,
                    help="Trainer.fit_in_memory (the training set on the device); "
                         "--no-fused: Trainer.fit")
    ap.add_argument("--system", choices=["ou", "chaotic"], default="ou")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--params-dtype", default=None,
                    help="weight rounding of the rollout stepper")
    ap.add_argument("--preds-dtype", default=None,
                    help="emitted-prediction dtype of the rollout stepper")
    ap.add_argument("--thresh", type=float, default=1.0,
                    help="spectral hard_thresholding_fraction of both networks")
    ap.add_argument("--factorization", default="",
                    help="spectral-weight factorization of both networks (cp|tucker|tt)")
    ap.add_argument("--rank", type=float, default=1.0,
                    help="factorization rank as a fraction of embed")
    ap.add_argument("--spectral-io", default="",
                    help="spectral-pipeline intermediate dtype (e.g. bfloat16)")
    ap.add_argument("--peel", action="store_true",
                    help="peel_sampler=True in the DYffusion config")
    return ap


def preset(args) -> dict:
    """The preset's settings with the command line's overrides."""
    P = dict(PRESETS[args.preset])
    for key, value in (("dropout", args.dropout), ("epochs_interp", args.epochs_interp),
                       ("epochs_fc", args.epochs_fc), ("steps_per_epoch", args.steps_per_epoch),
                       ("n_timesteps", args.n_timesteps)):
        if value is not None:
            P[key] = value
    return P


def datamodule(P: dict, system: str) -> StochasticDataModule:
    """The study's data: ``system`` at the preset's grid, horizon and
    sizes, ``eval_batches`` validation batches; the training set whole with
    ``all_samples`` (fused epochs permute all of it: capping it to one
    epoch's samples overfits the noise realizations), else one epoch's."""
    return StochasticDataModule(
        system=system, channels=P["channels"], height=P["height"], width=P["width"],
        horizon=P["horizon"], n_timesteps=P["n_timesteps"],
        n_val_timesteps=P["n_val_timesteps"], batch_size=P["batch"],
        eval_batch_size=P["eval_bs"], max_val_samples=P["eval_batches"] * P["eval_bs"],
        max_train_samples=None if P.get("all_samples") else P["steps_per_epoch"] * P["batch"])


def sfno_config(P: dict, args, interpolator: bool) -> SFNOConfig:
    """Both networks of the JAX script: (state, end state) -> state, with
    the time embedding; the interpolator with the MLP dropout. K1 takes the
    dense dhconv, except with spectral IO, whose rounding runs on the stacked
    einsum route."""
    C, H = P["channels"], P["horizon"]
    return SFNOConfig(
        img_shape=(P["height"], P["width"]), in_chans=2 * C, out_chans=C,
        embed_dim=P["embed"], num_layers=P["layers"], with_time_emb=True,
        dropout_mlp=P["dropout"] if interpolator else 0.0,
        min_time=1 if interpolator else 0, max_time=H - 1,
        compute_dtype=args.dtype, sht_matmul_dtype=args.dtype,
        hard_thresholding_fraction=args.thresh,
        factorization=args.factorization, rank=args.rank,
        spectral_io_dtype=args.spectral_io, use_pallas=not args.spectral_io)


def climatology_field(src, names, n: int, device) -> torch.Tensor:
    """The time mean of the source's first ``n`` frames, (H, W, C)."""
    sample = src.read_window(0, min(n, src.n_timesteps), names)
    return to_device(torch.from_numpy(np.stack([sample[k].mean(0) for k in names], axis=-1)),
                     device)


def _rmse(target, pred, w) -> torch.Tensor:
    return torch.mean(M.root_mean_squared_error(target, pred, w[..., None], dim=(-3, -2, -1)))


def interp_baselines(dyn: torch.Tensor, clim_field: torch.Tensor, w: torch.Tensor,
                     horizon: int):
    """On raw ``dyn`` (B, T, H, W, C) (window 1: the inputs are frames 0 and
    T - 1): the mean over t = 1 .. horizon - 1 of the RMSE of the frame at t
    against climatology and against linear interpolation."""
    clim, lin = [], []
    for t in range(1, horizon):
        target = dyn[:, t]
        line = dyn[:, 0] + (dyn[:, -1] - dyn[:, 0]) * (t / horizon)
        clim.append(_rmse(target, clim_field.expand_as(target), w))
        lin.append(_rmse(target, line, w))
    return torch.stack(clim).mean(), torch.stack(lin).mean()


@torch.no_grad()
def horizon_table(exp: DYffusionForecastingExperiment, dyn: torch.Tensor,
                  normalizer, E: int, chunk: Optional[int], inputs_noise: float,
                  generator: torch.Generator, noise_generator: Optional[torch.Generator],
                  w: torch.Tensor, clim_field: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX script's ``eval_fn`` on one raw batch ``dyn`` (B, T, H, W,
    C): E members of the sampling loop from frame 0 (each with its own
    dropout draws from ``generator`` and, with ``inputs_noise``, its own
    gaussian input perturbation from ``noise_generator``), tiled along the
    batch in chunks of ``chunk`` as the JAX script's ``chunked_vmap`` runs
    them; then at each horizon h the ensemble-mean RMSE, CRPS, SSR, and the
    persistence and climatology RMSE, as device scalars ``h{h}/<metric>``."""
    horizon = exp.cfg.horizon
    init = stack_window(normalizer.normalize(dyn)[:, :1])
    B = dyn.shape[0]

    def member(n):
        x = init.repeat(n, 1, 1, 1)
        if inputs_noise > 0:  # the reference's get_ensemble_inputs
            x = x + inputs_noise * torch.randn(x.shape, generator=noise_generator,
                                               device=x.device, dtype=x.dtype)
        out = exp.predict(x, generator)
        return {h: out.preds[h] for h in range(1, horizon + 1) if h in out.preds}

    preds = ensemble_members(member, E, B, chunk)
    table = {}
    wc = w[..., None]
    dims = (-3, -2, -1)
    for h, p in preds.items():
        pe = normalizer.denormalize(p)  # (E, B, H, W, C)
        target = dyn[:, h]
        table[f"h{h}/rmse"] = _rmse(target, pe.mean(0), w)
        table[f"h{h}/crps"] = torch.mean(M.crps_ensemble(target, pe, wc, dim=dims))
        table[f"h{h}/ssr"] = torch.mean(M.spread_skill_ratio(target, pe, wc, dim=dims))
        table[f"h{h}/rmse_persistence"] = _rmse(target, dyn[:, 0], w)
        table[f"h{h}/rmse_climatology"] = _rmse(target, clim_field.expand_as(target), w)
    return table


def run_eval(exp, dm, normalizer, E: int, P: dict, inputs_noise: float, w, clim_field,
             device, seed: int = 0) -> Dict[str, float]:
    """``horizon_table`` over the first ``eval_batches`` validation batches,
    batch i drawn from generators seeded ``seed + i``; the mean of each
    metric over the batches."""
    tables = []
    for i, batch in enumerate(dm.val_batches(horizon=P["horizon"])):
        gen = torch.Generator().manual_seed(seed + i)
        noise_gen = torch.Generator(device=device).manual_seed(seed + i)
        dyn = to_device(batch["dynamics"], device)
        t = horizon_table(exp, dyn, normalizer, E, P.get("ens_chunk"), inputs_noise, gen,
                          noise_gen, w, clim_field)
        tables.append({k: float(v) for k, v in t.items()})
        if len(tables) >= P["eval_batches"]:
            break
    return {k: float(np.mean([t[k] for t in tables])) for k in tables[0]}


def rollout_stability(stepper: DYffusionStepper, dm, normalizer, n_steps: int,
                      horizon: int, w, clim_field, device) -> dict:
    """``n_steps`` autoregressive steps from the first validation frame in
    segments of ``12 * horizon`` (segment k's draws from ``fold_in(123,
    k)``; the inputs noise on the first segment only): the largest |state|
    per segment (normalized), the final state's RMSE against climatology,
    the data's own largest |state| over its first 256 frames, and
    ``stable`` (finite and under 3 x the data's)."""
    names = list(dm.cfg.in_names)
    src = dm._val_src
    seg = min(n_steps, 12 * horizon)
    frame0 = src.read_window(0, 1, names)
    x0 = torch.from_numpy(np.stack([frame0[n][0] for n in names], -1))[None]
    x = normalizer.normalize(to_device(x0, device))
    done, k, peaks, preds = 0, 0, [], None
    while done < n_steps:
        n = min(seg, n_steps - done)
        x, preds = stepper.run_window(x, None, None, None, fold_in(ROLLOUT_SEED, k), n,
                                      apply_inputs_noise=(done == 0))
        peaks.append(float(preds.abs().max()))
        done += n
        k += 1
    final = normalizer.denormalize(preds[:, -1].float())
    rmse_clim = float(_rmse(clim_field.expand_as(final), final, w))
    data = src.read_window(0, min(256, src.n_timesteps), names)
    data = to_device(torch.from_numpy(np.stack([data[n] for n in names], -1)), device)
    data_max = float(normalizer.normalize(data).abs().max())
    peak = max(peaks)
    return {
        "n_steps": n_steps,
        "max_abs_normalized_per_window": peaks,
        "max_abs_normalized": peak,
        "data_max_abs_normalized": data_max,
        "final_state_rmse_vs_climatology": rmse_clim,
        "stable": bool(np.isfinite(peak) and peak < 3.0 * data_max),
    }


def _save(out: str, name: str, state_dict) -> None:
    flax_msgpack.write(os.path.join(out, name), state_dict_to_flax(state_dict))


def _load(model, reuse: str, name: str) -> None:
    model.load_state_dict(flax_to_state_dict(flax_msgpack.read(os.path.join(reuse, name))))


def _fit(trainer: Trainer, fused: bool, epochs: int, device) -> tuple:
    """(history, timing) of a verbose fit validating every ``epochs // 3``
    epochs."""
    clock = StepClock(device)
    val_every = max(1, epochs // 3)
    t0 = time.perf_counter()
    if fused:
        hist = trainer.fit_in_memory(verbose=True, val_every=val_every, mark=clock)
    else:
        hist = trainer.fit(verbose=True, val_every=val_every)
    timing = dict(seconds=time.perf_counter() - t0, steps=trainer.state.step,
                  step_ms=clock.step_ms() if fused else None, upload=hist.get("upload"))
    return hist, timing


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = device_for(args.platform)
    P = preset(args)
    H = P["horizon"]
    dm = datamodule(P, args.system)
    names = list(dm.cfg.in_names)
    w = to_device(dm.grid.horizontal.area_weights(), device)
    normalizer = dm.normalizer.to(device)
    os.makedirs(args.out, exist_ok=True)
    report = {"preset": args.preset, "params": P, "thresh": args.thresh,
              "factorization": args.factorization, "spectral_io": args.spectral_io,
              "rank": args.rank}
    timing = {}
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- stage 1
    print("== stage 1: interpolator ==", flush=True)
    imodel = SFNO(sfno_config(P, args, interpolator=True)).to(device)
    imodel.init_weights(torch.Generator(device=device).manual_seed(0))
    interp = InterpolationExperiment(
        imodel, ExperimentConfig(horizon=H, window=1, loss_function="l1",
                                 num_predictions=args.ensemble, enable_inference_dropout=True),
        dm.in_packer, dm.out_packer, dm.normalizer)
    t1 = Trainer(interp, dm, TrainerConfig(
        lr=P["lr_interp"], epochs=P["epochs_interp"], use_ema=True, warmup_steps=50,
        steps_per_epoch=P["steps_per_epoch"], seed=0, val_ensemble_chunk=P.get("ens_chunk")))
    if args.reuse:
        _load(imodel, args.reuse, "interpolator.msgpack")
        hist1 = {"train_loss": [], "val": []}
        prev = json.load(open(os.path.join(args.reuse, "metrics.json")))
        interp_val = {f"val/avg/{k.split('_', 1)[1]}": v
                      for k, v in prev["interpolator"].items()
                      if k.startswith("val_") and v is not None}
    else:
        hist1, timing["interpolator"] = _fit(t1, args.fused, P["epochs_interp"], device)
        interp_val = t1.validate(t1.state, max_batches=P["eval_batches"])
        imodel.load_state_dict(t1.state.ema.state_dict())  # the EMA weights from here on
    _save(args.out, "interpolator.msgpack", imodel.state_dict())

    # the interpolation baselines on the validation batches
    clim_field = climatology_field(dm._train_src, names, 256, device)
    clims, lins = [], []
    for batch in dm.val_batches(horizon=H):
        c_, l_ = interp_baselines(to_device(batch["dynamics"], device), clim_field, w, H)
        clims.append(float(c_))
        lins.append(float(l_))
        if len(clims) >= P["eval_batches"]:
            break
    report["interpolator"] = {
        "train_loss": hist1["train_loss"],
        "val_rmse": interp_val.get("val/avg/rmse"),
        "val_crps": interp_val.get("val/avg/crps"),
        "val_ssr": interp_val.get("val/avg/ssr"),
        "baseline_rmse_climatology": float(np.mean(clims)),
        "baseline_rmse_linear_interp": float(np.mean(lins)),
    }
    print(json.dumps(report["interpolator"], indent=1), flush=True)

    # ---------------------------------------------------------------- stage 2
    print("== stage 2: DYffusion forecaster ==", flush=True)
    dcfg = DYffusionConfig(timesteps=H, forward_conditioning="data", lambda_reconstruction=1.0,
                           peel_sampler=args.peel)
    fmodel = SFNO(sfno_config(P, args, interpolator=False)).to(device)
    fmodel.init_weights(torch.Generator(device=device).manual_seed(1))
    ecfg = ExperimentConfig(horizon=H, loss_function="l1", num_predictions=args.ensemble)
    fexp = DYffusionForecastingExperiment(fmodel, interp, dcfg, ecfg, dm.in_packer,
                                          dm.out_packer, dm.normalizer)
    t2 = Trainer(fexp, dm, TrainerConfig(
        lr=P["lr_fc"], epochs=P["epochs_fc"], use_ema=True, warmup_steps=50,
        steps_per_epoch=P["steps_per_epoch"], seed=1, val_ensemble_chunk=P.get("ens_chunk")))
    if args.reuse:
        _load(fmodel, args.reuse, "forecaster.msgpack")
        hist2 = {"train_loss": [], "val": []}
    else:
        hist2, timing["forecaster"] = _fit(t2, args.fused, P["epochs_fc"], device)
        fmodel.load_state_dict(t2.state.ema.state_dict())
    _save(args.out, "forecaster.msgpack", fmodel.state_dict())
    report["forecaster"] = {"train_loss": hist2["train_loss"],
                            "val": hist2["val"][-1] if hist2["val"] else {}}
    report["inputs_noise"] = args.inputs_noise

    # ------------------------------------------------- per-horizon ensembles
    print("== eval: cold vs naive sampling, calibration ==", flush=True)
    t0 = time.perf_counter()
    cold_eval = run_eval(fexp, dm, normalizer, args.ensemble, P, args.inputs_noise, w,
                         clim_field, device)
    naive_exp = DYffusionForecastingExperiment(
        fmodel, interp, dataclasses.replace(dcfg, sampling_type="naive"), ecfg, dm.in_packer,
        dm.out_packer, dm.normalizer)
    naive_eval = run_eval(naive_exp, dm, normalizer, args.ensemble, P, args.inputs_noise, w,
                          clim_field, device)
    timing["eval_s"] = time.perf_counter() - t0
    report["cold_sampling"] = cold_eval
    report["naive_sampling"] = naive_eval
    lo, hi = SSR_BOUNDS
    report["calibration"] = {
        "ssr_bounds": [lo, hi],
        "cold_ssr": {f"h{h}": cold_eval[f"h{h}/ssr"] for h in range(1, H + 1)},
        "pass": all(lo <= cold_eval[f"h{h}/ssr"] <= hi for h in range(1, H + 1)),
    }
    src = dm._val_src
    K = src._modes.shape[1]
    if hasattr(src, "conditional_forecast_std"):
        # OU: the analytic irreducible spread per horizon, in field units
        # (per-mode std * sqrt(K): the modes have unit RMS)
        report["analytic_spread"] = {f"h{h}": src.conditional_forecast_std(h) * float(np.sqrt(K))
                                     for h in range(1, H + 1)}
    if hasattr(src, "empirical_growth_factor"):
        # chaotic: the measured perturbation growth per horizon (> 1: a
        # positive Lyapunov exponent)
        report["perturbation_growth"] = {f"h{h}": src.empirical_growth_factor(h)
                                         for h in range(1, H + 1)}
    print("cold:", json.dumps({k: round(v, 4) for k, v in cold_eval.items()}, indent=1),
          flush=True)
    print("naive:", json.dumps({k: round(v, 4) for k, v in naive_eval.items()}, indent=1),
          flush=True)

    # ------------------------------------------------------ rollout stability
    print(f"== rollout stability ({args.rollout_steps} AR steps) ==", flush=True)
    t0 = time.perf_counter()
    stepper = DYffusionStepper(fexp, inputs_noise=args.inputs_noise,
                               params_dtype=args.params_dtype, preds_dtype=args.preds_dtype)
    report["rollout"] = rollout_stability(stepper, dm, normalizer, args.rollout_steps, H, w,
                                          clim_field, device)
    _sync(device)
    timing["rollout_s"] = time.perf_counter() - t0
    print(json.dumps(report["rollout"], indent=1), flush=True)
    report["wall_time_s"] = time.perf_counter() - t_start
    report["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    report["timing"] = timing

    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(report, f, indent=1)
    _write_report(args.out, report, H)
    print(f"report written to {args.out}", flush=True)
    return report


def _write_report(out_dir: str, r: dict, horizon: int) -> None:
    """``report.md`` in the JAX script's layout, without its plots."""
    i = r["interpolator"]
    val_crps = i.get("val_crps")
    lines = [
        "# Skill proof: two-stage DYffusion on stochastic spherical dynamics",
        "",
        f"Preset `{r['preset']}`, device `{r.get('device')}`, "
        f"wall time {r.get('wall_time_s', 0):.0f}s.",
        "",
        "System: solid-body rotation (deterministic, learnable) + OU modal noise "
        "(irreducible, closed-form conditional spread). See "
        "`data/datasets.py:StochasticModalTimeSeries`.",
        "",
        "## 1. Interpolator skill",
        "",
        "| metric | value |", "|---|---|",
        f"| val RMSE (ensemble mean) | {i['val_rmse']:.4f} |",
        f"| val CRPS | {val_crps if val_crps is not None else float('nan'):.4f} |",
        f"| climatology RMSE | {i['baseline_rmse_climatology']:.4f} |",
        f"| linear-interpolation RMSE | {i['baseline_rmse_linear_interp']:.4f} |",
        f"| skill vs climatology | {i['val_rmse'] / i['baseline_rmse_climatology']:.3f}x |",
        "",
        "## 2. Forecaster: cold vs naive sampling (10-member ensembles)",
        "",
        "| h | cold RMSE | naive RMSE | cold CRPS | naive CRPS | SSR (cold) | persistence "
        "| climatology |",
        "|---|---|---|---|---|---|---|---|",
    ]
    c, n = r["cold_sampling"], r["naive_sampling"]
    for h in range(1, horizon + 1):
        lines.append(
            f"| {h} | {c[f'h{h}/rmse']:.4f} | {n[f'h{h}/rmse']:.4f} "
            f"| {c[f'h{h}/crps']:.4f} | {n[f'h{h}/crps']:.4f} "
            f"| {c[f'h{h}/ssr']:.3f} | {c[f'h{h}/rmse_persistence']:.4f} "
            f"| {c[f'h{h}/rmse_climatology']:.4f} |")
    ro = r["rollout"]
    lines += [
        "",
        "## 3. Long-rollout stability",
        "",
        f"{ro['n_steps']} autoregressive steps: max |state| (normalized) = "
        f"{ro['max_abs_normalized']:.2f}, final-state RMSE vs climatology = "
        f"{ro['final_state_rmse_vs_climatology']:.3f} -> "
        f"**{'STABLE' if ro['stable'] else 'UNSTABLE'}**",
    ]
    with open(os.path.join(out_dir, "report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
