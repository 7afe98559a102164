"""ACE-family skill check of the spectral configs, on the port.

Counterpart of the JAX package's ``scripts/ace_skill.py``, with its
``CONFIGS``, presets, arguments and defaults. For each config it trains an
ACE-style single-step forecaster (``SimultaneousForecastingExperiment``,
``horizon_at_once=1``: x_{t+1} from x_t) on the same data and seed, in bf16
compute with bf16 transforms as the JAX script sets them, EMA on, through
``Trainer.fit_in_memory``; then rolls it out autoregressively from ``--ics``
strided initial conditions of the validation source for R steps and scores
the per-lead area-weighted RMSE against the truth and against climatology
(the time mean of the first 512 training frames) at leads {1, 2, 4, 8, 16,
R}, and ``bounded`` (finite, and under 4 x the truth's largest normalized
|state|). The dense config's dhconv runs through K1 (``use_pallas``); K1
computes in float32 whatever the matmul dtype, as JAX's Pallas kernel does.
The CP configs run no kernel.

Writes ``metrics.json`` in the JAX script's layout.

Run:  python -m spherical_dyffusion_tpu_torch.scripts.ace_skill [--configs dense,t09,t08]
      python -m spherical_dyffusion_tpu_torch.scripts.ace_skill --preset mini --platform cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data.datamodule import StochasticDataModule
from ..evaluation import metrics as M
from ..models.sfno import SFNO, SFNOConfig
from ..training.experiments import ExperimentConfig, SimultaneousForecastingExperiment
from ..training.trainer import Trainer, TrainerConfig
from ..utils.device import to_device
from . import StepClock, device_for

__all__ = ["main", "CONFIGS", "PRESETS", "parser", "rollout", "score", "leads_of"]

CONFIGS = {
    # name -> (factorization, rank, thresh)
    "dense": ("", 1.0, 1.0),
    "t09": ("cp", 0.25, 0.9),
    "t08": ("cp", 0.25, 0.8),
}
PRESETS = {
    "full": dict(height=64, width=128, channels=2, embed=64, layers=4,
                 batch=16, steps_per_epoch=150, epochs=24, n_timesteps=8192,
                 n_val_timesteps=512, lr=1e-3),
    "mini": dict(height=16, width=32, channels=2, embed=16, layers=2,
                 batch=8, steps_per_epoch=40, epochs=4, n_timesteps=512,
                 n_val_timesteps=128, lr=3e-3),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu to run on the CPU; absent, the CUDA card (raises without one)")
    ap.add_argument("--preset", choices=["full", "mini"], default="full")
    ap.add_argument("--system", choices=["ou", "chaotic"], default="chaotic")
    ap.add_argument("--out", default="results/torch_skill_ace_fast")
    ap.add_argument("--configs", default="dense,t09,t08")
    ap.add_argument("--rollout-steps", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--n-timesteps", type=int, default=None,
                    help="training frames (the preset's by default): a cut of scale")
    ap.add_argument("--ics", type=int, default=8, help="initial conditions scored per config")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def model_config(P: dict, name: str, dtype: str = "bfloat16") -> SFNOConfig:
    """Config ``name``'s SFNO: state -> next state, no time embedding."""
    fact, rank, thresh = CONFIGS[name]
    return SFNOConfig(
        img_shape=(P["height"], P["width"]), in_chans=P["channels"], out_chans=P["channels"],
        embed_dim=P["embed"], num_layers=P["layers"], compute_dtype=dtype,
        sht_matmul_dtype=dtype, hard_thresholding_fraction=thresh, factorization=fact,
        rank=rank, use_pallas=True)


def leads_of(R: int) -> list:
    return sorted({1, 2, 4, 8, 16, R} & set(range(1, R + 1)))


@torch.no_grad()
def rollout(model, normalizer, x0_raw: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The autoregressive rollout of ``model`` (deterministic) from raw
    initial states ``x0_raw`` (I, H, W, C): ``n_steps`` predictions, raw,
    (I, n_steps, H, W, C)."""
    x = normalizer.normalize(x0_raw)
    ys = []
    for _ in range(n_steps):
        x = model(x)
        ys.append(x)
    return normalizer.denormalize(torch.stack(ys, dim=1))


@torch.no_grad()
def score(preds: torch.Tensor, truth_tail: torch.Tensor, w: torch.Tensor,
          clim: torch.Tensor, normalizer):
    """Raw ``preds`` and ``truth_tail`` (I, R, H, W, C): the area-weighted
    RMSE per lead averaged over the initial conditions (R,), the same for
    climatology (R,), and the largest normalized |prediction|."""
    wc = w[..., None]
    dims = (-3, -2, -1)
    rmse = M.root_mean_squared_error(truth_tail, preds, wc, dim=dims)
    rmse_clim = M.root_mean_squared_error(truth_tail, clim.expand_as(truth_tail), wc, dim=dims)
    mx = normalizer.normalize(preds).abs().max()
    return rmse.mean(0), rmse_clim.mean(0), mx


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = device_for(args.platform)
    P = dict(PRESETS[args.preset])
    if args.epochs is not None:
        P["epochs"] = args.epochs
    if args.n_timesteps is not None:
        P["n_timesteps"] = args.n_timesteps
    C = P["channels"]
    dm = StochasticDataModule(
        system=args.system, channels=C, height=P["height"], width=P["width"], horizon=1,
        n_timesteps=P["n_timesteps"], n_val_timesteps=P["n_val_timesteps"],
        batch_size=P["batch"])
    w = to_device(dm.grid.horizontal.area_weights(), device)
    normalizer = dm.normalizer.to(device)
    os.makedirs(args.out, exist_ok=True)

    # held-out truth: --ics windows of the validation source, strided so the
    # initial conditions decorrelate; climatology from the training mean
    src = dm._val_src
    R = min(args.rollout_steps, src.n_timesteps - 1)
    stride = max(1, (src.n_timesteps - R - 1) // max(args.ics - 1, 1))
    names = list(dm.cfg.in_names)
    truths = []
    for i in range(args.ics):
        win = src.read_window(i * stride, R + 1, names)
        truths.append(np.stack([win[n] for n in names], axis=-1))
    truth = to_device(torch.from_numpy(np.stack(truths)).float(), device)  # (I, R+1, H, W, C)
    sample = dm._train_src.read_window(0, min(512, P["n_timesteps"]), names)
    clim = to_device(torch.from_numpy(np.stack([sample[n].mean(0) for n in names], axis=-1)),
                     device)
    truth_max = float(normalizer.normalize(truth).abs().max())

    leads = leads_of(R)
    report = {"preset": args.preset, "system": args.system, "params": P, "rollout_steps": R,
              "ics": args.ics, "seed": args.seed, "configs": {}}
    t_all = time.perf_counter()
    for name in args.configs.split(","):
        fact, rank, thresh = CONFIGS[name]
        print(f"== config {name}: factorization={fact or 'dense'} rank={rank} "
              f"thresh={thresh} ==", flush=True)
        model = SFNO(model_config(P, name)).to(device)
        model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
        exp = SimultaneousForecastingExperiment(
            model, ExperimentConfig(horizon=1, window=1, loss_function="l2"),
            dm.in_packer, dm.out_packer, dm.normalizer, horizon_at_once=1)
        tr = Trainer(exp, dm, TrainerConfig(
            lr=P["lr"], epochs=P["epochs"], use_ema=True, warmup_steps=50,
            steps_per_epoch=P["steps_per_epoch"], seed=args.seed))
        clock = StepClock(device)
        t0 = time.perf_counter()
        hist = tr.fit_in_memory(verbose=False, val_every=10 ** 9, mark=clock)
        train_s = time.perf_counter() - t0
        model.load_state_dict(tr.state.ema.state_dict())

        t0 = time.perf_counter()
        preds = rollout(model, normalizer, truth[:, 0], R)
        rmse_t, rmse_c, mx = score(preds, truth[:, 1:], w, clim, normalizer)
        rmse_t, rmse_c, mx = rmse_t.cpu().numpy(), rmse_c.cpu().numpy(), float(mx)
        entry = {
            "train_s": round(train_s, 1),
            "final_train_loss": float(hist["train_loss"][-1]),
            "rmse_per_lead": {f"lead{k}": float(rmse_t[k - 1]) for k in leads},
            "rmse_climatology_per_lead": {f"lead{k}": float(rmse_c[k - 1]) for k in leads},
            "max_abs_normalized": mx,
            "bounded": bool(np.isfinite(rmse_t).all() and mx < 4.0 * truth_max),
            "step_ms": clock.step_ms(),
            "rollout_s": time.perf_counter() - t0,
            "upload": hist.get("upload"),
        }
        report["configs"][name] = entry
        print(json.dumps(entry, indent=1), flush=True)

    report["wall_s"] = round(time.perf_counter() - t_all, 1)
    report["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"report written to {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
