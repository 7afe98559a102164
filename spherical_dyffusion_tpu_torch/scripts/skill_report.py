"""Gather the port's skill runs into one report.

Counterpart of the JAX package's ``scripts/skill_report.py``: it reads the
``metrics.json`` of the port's runs of ``skill_proof`` and ``ace_skill``
and writes ``README.md`` in the JAX report's layout: the interpolator's
skill against its baselines, the forecaster against the OU system's
analytic optimum with naive sampling, persistence and climatology, the
calibration knobs (the dropout runs and the ``--inputs-noise`` sweep, where
they were run), the long rollout's stability; then, where they were run, the
chaotic system's calibrated recipe and the ACE configs' per-lead RMSE. It
plots nothing and copies no figure.

Run after the studies:
    python -m spherical_dyffusion_tpu_torch.scripts.skill_report
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional

__all__ = ["main", "load"]


def load(path: str) -> dict:
    with open(os.path.join(path, "metrics.json")) as f:
        return json.load(f)


def _maybe(path: Optional[str]) -> Optional[dict]:
    return load(path) if path and os.path.exists(os.path.join(path, "metrics.json")) else None


def _horizons(run: dict) -> list:
    return sorted(int(k.split("/")[0][1:]) for k in run["cold_sampling"] if k.endswith("/rmse"))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/torch_skill",
                    help="directory of the README.md written")
    ap.add_argument("--final", default="results/torch_skill_final",
                    help="skill_proof at the full preset (the JAX report's skill_final)")
    ap.add_argument("--base", default="results/torch_skill",
                    help="skill_proof at dropout 0.15 (optional)")
    ap.add_argument("--d35", default="results/torch_skill_d35",
                    help="skill_proof at dropout 0.35, as --base's epochs (optional)")
    ap.add_argument("--sweep", default="results/torch_skill_nz*",
                    help="glob of --inputs-noise runs on --final's weights, named ...nz<value>")
    ap.add_argument("--chaotic", default="results/torch_skill_chaotic_calibrated",
                    help="skill_proof --system chaotic (optional)")
    ap.add_argument("--ace", default="results/torch_skill_ace_fast",
                    help="ace_skill (optional)")
    args = ap.parse_args(argv)

    final = load(args.final)
    base, d35 = _maybe(args.base), _maybe(args.d35)
    chaotic, ace = _maybe(args.chaotic), _maybe(args.ace)
    sweep = {float(d.split("nz")[-1]): load(d) for d in sorted(glob.glob(args.sweep))}
    runs = {final.get("inputs_noise", 0.0): final, **sweep}
    hs = _horizons(final)
    p = final["params"]
    i = final["interpolator"]
    c0, n0 = final["cold_sampling"], final["naive_sampling"]
    lines = [
        "# Skill proof: two-stage DYffusion on stochastic spherical dynamics (PyTorch port)",
        "",
        "System: solid-body rotation (deterministic, exactly learnable) + an "
        "Ornstein-Uhlenbeck modal process with **closed-form conditional spread** "
        "(`data/datasets.py:StochasticModalTimeSeries`), so the RMSE optimum and the "
        "calibration target are known analytically.",
        "",
        f"Training: SFNO embed {p['embed']} x {p['layers']} layers at "
        f"{p['height']}x{p['width']}, {p['epochs_interp']} + {p['epochs_fc']} epochs of "
        f"{p['steps_per_epoch']} steps, MLP dropout {p['dropout']}, on `{final.get('device')}` "
        f"(wall {final.get('wall_time_s', 0):.0f}s for the whole study).",
        "",
        "## 1. Interpolator skill (stage 1)",
        "",
        "| metric | value |", "|---|---|",
        f"| val RMSE (ensemble mean) | **{i['val_rmse']:.4f}** |",
        f"| climatology RMSE | {i['baseline_rmse_climatology']:.4f} |",
        f"| linear-interpolation RMSE | {i['baseline_rmse_linear_interp']:.4f} |",
        f"| skill vs climatology | **{i['baseline_rmse_climatology'] / i['val_rmse']:.2f}x "
        "better** |",
        "",
        "## 2. Forecaster: RMSE at the analytic optimum",
        "",
        "| h | cold RMSE | analytic optimum | naive RMSE | persistence | climatology |",
        "|---|---|---|---|---|---|",
    ]
    an = final.get("analytic_spread", {})
    for h in hs:
        opt = f"{an[f'h{h}']:.4f}" if f"h{h}" in an else "-"
        lines.append(f"| {h} | **{c0[f'h{h}/rmse']:.4f}** | {opt} | {n0[f'h{h}/rmse']:.4f} "
                     f"| {c0[f'h{h}/rmse_persistence']:.4f} "
                     f"| {c0[f'h{h}/rmse_climatology']:.4f} |")
    lines += ["", "## 3. Ensemble calibration: the two spread knobs", ""]
    if base is not None and d35 is not None:
        lines += [
            f"Interpolator MLP dropout: rate {base['params']['dropout']} -> SSR(h1) "
            f"{base['cold_sampling']['h1/ssr']:.3f}, rate {d35['params']['dropout']} -> "
            f"{d35['cold_sampling']['h1/ssr']:.3f} (h1 RMSE "
            f"{base['cold_sampling']['h1/rmse']:.4f} and {d35['cold_sampling']['h1/rmse']:.4f}).",
            "",
        ]
    mid = hs[len(hs) // 2]
    cols = [hs[0], mid, hs[-1]]
    lines += [
        "`prediction_inputs_noise` (per-member input perturbation), eval-only on the same "
        "weights:",
        "",
        "| inputs_noise | " + " | ".join(f"h{h} CRPS | h{h} SSR" for h in cols) + " | h1 RMSE |",
        "|---|" + "---|---|" * len(cols) + "---|",
    ]
    for nz in sorted(runs):
        c = runs[nz]["cold_sampling"]
        lines.append(f"| {nz:g} | " + " | ".join(
            f"{c[f'h{h}/crps']:.4f} | {c[f'h{h}/ssr']:.3f}" for h in cols)
            + f" | {c['h1/rmse']:.4f} |")
    cal = final["calibration"]
    lines += ["", f"Calibration gate (SSR in {cal['ssr_bounds']} at every horizon): "
              f"**{'PASS' if cal['pass'] else 'FAIL'}**.", ""]
    ro = final["rollout"]
    lines += [
        f"## 4. Long-rollout stability ({ro['n_steps']} autoregressive steps)",
        "",
        f"max |state| (normalized) {ro['max_abs_normalized']:.2f} vs the data's own max "
        f"{ro['data_max_abs_normalized']:.2f} -> "
        f"**{'STABLE' if ro['stable'] else 'UNSTABLE'}**; final-state RMSE vs climatology "
        f"{ro['final_state_rmse_vs_climatology']:.3f}.",
    ]
    if chaotic is not None:
        cc, cal = chaotic["cold_sampling"], chaotic["calibration"]
        ch = _horizons(chaotic)
        lines += [
            "",
            "## 5. The chaotic system (Lorenz-96 modes), calibrated recipe",
            "",
            f"Interpolator dropout {chaotic['params']['dropout']}, inputs noise "
            f"{chaotic.get('inputs_noise', 0.0)}: val RMSE "
            f"{chaotic['interpolator']['val_rmse']:.4f} against climatology "
            f"{chaotic['interpolator']['baseline_rmse_climatology']:.4f}.",
            "",
            "| h | cold RMSE | cold CRPS | SSR | growth |", "|---|---|---|---|---|",
        ]
        growth = chaotic.get("perturbation_growth", {})
        for h in ch:
            g = f"{growth[f'h{h}']:.2f}" if f"h{h}" in growth else "-"
            lines.append(f"| {h} | {cc[f'h{h}/rmse']:.4f} | {cc[f'h{h}/crps']:.4f} "
                         f"| {cc[f'h{h}/ssr']:.3f} | {g} |")
        lines += ["", f"Calibration gate {cal['ssr_bounds']}: "
                  f"**{'PASS' if cal['pass'] else 'FAIL'}**; rollout "
                  f"{'stable' if chaotic['rollout']['stable'] else 'UNSTABLE'}."]
    if ace is not None:
        cfgs = ace["configs"]
        leads = sorted({k for e in cfgs.values() for k in e["rmse_per_lead"]},
                       key=lambda k: int(k[4:]))
        lines += [
            "",
            f"## 6. ACE-style single-step forecaster ({ace['system']} system, "
            f"{ace['rollout_steps']} steps from {ace['ics']} initial conditions)",
            "",
            "| config | " + " | ".join(leads) + " | bounded |",
            "|---|" + "---|" * len(leads) + "---|",
        ]
        for name, e in cfgs.items():
            lines.append(f"| {name} | " + " | ".join(
                f"{e['rmse_per_lead'][k]:.4f}" for k in leads)
                + f" | {e['bounded']} |")
        first = next(iter(cfgs.values()))
        lines.append("| climatology | " + " | ".join(
            f"{first['rmse_climatology_per_lead'][k]:.4f}" for k in leads) + " | |")
    lines += ["", "Raw metrics: `metrics.json` of each run directory."]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"report -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
