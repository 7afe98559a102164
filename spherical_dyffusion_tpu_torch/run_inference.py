"""Inference command line: a JSON config -> an autoregressive rollout with metrics.

Counterpart of ``spherical_dyffusion_tpu/run_inference.py`` on its DYffusion
path: loads a checkpoint (``interface.load_experiment_checkpoint``, any of
its three formats, with the config's ``overrides`` deep-merged in), builds
the prescriber, the ``DYffusionStepper`` (``use_ema``, ``params_dtype``,
``preds_dtype``), the synthetic source where no dataset is given, the
``InferenceAggregator`` with the training normalizer, runs ``run_inference``
and writes ``metrics.json`` (the summary and the aggregator's logs) and the
per-timestep ``metrics.jsonl``.

    python -m spherical_dyffusion_tpu_torch.run_inference config.json [k=v ...]

It runs on the CUDA card unless the config says ``platform: cpu``
(``platform=cpu`` on the command line sets it, as for ``train``). Not
ported, each raising and naming its ROADMAP item: a dataset on disk (a
``validation_loader.dataset.data_path`` that exists), the data writers
(any ``data_writer`` option set) and ``log_video`` (Queue 1 item 8), and
``stepper_type: ace`` (item 5). Media are not written: where the JAX
package plots snapshots or zonal means, one line says so.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

__all__ = ["main_from_config", "main"]


def _refuse_unported(cfg: dict) -> None:
    if cfg.get("stepper_type", "dyffusion") == "ace":
        raise NotImplementedError("stepper_type 'ace': the ACE stepper is not ported (ROADMAP "
                                  "Queue 1 item 5)")
    set_writer = sorted(k for k, v in (cfg.get("data_writer") or {}).items() if v)
    if set_writer:
        raise NotImplementedError(f"data_writer {set_writer}: the writers are not ported "
                                  "(ROADMAP Queue 1 item 8)")
    if cfg.get("log_video"):
        raise NotImplementedError("log_video: the video aggregator is not ported (ROADMAP "
                                  "Queue 1 item 8)")
    data_path = ((cfg.get("validation_loader") or {}).get("dataset") or {}).get("data_path")
    if data_path and os.path.exists(data_path):
        raise NotImplementedError(f"validation_loader.dataset.data_path {data_path!r}: the "
                                  "netCDF reader is not ported (ROADMAP Queue 1 item 8)")


def main_from_config(cfg: dict) -> dict:
    """Run the rollout a config describes; returns ``{"summary", "logs",
    "aggregator", "stepper"}``."""
    from .data.datasets import SyntheticTimeSeries
    from .evaluation.aggregators import InferenceAggregator
    from .inference.loop import InferenceConfig, run_inference
    from .inference.prescriber import PrescriberConfig
    from .inference.stepper import DYffusionStepper
    from .interface import load_experiment_checkpoint, resolve_device
    from .utils.loggers import JsonlLogger

    _refuse_unported(cfg)
    device = resolve_device(cfg)
    exp, _, ema_params, full_cfg = load_experiment_checkpoint(
        cfg["checkpoint_path"], overrides=cfg.get("overrides"), device=device)
    use_ema = bool(cfg.get("use_ema", True)) and ema_params is not None
    out_names = list(exp.out_packer.names)

    prescriber, mask_name = None, None
    p_cfg = cfg.get("prescriber") or full_cfg.get("datamodule", {}).get("prescriber")
    if p_cfg:
        pc = PrescriberConfig(prescribed_name=p_cfg["prescribed_name"],
                              mask_name=p_cfg["mask_name"], mask_value=p_cfg.get("mask_value", 1),
                              interpolate=p_cfg.get("interpolate", False))
        prescriber = pc.build(out_names)
        mask_name = pc.mask_name

    stepper = DYffusionStepper(exp, prescriber=prescriber, use_ema_params=use_ema,
                               ema_params=ema_params if use_ema else None,
                               params_dtype=cfg.get("params_dtype"),
                               preds_dtype=cfg.get("preds_dtype"))

    loader_cfg = cfg.get("validation_loader", {}) or {}
    data_path = (loader_cfg.get("dataset") or {}).get("data_path")
    names = list(dict.fromkeys(list(exp.in_packer.names) + list(exp.forcing_names)
                               + ([mask_name] if mask_name else [])))
    source = SyntheticTimeSeries(names, n_timesteps=int(cfg.get("forward_steps_in_memory", 50))
                                 + 1, spatial_shape=exp.model.cfg.img_shape)
    n_steps = int(cfg.get("n_forward_steps", 100))
    icfg = InferenceConfig(
        n_forward_steps=n_steps,
        forward_steps_in_memory=int(cfg.get("forward_steps_in_memory", 50)),
        n_ensemble=int(cfg.get("n_ensemble", 1)),
        n_repeats=(int((loader_cfg.get("dataset") or {}).get("n_repeats", 1) or 1)
                   if data_path else max(4, n_steps)),
        seed=int(cfg.get("seed", 0)))

    out_dir = cfg.get("experiment_dir", "results/inference")
    os.makedirs(out_dir, exist_ok=True)
    agg = InferenceAggregator(out_names, source.horizontal.area_weights(),
                              log_zonal_mean_images=bool(cfg.get("log_zonal_mean_images", True)),
                              normalizer=exp.normalizer.subset(out_names))
    summary = run_inference(stepper, source, icfg, aggregator=agg, mask_name=mask_name,
                            verbose=bool(cfg.get("verbose", True)))
    logs = agg.get_logs()
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump({**summary, **logs}, f, indent=1)
    if cfg.get("log_per_timestep", True):
        logger = JsonlLogger(out_dir)
        logger.log_hyperparams(cfg)
        logger.log({**summary}, step=0)
        for entry in agg.get_inference_logs():
            logger.log(entry, step=int(entry["timestep"]))
        logger.finish()
    if agg.snapshots.snapshots or agg.zonal is not None:
        print("[media] snapshot panels and zonal-mean plots are not ported (ROADMAP Queue 1 "
              "item 8); not written")
    print(json.dumps({k: round(float(v), 5) for k, v in summary.items()}))
    return {"summary": summary, "logs": logs, "aggregator": agg, "stepper": stepper}


def main(argv: Optional[List[str]] = None):
    from .utils.config import load_config, with_platform

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: python -m spherical_dyffusion_tpu_torch.run_inference "
                         "<config.json> [k=v ...]")
    main_from_config(load_config(argv[0], with_platform(argv[1:])))


if __name__ == "__main__":
    main()
