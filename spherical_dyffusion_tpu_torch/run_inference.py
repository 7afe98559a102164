"""Inference command line: a JSON config -> an autoregressive rollout with metrics.

Counterpart of ``spherical_dyffusion_tpu/run_inference.py`` on its DYffusion
path: loads a checkpoint (``interface.load_experiment_checkpoint``, any of
its three formats, with the config's ``overrides`` deep-merged in), builds
the prescriber, the ``DYffusionStepper`` (``use_ema``, ``params_dtype``,
``preds_dtype``), the source (the netCDF files of
``validation_loader.dataset.data_path`` where it exists, repeated
``n_repeats`` times; else a synthetic one), the ``InferenceAggregator``
with the training normalizer, runs ``run_inference`` and writes
``metrics.json`` (the summary and the aggregator's logs) and the
per-timestep ``metrics.jsonl``.

    python -m spherical_dyffusion_tpu_torch.run_inference config.json [k=v ...]

With ``stepper_type: ace`` it runs the ACE rollout instead
(``inference/ace_stepper.py``): from a native ACE checkpoint
(``interface.load_ace_stepper_checkpoint``, with the run config's
``corrector``, ``ocean`` or ``prescriber`` and ``sigma_coordinates`` over the
checkpoint's, and ``overrides["model"]`` over its builder config, where
``use_pallas`` and ``fused_tail`` turn K1 and K3 on; no other ``overrides``
key applies to it), or from any one-step experiment checkpoint (a simultaneous
forecaster with ``horizon_at_once`` 1 and window 1), whose forcings become
the stepper's and whose prescriber, where the run config gives no ocean,
becomes the prescribed ocean; ``derived: true`` also scores the registered
diagnostics. ``metrics.json`` holds the summary and the aggregator's logs.

It runs on the CUDA card unless the config says ``platform: cpu``
(``platform=cpu`` on the command line sets it, as for ``train``). Both
paths read ``validation_loader.dataset.data_path`` as the JAX command line
does, and both write the files that ``data_writer`` asks for
(``inference/writers.py``: ``save_prediction_files``,
``save_histogram_files``, ``log_extended_video_netcdfs``,
``save_raw_prediction_names``, ``time_coarsen_factor``) into
``experiment_dir``, on the grid of the source; the ACE path writes the
prognostic fields. ``log_video`` records the aggregator's video and writes
it to ``videos.nc`` (``{key}/{name}`` datasets). Both paths write the
snapshot panels (``snapshots/snapshot_t{step}.png``) and, with
``log_zonal_mean_images``, the zonal-mean Hovmoellers
(``zonal_means/zonal_mean_{name}.png``) through ``evaluation/plots.py``,
PNGs without matplotlib; an error writing a media file raises, where the JAX
command line prints it and goes on. The ACE path takes ``log_video`` too,
which the JAX one drops.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

__all__ = ["main_from_config", "main"]


def _data_writer(cfg: dict, out_dir: str, names, source, n_ensemble: int):
    """The config's ``data_writer`` over ``names`` on the source's grid."""
    from .inference.writers import DataWriter, DataWriterConfig

    hc = source.horizontal
    return DataWriter(DataWriterConfig.from_dict(cfg.get("data_writer")), out_dir, names,
                      hc.lat, hc.lon, n_ensemble)


def _source(cfg: dict, names, spatial_shape, ace: bool = False):
    """The rollout's source and its repeats: the netCDF files of the
    config's ``data_path`` where it exists (repeated ``n_repeats`` times),
    else a synthetic source over ``names`` on ``spatial_shape``, repeated
    ``max(4, n_forward_steps)`` times, as in the JAX command line. Where
    ``data_path`` is set but missing, the DYffusion path (``ace`` false)
    keeps ``n_repeats``, as JAX's ``main_from_config`` does; the ACE path
    does not, as JAX's ``_ace_source`` does not."""
    from .data.datasets import NetCDFTimeSeries, SyntheticTimeSeries

    ds = (cfg.get("validation_loader") or {}).get("dataset") or {}
    data_path, n_repeats = ds.get("data_path"), int(ds.get("n_repeats", 1) or 1)
    if data_path and os.path.exists(data_path):
        return NetCDFTimeSeries(data_path), n_repeats
    source = SyntheticTimeSeries(list(names),
                                 n_timesteps=int(cfg.get("forward_steps_in_memory", 50)) + 1,
                                 spatial_shape=tuple(spatial_shape))
    return source, (n_repeats if data_path and not ace
                    else max(4, int(cfg.get("n_forward_steps", 100))))


def main_from_config(cfg: dict) -> dict:
    """Run the rollout a config describes; returns ``{"summary", "logs",
    "aggregator", "stepper"}``."""
    from .evaluation.aggregators import InferenceAggregator
    from .inference.loop import InferenceConfig, run_inference
    from .inference.prescriber import PrescriberConfig
    from .inference.stepper import DYffusionStepper
    from .interface import load_experiment_checkpoint, resolve_device
    from .parallel.multihost import maybe_init_multihost
    from .utils.loggers import JsonlLogger

    from .inference.writers import DataWriterConfig

    DataWriterConfig.from_dict(cfg.get("data_writer"))  # its errors before any checkpoint read
    device = resolve_device(cfg)
    # the process group (opt-in by SPHDY_MULTIHOST / SPHDY_COORDINATOR), before
    # anything is built, as the JAX command line wires its hosts
    maybe_init_multihost(backend="gloo" if device.type == "cpu" else "nccl")
    if cfg.get("stepper_type", "dyffusion") == "ace":
        return _main_ace(cfg, device)
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

    names = list(dict.fromkeys(list(exp.in_packer.names) + list(exp.forcing_names)
                               + ([mask_name] if mask_name else [])))
    source, n_repeats = _source(cfg, names, exp.model.cfg.img_shape)
    icfg = InferenceConfig(
        n_forward_steps=int(cfg.get("n_forward_steps", 100)),
        forward_steps_in_memory=int(cfg.get("forward_steps_in_memory", 50)),
        n_ensemble=int(cfg.get("n_ensemble", 1)), n_repeats=n_repeats,
        seed=int(cfg.get("seed", 0)))

    out_dir = cfg.get("experiment_dir", "results/inference")
    os.makedirs(out_dir, exist_ok=True)
    agg = InferenceAggregator(out_names, source.horizontal.area_weights(),
                              log_zonal_mean_images=bool(cfg.get("log_zonal_mean_images", True)),
                              normalizer=exp.normalizer.subset(out_names),
                              log_video=bool(cfg.get("log_video", False)))
    # closed after the rollout, aborted if it fails; no writer on: nothing
    # crosses to the host
    with _data_writer(cfg, out_dir, out_names, source, icfg.n_ensemble) as writer:
        summary = run_inference(stepper, source, icfg, aggregator=agg,
                                writer=writer if writer.writers else None,
                                mask_name=mask_name, verbose=bool(cfg.get("verbose", True)))
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
    _save_media(agg, out_names, out_dir)
    print(json.dumps({k: round(float(v), 5) for k, v in summary.items()}))
    return {"summary": summary, "logs": logs, "aggregator": agg, "stepper": stepper}


def _save_media(agg, names, out_dir: str) -> None:
    """The snapshot panels, the zonal-mean Hovmoellers and ``videos.nc``
    of the aggregator, as JAX's command line writes them."""
    from .evaluation.plots import plot_snapshot_panels, plot_zonal_mean_hovmoeller

    snapshots = agg.snapshots.snapshots
    if snapshots:
        plot_snapshot_panels(snapshots, names, os.path.join(out_dir, "snapshots"))
    maps = agg.zonal.get_maps() if agg.zonal is not None else None
    if maps is not None:
        plot_zonal_mean_hovmoeller(*maps, names, os.path.join(out_dir, "zonal_means"))
    if agg.video is not None:
        agg.video.save(os.path.join(out_dir, "videos.nc"))


# ---------------------------------------------------------------------------
# the ACE path
# ---------------------------------------------------------------------------


def _main_ace(cfg: dict, device) -> dict:
    from .inference.stepper import round_params
    from .interface import load_ace_stepper_checkpoint, load_experiment_checkpoint
    from .utils.checkpointing import resolve_checkpoint_path

    _guard_ace_knobs(cfg)  # before any checkpoint is read
    path = resolve_checkpoint_path(cfg["checkpoint_path"])
    ck = _load_if_ace_torch_checkpoint(path)
    if ck is not None:
        overrides = dict(cfg.get("overrides") or {})
        if set(overrides) - {"model"}:
            raise ValueError(
                f"overrides {sorted(set(overrides) - {'model'})}: a native ACE checkpoint takes "
                "only overrides['model'] (over its builder config); its physics come from the "
                "run config's corrector, ocean and sigma_coordinates")
        stepper, _ = load_ace_stepper_checkpoint(path, device=device,
                                                 model_overrides=overrides.get("model"),
                                                 _preloaded=ck)
        stepper = _apply_ace_physics_overrides(cfg, stepper)
        if cfg.get("params_dtype"):
            round_params(stepper.module, cfg["params_dtype"])
        source, n_repeats = _source(cfg, stepper.cfg.all_names, tuple(stepper.area.shape),
                                     ace=True)
        return _run_ace_rollout(cfg, stepper, source, n_repeats)
    exp, _, ema_params, full_cfg = load_experiment_checkpoint(
        path, overrides=cfg.get("overrides"), device=device)
    if bool(cfg.get("use_ema", True)) and ema_params is not None:
        exp.model.load_state_dict(ema_params)
    return _run_ace_from_checkpoint(cfg, exp, full_cfg, device)


def _load_if_ace_torch_checkpoint(path: str) -> Optional[dict]:
    """The loaded payload when ``path`` is a native ACE checkpoint (read
    once here and passed to the loader), else None."""
    from .interface import ace_stepper_state, is_torch_file, read_torch_checkpoint

    if not is_torch_file(path):
        return None
    payload = read_torch_checkpoint(path)
    return payload if ace_stepper_state(payload) is not None else None


def _ocean_cfg_from(o: dict):
    """An ocean or prescriber block -> ``OceanConfig``."""
    from .inference.ocean import OceanConfig, SlabOceanConfig

    if int(o.get("mask_value", 1)) != 1:
        raise ValueError(
            "the ACE ocean prescribes where round(mask) == 1; "
            f"mask_value={o['mask_value']} would be silently inverted; invert the mask "
            "variable instead")
    slab = o.get("slab")
    return OceanConfig(o.get("surface_temperature_name") or o.get("prescribed_name"),
                       o.get("ocean_fraction_name") or o.get("mask_name"),
                       interpolate=bool(o.get("interpolate", False)),
                       slab=SlabOceanConfig(**slab) if slab else None)


def _apply_ace_physics_overrides(cfg: dict, stepper):
    """The run config's ``ocean`` (or ``prescriber``), ``corrector`` and
    ``sigma_coordinates`` over the native checkpoint's physics; a new
    physics-only field gets mean 0 and std 1."""
    o = cfg.get("ocean") or cfg.get("prescriber")
    co = cfg.get("corrector")
    sg = cfg.get("sigma_coordinates")
    if not (o or co or sg):
        return stepper
    from .data.coords import SigmaCoordinates
    from .inference.ace_stepper import SingleStepStepper, SingleStepStepperConfig
    from .inference.corrector import CorrectorConfig
    from .interface import ace_normalizer

    new_cfg = SingleStepStepperConfig(
        in_names=list(stepper.cfg.in_names), out_names=list(stepper.cfg.out_names),
        loss=stepper.cfg.loss, corrector=CorrectorConfig(**co) if co else stepper.cfg.corrector,
        ocean=_ocean_cfg_from(o) if o else stepper.cfg.ocean)
    st = stepper.normalizer.get_state()
    names = list(dict.fromkeys(list(stepper.normalizer.names) + list(new_cfg.all_names)))
    return SingleStepStepper(new_cfg, stepper.model_fn,
                             ace_normalizer(st["means"], st["stds"], names), stepper.area,
                             sigma=SigmaCoordinates.from_dict(sg) if sg else stepper.sigma,
                             device=stepper.device, module=stepper.module)


def _guard_ace_knobs(cfg: dict) -> None:
    for k in ("n_ensemble", "preds_dtype"):
        if cfg.get(k) not in (None, 1):
            raise ValueError(
                f"{k!r} is not supported on the ACE path (a deterministic single-member "
                "stepper whose fields stay float32); drop the key or use the DYffusion "
                "stepper")


def _run_ace_from_checkpoint(cfg: dict, exp, full_cfg: dict, device) -> dict:
    """A ``SingleStepStepper`` around a loaded one-step experiment, then the
    windowed ACE rollout."""
    import torch

    from .data.coords import SigmaCoordinates
    from .inference.ace_stepper import SingleStepStepper, SingleStepStepperConfig
    from .inference.corrector import CorrectorConfig
    from .inference.stepper import round_params
    from .interface import ace_normalizer

    if getattr(exp, "horizon_at_once", 1) != 1:
        raise ValueError(f"stepper_type=ace needs a one-step model (horizon_at_once="
                         f"{exp.horizon_at_once})")
    if getattr(exp.cfg, "window", 1) != 1:
        raise ValueError(f"stepper_type=ace needs a single-frame input window (window="
                         f"{exp.cfg.window})")
    state_names = list(exp.in_packer.names)
    out_names = list(exp.out_packer.names)
    forcing_names = [n for n in (getattr(exp, "forcing_names", None) or [])
                     if n not in state_names]
    in_names = state_names + forcing_names
    # the run config's ocean, else the checkpoint's prescriber: a model
    # trained with prescribed SST does not roll out free-running
    o = (cfg.get("ocean") or cfg.get("prescriber")
         or full_cfg.get("datamodule", {}).get("prescriber"))
    ocean_cfg = _ocean_cfg_from(o) if o else None
    corr = cfg.get("corrector")
    st = exp.normalizer.get_state()
    means, stds = dict(st["means"]), dict(st["stds"])
    fnorm = getattr(exp, "forcing_normalizer", None)
    if fnorm is not None:
        fst = fnorm.get_state()
        means.update(fst["means"])
        stds.update(fst["stds"])
    all_names = list(dict.fromkeys(in_names + out_names
                                   + (list(ocean_cfg.names) if ocean_cfg else [])))
    model = exp.model
    model.eval()
    if cfg.get("params_dtype"):
        round_params(model, cfg["params_dtype"])
    n_state = len(state_names)
    wants_time = bool(model.cfg.with_time_emb)

    def model_fn(x_norm: torch.Tensor) -> torch.Tensor:
        kwargs = {"deterministic": True}
        if forcing_names:
            kwargs["static_condition"] = x_norm[..., n_state:]
        if wants_time:
            kwargs["time"] = torch.zeros((x_norm.shape[0],), device=x_norm.device)
        return model(x_norm[..., :n_state], **kwargs)

    source, n_repeats = _source(cfg, all_names, model.cfg.img_shape, ace=True)
    sg = cfg.get("sigma_coordinates")
    stepper = SingleStepStepper(
        SingleStepStepperConfig(in_names=in_names, out_names=out_names,
                                corrector=CorrectorConfig(**corr) if corr else None,
                                ocean=ocean_cfg),
        model_fn, ace_normalizer(means, stds, all_names), source.horizontal.area_weights(),
        sigma=SigmaCoordinates.from_dict(sg) if sg else source.sigma, device=device,
        module=model)
    return _run_ace_rollout(cfg, stepper, source, n_repeats)


def _run_ace_rollout(cfg: dict, stepper, source, n_repeats: int) -> dict:
    """Both ACE entries' tail: the aggregator, the rollout, ``metrics.json``."""
    from .evaluation.aggregators import InferenceAggregator
    from .inference.ace_stepper import ace_scored_names, run_ace_inference

    out_dir = cfg.get("experiment_dir", "results/inference_ace")
    os.makedirs(out_dir, exist_ok=True)
    derived = bool(cfg.get("derived", False))
    agg = InferenceAggregator(ace_scored_names(stepper, source, derived=derived),
                              source.horizontal.area_weights(),
                              log_zonal_mean_images=bool(cfg.get("log_zonal_mean_images", True)),
                              log_video=bool(cfg.get("log_video", False)))
    with _data_writer(cfg, out_dir, list(stepper.cfg.out_names), source, 1) as writer:
        summary = run_ace_inference(
            stepper, source, n_forward_steps=int(cfg.get("n_forward_steps", 100)),
            forward_steps_in_memory=int(cfg.get("forward_steps_in_memory", 50)),
            n_repeats=n_repeats, aggregator=agg, writer=writer if writer.writers else None,
            derived=derived,
            verbose=bool(cfg.get("verbose", True)))
    logs = agg.get_logs()
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump({**summary, **logs}, f, indent=1)
    _save_media(agg, agg.names, out_dir)
    print(json.dumps({k: round(float(v), 5) for k, v in summary.items()
                      if not isinstance(v, list)}))
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
