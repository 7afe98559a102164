"""Factory interface: config dicts -> datamodules, models, experiments, and
the checkpoints they are saved in.

Counterpart of ``spherical_dyffusion_tpu/interface.py``. Configs are the
dicts of ``utils/config.py``; a checkpoint embeds the full config
(``config_json``), so an experiment is rebuilt from the file alone.
``load_experiment_checkpoint`` reads three formats:

* the port's own checkpoint, the ``torch.save`` payload of
  ``Trainer.save_checkpoint`` (``params``, ``ema_params``, ``opt_state``,
  ``step``, ``epoch``, ``generator``, ``config_json``), read with
  ``weights_only=True``;
* the JAX package's msgpack checkpoint (``save_experiment_checkpoint``
  there), read by ``utils/flax_msgpack.py``; its trees may hold the stacked
  ``scan_layers`` layout, which ``utils/convert.py`` unstacks;
* a reference (upstream) Lightning ``.ckpt`` (``state_dict`` and
  ``hyper_parameters``), through ``load_reference_checkpoint``.

A torch file is loaded once and told apart by its keys (``config_json``:
the port's; ``state_dict`` and ``hyper_parameters``: a reference one). It is
first read with ``weights_only=True``. A file that this refuses is read
again with ``weights_only=False``, as the JAX package reads every reference
checkpoint, only if its pickle's strings (read without running it) hold no
``config_json`` and either ``state_dict`` and ``hyper_parameters`` (a
reference checkpoint whose hyperparameters hold other objects) or
``module``, ``config``, ``builder``, ``in_names`` and ``out_names`` (a native
ACE checkpoint's stepper state). Any other such file raises.

``load_ace_stepper_checkpoint`` reads a native ACE checkpoint
(``{"stepper": SingleModuleStepper.get_state()}``: weights in the reference
names, normalizer, builder config, names, ocean, corrector, area and sigma)
into a ready ``SingleStepStepper``, with the reference ACE builder's
defaults for the keys its config leaves out (``data_grid`` legendre-gauss),
the scale factor read from the position embedding, erf gelu and two-pass
norm statistics, and identity statistics for physics-only fields; a model
section (``overrides["model"]`` of a run config) goes over the builder
config, and sets ``use_pallas`` and ``fused_tail`` there.

Models are built on the device that the config names: ``platform: cpu``
runs on the CPU; otherwise the CUDA card, and without one ``resolve_device``
raises rather than fall back. One departure: a DYffusion experiment that
loads its interpolator from ``diffusion.interpolator_checkpoint_path`` also
deep-merges ``interpolator_model`` (a model section) into that
interpolator's config, as the JAX reference loader does for reference
checkpoints; the JAX package ignores the key for its own checkpoints. The
``fv3gfs`` datamodule reads netCDF directories and its statistics files
(``data/datamodule.py:FV3GFSDataModule``). A reference checkpoint of a UNet
raises as in JAX: its loader reads an SFNO's architecture from the weights
(``infer_sfno_architecture``: "state_dict holds no SFNO blocks"), and
neither package converts the reference UNet's names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import pickletools
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .data.datamodule import DataModuleConfig, DebugDataModule, FV3GFSDataModule
from .data.normalization import StandardNormalizer, get_normalizer
from .data.packer import Packer
from .diffusion.dyffusion import DYffusionConfig, build_schedule
from .models.sfno import SFNO, SFNOConfig
from .models.unet import UNet, UNetConfig
from .training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
    SimultaneousForecastingExperiment,
)
from .utils import flax_msgpack
from .utils.checkpointing import resolve_checkpoint_path
from .utils.config import deep_update
from .utils.convert import flax_to_state_dict
from .utils.torch_convert import (
    ema_backbone_state_dict,
    infer_sfno_architecture,
    lightning_parts,
    load_lightning_checkpoint,
    sfno_torch_to_flax,
    split_reference_state_dict,
    translate_reference_hparams,
)

__all__ = ["resolve_device", "get_datamodule", "get_model", "get_experiment",
           "save_experiment_checkpoint", "load_experiment_checkpoint",
           "load_reference_checkpoint", "load_ace_stepper_checkpoint", "ace_stepper_state",
           "read_torch_checkpoint", "is_torch_file", "ace_normalizer", "ACE_BUILDER_DEFAULTS"]

_TIME_KEYS = {"img_shape", "in_chans", "out_chans", "with_time_emb", "min_time", "max_time"}


def resolve_device(cfg: Dict[str, Any]) -> torch.device:
    """The device a config runs on: the CPU for ``platform: cpu``, else the
    CUDA card; raises without one."""
    platform = str(cfg.get("platform") or "cuda").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"platform {platform!r}: the port runs on 'cuda' (the default) or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; set platform: cpu (platform=cpu on the "
                           "command line) to run on the CPU")
    return torch.device("cuda")


def _fields(cls, d: Dict[str, Any], drop=()) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names and k not in drop}


def get_datamodule(cfg: Dict[str, Any]):
    """cfg['datamodule'] -> datamodule."""
    dm_cfg = dict(cfg["datamodule"])
    kind = dm_cfg.pop("kind", "debug")
    if kind == "debug":
        return DebugDataModule(**dm_cfg)
    if kind == "fv3gfs":
        return FV3GFSDataModule(DataModuleConfig(**_fields(DataModuleConfig, dm_cfg)))
    raise ValueError(f"Unknown datamodule kind {kind!r}")


def get_model(model_cfg: Dict[str, Any], img_shape: Tuple[int, int], in_chans: int,
              out_chans: int, with_time_emb: bool, min_time: float = 0.0,
              max_time: float = 1000.0, device=None,
              generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The backbone named by ``model_cfg['kind']`` (an ``SFNO`` or a
    ``UNet``; the UNet, as in JAX, takes no time range) on ``device`` (the
    CUDA card when None; raises without one), with random weights from
    ``generator`` (a generator on that device; seed 0 when None)."""
    cfg = dict(model_cfg)
    kind = cfg.pop("kind", "sfno")
    common = dict(img_shape=tuple(img_shape), in_chans=in_chans, out_chans=out_chans,
                  with_time_emb=with_time_emb)
    if kind == "sfno":
        model = SFNO(SFNOConfig(min_time=min_time, max_time=max_time, **common,
                                **_fields(SFNOConfig, cfg, _TIME_KEYS)))
    elif kind == "unet":
        kw = _fields(UNetConfig, cfg, _TIME_KEYS)
        for k in ("dim_mults", "upsample_dims"):  # JSON lists
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        model = UNet(UNetConfig(**common, **kw))
    else:
        raise ValueError(f"Unknown model kind {kind!r}")
    device = torch.device(device) if device is not None else resolve_device({})
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = model.to(device)
    model.init_weights(generator)
    return model


def _experiment_config(cfg: Dict[str, Any], horizon: int, window: int,
                       num_predictions: int) -> ExperimentConfig:
    module_cfg = cfg.get("module", {}) or {}
    return ExperimentConfig(
        horizon=horizon, window=window,
        loss_function=module_cfg.get("loss_function", "l1"),
        num_predictions=num_predictions,
        enable_inference_dropout=bool(module_cfg.get("enable_inference_dropout", False)),
        prediction_inputs_noise=float(module_cfg.get("prediction_inputs_noise", 0.0) or 0.0))


def get_experiment(cfg: Dict[str, Any], dm, device=None, seed: int = 0):
    """The experiment named by ``cfg['experiment']`` over datamodule ``dm``,
    its networks on ``device`` with random weights drawn from ``seed``. A
    DYffusion experiment loads its interpolator from
    ``diffusion.interpolator_checkpoint_path``."""
    kind = cfg.get("experiment", "interpolation")
    horizon, window = dm.cfg.horizon, dm.cfg.window
    exp_cfg = _experiment_config(cfg, horizon, window,
                                 (cfg.get("module", {}) or {}).get("num_predictions", 10))
    C = len(dm.cfg.in_names)
    CF = len(dm.cfg.forcing_names)
    HW = dm._source("train").spatial_shape
    model_cfg = cfg.get("model", {})
    device = torch.device(device) if device is not None else resolve_device(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    if kind == "interpolation":
        model = get_model(model_cfg, HW, (window + 1) * C + CF * window, len(dm.cfg.out_names),
                          with_time_emb=True, min_time=1, max_time=horizon - 1, device=device,
                          generator=gen)
        return InterpolationExperiment(model, exp_cfg, dm.in_packer, dm.out_packer,
                                       dm.normalizer)

    if kind == "dyffusion":
        diff_cfg = cfg.get("diffusion", {}) or {}
        dcfg = DYffusionConfig(timesteps=horizon, **_fields(DYffusionConfig, diff_cfg))
        ip_path = diff_cfg.get("interpolator_checkpoint_path")
        if not ip_path:
            raise ValueError("dyffusion needs diffusion.interpolator_checkpoint_path")
        # the JAX package gives the forecaster condition channels for
        # "data" only, so a "data+noise" forecaster, whose forecasts feed the
        # noised condition too, fails at its first step there (ROADMAP
        # Queue 3); the port keeps that channel count and says so here
        cond_ch = C if dcfg.forward_conditioning == "data" else 0
        if dcfg.forward_conditioning.startswith("data+noise"):
            raise ValueError(
                f"forward_conditioning {dcfg.forward_conditioning!r}: the forecaster is built "
                f"with {C + CF + cond_ch} input channels, as the JAX package builds it "
                f"(condition channels for 'data' only), but its forecasts would feed it "
                f"{2 * C + CF} (the noised condition too)")
        ip_over = {"model": cfg["interpolator_model"]} if cfg.get("interpolator_model") else None
        interpolator, _, ip_ema, _ = load_experiment_checkpoint(
            ip_path, overrides=ip_over, dm=dm, device=device)
        model = get_model(model_cfg, HW, C + CF + cond_ch, len(dm.cfg.out_names),
                          with_time_emb=True, min_time=0, max_time=horizon - 1, device=device,
                          generator=gen)
        return DYffusionForecastingExperiment(
            model, interpolator, dcfg, exp_cfg, dm.in_packer, dm.out_packer, dm.normalizer,
            forcing_names=dm.cfg.forcing_names, forcing_normalizer=dm.forcing_normalizer,
            interpolator_ema_params=ip_ema)

    if kind == "simultaneous":
        hao = (cfg.get("module", {}) or {}).get("horizon_at_once") or horizon
        model = get_model(model_cfg, HW, window * C + CF, hao * len(dm.cfg.out_names),
                          with_time_emb=False, device=device, generator=gen)
        return SimultaneousForecastingExperiment(
            model, exp_cfg, dm.in_packer, dm.out_packer, dm.normalizer, horizon_at_once=hao,
            autoregressive_loss_weights=(cfg.get("module", {}) or {}).get(
                "autoregressive_loss_weights"),
            forcing_names=dm.cfg.forcing_names, forcing_normalizer=dm.forcing_normalizer)
    raise ValueError(f"Unknown experiment {kind!r}")


# --------------------------------------------------------------------------
# checkpoints with the config embedded
# --------------------------------------------------------------------------


def save_experiment_checkpoint(path: str, trainer) -> None:
    """Write ``trainer``'s state with its run config embedded: the
    trainer's own checkpoint (``Trainer.save_checkpoint``)."""
    trainer.save_checkpoint(trainer.state, path)


def _pickle_strings(path: str) -> set:
    """The strings in a torch file's object pickle, read without running it."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            data = z.read(next(n for n in z.namelist() if n.endswith("data.pkl")))
        return {a for _, a, _ in pickletools.genops(data) if isinstance(a, str)}
    strings = set()
    with open(path, "rb") as f:  # the legacy format: magic, protocol, sys info, object
        for _ in range(4):
            strings |= {a for _, a, _ in pickletools.genops(f) if isinstance(a, str)}
    return strings


def read_torch_checkpoint(path: str):
    """A torch file's payload, read with ``weights_only=True``, else (see
    the module's docstring) only a reference or a native ACE checkpoint."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        strings = _pickle_strings(path)
        reference = {"state_dict", "hyper_parameters"} <= strings
        ace = {"module", "config", "builder", "in_names", "out_names"} <= strings
        if "config_json" in strings or not (reference or ace):
            raise pickle.UnpicklingError(
                f"{path}: refused by torch.load(weights_only=True); only a reference "
                f"checkpoint (state_dict and hyper_parameters) or a native ACE checkpoint "
                f"(module, config, builder, in_names and out_names) is read without it: {err}"
            ) from err
        return torch.load(path, map_location="cpu", weights_only=False)


def ace_stepper_state(payload) -> Optional[dict]:
    """The stepper state of a loaded native ACE checkpoint (its ``stepper``
    entry, or the dict itself, holding ``module`` and ``config``); None for
    any other payload."""
    if not isinstance(payload, dict):
        return None
    state = payload.get("stepper", payload)
    if isinstance(state, dict) and "module" in state and "config" in state:
        return state
    return None


def is_torch_file(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(2)
    return head == b"PK" or head[:1] == b"\x80"


def load_experiment_checkpoint(path: str, overrides: Optional[Dict[str, Any]] = None, dm=None,
                               device=None):
    """Rebuild ``(experiment, params, ema_params, config)`` from a checkpoint
    of any of the three formats, deep-merging ``overrides`` into the stored
    config. The weights are loaded into the experiment's networks (on
    ``device``, else the one the merged config names); ``params`` and
    ``ema_params`` are the network's ``state_dict``s (``ema_params`` None
    without an EMA)."""
    path = resolve_checkpoint_path(path)
    if is_torch_file(path):
        payload = read_torch_checkpoint(path)
        if not isinstance(payload, dict):
            raise ValueError(f"{path}: not a checkpoint dict")
        if "state_dict" in payload and "hyper_parameters" in payload:
            return load_reference_checkpoint(path, overrides=overrides, device=device,
                                             _loaded=payload)
        if "config_json" not in payload:
            raise ValueError(f"{path}: a torch file with neither config_json (the port's "
                             "checkpoint) nor state_dict and hyper_parameters (a reference "
                             f"checkpoint); keys {sorted(payload)[:8]}")
        params, ema = payload["params"], payload.get("ema_params")
    else:
        payload = flax_msgpack.read(path)
        params = flax_to_state_dict(payload["params"])
        ema = flax_to_state_dict(payload["ema_params"]) if payload.get("ema_params") else None
    config = json.loads(payload["config_json"])
    if overrides:
        config = deep_update(config, overrides)
    if dm is None:
        dm = get_datamodule(config)
    exp = get_experiment(config, dm, device=device)
    exp.model.load_state_dict(params)
    return exp, params, ema, config


def _unit_normalizer(names) -> StandardNormalizer:
    return StandardNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names},
                                         names)


def load_reference_checkpoint(path: str, overrides: Optional[Dict[str, Any]] = None,
                              device=None, _loaded: Optional[dict] = None):
    """Rebuild ``(experiment, params, ema_params, config)`` from a reference
    (upstream) Lightning checkpoint, as the JAX package's
    ``load_reference_checkpoint`` does: ``hyper_parameters`` translated to
    the config schema (the SFNO with ``gelu_exact``, ``exact_norm`` and
    ``exact_dropout``), packers from the datamodule names with the forcings
    taken out of the state, the weights mapped through the flax names, the
    architecture read from the weights, and for a DYffusion checkpoint the
    interpolator embedded in the forecaster's ``state_dict`` (else
    ``overrides['interpolator_checkpoint_path']`` or the config's),
    patched by ``overrides['interpolator_model']``; LitEma shadows
    (``model_ema.*``) become ``ema_params``. The normalizers come from the
    statistics files ``centering.nc`` and ``scaling.nc`` in
    ``datamodule.data_dir_stats`` (else ``data_dir``); without them the
    normalization is the identity and ``config['_unit_normalization']`` is
    set, as in JAX."""
    sd, hparams = lightning_parts(_loaded) if _loaded is not None else \
        load_lightning_checkpoint(path)
    config = translate_reference_hparams(hparams)
    if overrides:
        config = deep_update(config, dict(overrides))
    device = torch.device(device) if device is not None else resolve_device(config)
    parts = split_reference_state_dict(sd)

    dm_cfg = dict(config.get("datamodule", {}))
    in_names_all = list(dm_cfg.get("in_names", []))
    forcing_names = list(dm_cfg.get("forcing_names", []) or [])
    out_names = list(dm_cfg.get("out_names", []) or in_names_all)
    state_names = [n for n in in_names_all if n not in forcing_names]
    if not state_names:
        raise ValueError("checkpoint hyper_parameters carry no usable datamodule in_names")
    horizon = int(dm_cfg.get("horizon", 6))
    window = int(dm_cfg.get("window", 1))

    stats_dir = dm_cfg.get("data_dir_stats") or dm_cfg.get("data_dir")
    norm_names = list(dict.fromkeys(state_names + out_names))
    mean_p = os.path.join(str(stats_dir), "centering.nc") if stats_dir else ""
    if stats_dir and os.path.exists(mean_p):
        std_p = os.path.join(str(stats_dir), "scaling.nc")
        normalizer = get_normalizer(mean_p, std_p, norm_names)
        forcing_normalizer = (get_normalizer(mean_p, std_p, forcing_names)
                              if forcing_names else None)
    else:
        normalizer = _unit_normalizer(norm_names)
        forcing_normalizer = _unit_normalizer(forcing_names) if forcing_names else None
        config["_unit_normalization"] = True
    normalizer = normalizer.subset(state_names)

    exp_cfg = _experiment_config(config, horizon, window, int(
        (config.get("module", {}) or {}).get("num_predictions", 1) or 1))
    model_cfg = dict(config.get("model", {}))
    model_cfg.pop("kind", None)

    def build_sfno(net_sd, min_time, max_time, extra_model_cfg=None):
        arch = infer_sfno_architecture(net_sd)
        img_shape = (tuple(np.asarray(net_sd["pos_embed"]).shape[2:4]) if "pos_embed" in net_sd
                     else tuple(dm_cfg.get("spatial_shape", (180, 360))))
        cfg_kwargs = dict(model_cfg)
        if extra_model_cfg:
            cfg_kwargs.update(extra_model_cfg)
        # architecture facts recovered from the weights win over the config
        cfg_kwargs.update({k: arch[k] for k in (
            "embed_dim", "num_layers", "encoder_layers", "operator_type", "pos_embed",
            "use_mlp", "mlp_ratio", "filter_type", "spectral_layers")})
        c = SFNOConfig(img_shape=img_shape, in_chans=arch["net_in_chans"],
                       out_chans=arch["net_out_chans"], with_time_emb=arch["with_time_emb"],
                       min_time=min_time, max_time=max_time,
                       **_fields(SFNOConfig, cfg_kwargs, _TIME_KEYS))
        model = SFNO(c).to(device)

        def convert(torch_sd):
            return flax_to_state_dict(sfno_torch_to_flax(torch_sd, arch["num_layers"],
                                                         arch["encoder_layers"]))

        params = convert(net_sd)
        model.load_state_dict(params)
        return model, params, convert

    if parts["kind"] == "interpolation":
        model, params, convert = build_sfno(parts["backbone"], 1, max(horizon - 1, 1))
        exp = InterpolationExperiment(model, exp_cfg, Packer(state_names), Packer(out_names),
                                      normalizer)
        ema_sd = (ema_backbone_state_dict(parts["backbone"], parts["ema"], "")
                  if parts["ema"] else None)
        config.setdefault("experiment", "interpolation")
        return exp, params, convert(ema_sd) if ema_sd else None, config

    interp_sd = parts["interpolator"]
    ip_override = (overrides or {}).get("interpolator_checkpoint_path") or (
        config.get("diffusion", {}) or {}).get("interpolator_checkpoint_path")
    interp_model_cfg = (overrides or {}).get("interpolator_model")
    if interp_sd is None and ip_override:
        ip_sd_full, ip_hp = load_lightning_checkpoint(str(ip_override))
        interp_sd = split_reference_state_dict(ip_sd_full)["backbone"]
        interp_model_cfg = interp_model_cfg or dict(
            translate_reference_hparams(ip_hp).get("model", {}))
        if interp_model_cfg:
            interp_model_cfg.pop("kind", None)
    if interp_sd is None:
        raise ValueError("DYffusion checkpoint has no embedded interpolator weights; pass "
                         "overrides={'interpolator_checkpoint_path': <ckpt>}")
    dcfg = DYffusionConfig(timesteps=horizon,
                           **_fields(DYffusionConfig, config.get("diffusion", {})))
    if dcfg.hack_for_imprecise_interpolation and state_names[0] in out_names:
        raise ValueError("hack_for_imprecise_interpolation requires the first in_name "
                         f"({state_names[0]}) to be input-only (not in out_names)")
    interp_model, _, _ = build_sfno(interp_sd, 1, max(horizon - 1, 1),
                                    extra_model_cfg=interp_model_cfg)
    interp_exp = InterpolationExperiment(
        interp_model, dataclasses.replace(exp_cfg, enable_inference_dropout=bool(
            dcfg.enable_interpolator_dropout)),
        Packer(state_names), Packer(out_names), normalizer)
    tmin, tmax = build_schedule(dcfg).forecaster_time_range
    fc_model, params, convert = build_sfno(parts["backbone"], tmin, tmax)
    exp = DYffusionForecastingExperiment(
        fc_model, interp_exp, dcfg, exp_cfg, Packer(state_names), Packer(out_names),
        normalizer, forcing_names=forcing_names, forcing_normalizer=forcing_normalizer)
    ema_sd = (ema_backbone_state_dict(parts["backbone"], parts["ema"], "model.")
              if parts["ema"] else None)
    config.setdefault("experiment", "dyffusion")
    return exp, params, convert(ema_sd) if ema_sd else None, config


# the reference ACE builder's defaults: a stored builder config holds only
# the keys its training config set, so these, not SFNOConfig's defaults,
# fill the rest (notably data_grid, legendre-gauss where the port's default
# is equiangular)
ACE_BUILDER_DEFAULTS = {
    "spectral_transform": "sht",
    "operator_type": "diagonal",
    "scale_factor": 16,
    "hard_thresholding_fraction": 1.0,
    "normalization_layer": "instance_norm",
    "activation_function": "gelu",
    "big_skip": True,
    "rank": 1.0,
    "factorization": None,
    "separable": False,
    "complex_activation": "real",
    "data_grid": "legendre-gauss",
}
# the reference loss names -> the port's criteria: LpLoss is the relative L2
# norm; AreaWeightedMSE is read as plain MSE (the stepper's loss is a rollout
# diagnostic here, not a training objective)
ACE_LOSSES = {"LpLoss": "l2_rel", "MSE": "l2", "AreaWeightedMSE": "l2"}


def load_ace_stepper_checkpoint(path: str, device=None,
                                model_overrides: Optional[Mapping[str, Any]] = None,
                                _preloaded: Optional[dict] = None):
    """A native ACE checkpoint (``torch.save({"stepper": state, ...})``,
    read by ``read_torch_checkpoint`` unless ``_preloaded`` holds it) as
    ``(SingleStepStepper, the stored config)`` on ``device`` (the CUDA card
    when None; raises without one). The SFNO takes its architecture from
    the weights, the builder config and then ``model_overrides`` (SFNO
    config fields, ``use_pallas`` and ``fused_tail`` among them) over
    ``ACE_BUILDER_DEFAULTS``, the scale factor from ``pos_embed`` where it
    divides the grid, erf gelu for "gelu" and ``exact_norm``; fields of the
    names or the ocean without statistics get mean 0 and std 1."""
    from .data.coords import SigmaCoordinates
    from .inference.ace_stepper import SingleStepStepper, SingleStepStepperConfig
    from .inference.corrector import CorrectorConfig
    from .inference.ocean import OceanConfig, SlabOceanConfig

    ck = (_preloaded if _preloaded is not None
          else read_torch_checkpoint(resolve_checkpoint_path(path)))
    state = ace_stepper_state(ck)
    if state is None:
        raise ValueError(f"{path}: not a native ACE checkpoint (no stepper with module and "
                         "config)")
    device = torch.device(device) if device is not None else resolve_device({})
    cfgd = dict(state["config"])
    builder = dict(cfgd.get("builder") or {})
    if builder.get("type") != "SphericalFourierNeuralOperatorNet":
        raise NotImplementedError(f"ACE module type {builder.get('type')!r}; only the SFNO "
                                  "family is implemented")
    sd = {k: np.asarray(v) for k, v in state["module"].items()}
    if sd and all(k.startswith("module.") for k in sd):  # a DDP-wrapped module
        sd = {k[len("module."):]: v for k, v in sd.items()}
    arch = infer_sfno_architecture(sd)
    area_np = np.asarray(state["area"], np.float32)
    img_shape = tuple(state.get("img_shape") or area_np.shape)
    bcfg = {**ACE_BUILDER_DEFAULTS, **dict(builder.get("config") or {}),
            **dict(model_overrides or {})}
    cfg_kwargs = _fields(SFNOConfig, bcfg, _TIME_KEYS)
    cfg_kwargs.update({k: arch[k] for k in (
        "embed_dim", "num_layers", "encoder_layers", "operator_type", "pos_embed", "use_mlp",
        "mlp_ratio", "filter_type", "spectral_layers")})
    if "pos_embed" in sd:  # on the model grid, img_shape // scale_factor
        pe_h = int(sd["pos_embed"].shape[2])
        if pe_h and img_shape[0] % pe_h == 0:
            cfg_kwargs["scale_factor"] = img_shape[0] // pe_h
    if cfg_kwargs.get("activation_function") == "gelu":
        cfg_kwargs["activation_function"] = "gelu_exact"
    cfg_kwargs["exact_norm"] = True
    mcfg = SFNOConfig(img_shape=img_shape, in_chans=arch["net_in_chans"],
                      out_chans=arch["net_out_chans"], with_time_emb=arch["with_time_emb"],
                      **cfg_kwargs)
    model = SFNO(mcfg).to(device)
    model.load_state_dict(flax_to_state_dict(sfno_torch_to_flax(sd, arch["num_layers"],
                                                                arch["encoder_layers"])))
    model.eval()

    in_names, out_names = list(cfgd["in_names"]), list(cfgd["out_names"])
    oc = cfgd.get("ocean")
    ocean_cfg = None
    if oc:
        slab = oc.get("slab")
        ocean_cfg = OceanConfig(oc["surface_temperature_name"], oc["ocean_fraction_name"],
                                interpolate=bool(oc.get("interpolate", False)),
                                slab=SlabOceanConfig(**slab) if slab else None)
    co = dict(cfgd.get("corrector") or {})
    corrector_cfg = CorrectorConfig(
        conserve_dry_air=bool(co.get("conserve_dry_air", False)),
        zero_global_mean_moisture_advection=bool(
            co.get("zero_global_mean_moisture_advection", False)),
        moisture_budget_correction=co.get("moisture_budget_correction")) if co else None
    all_names = list(dict.fromkeys(in_names + out_names
                                   + (list(ocean_cfg.names) if ocean_cfg else [])))
    normalizer = ace_normalizer(state["normalizer"]["means"], state["normalizer"]["stds"],
                                 all_names)
    sc = state.get("sigma_coordinates")
    sigma = SigmaCoordinates.from_dict(sc) if sc else None
    loss = cfgd.get("loss")
    ref_loss = str(loss.get("type", "LpLoss")) if isinstance(loss, dict) else "LpLoss"

    def model_fn(x_norm: torch.Tensor) -> torch.Tensor:
        return model(x_norm, deterministic=True)

    stepper = SingleStepStepper(
        SingleStepStepperConfig(in_names=in_names, out_names=out_names,
                                loss=ACE_LOSSES.get(ref_loss, "l2"), corrector=corrector_cfg,
                                ocean=ocean_cfg),
        model_fn, normalizer, torch.from_numpy(area_np), sigma=sigma, device=device,
        module=model)
    return stepper, cfgd


def ace_normalizer(means, stds, names) -> StandardNormalizer:
    """Statistics over ``names``: the given ones, mean 0 and std 1 for a
    name without them."""
    return StandardNormalizer.from_dicts({n: float(means.get(n, 0.0)) for n in names},
                                         {n: float(stds.get(n, 1.0)) for n in names}, names)
