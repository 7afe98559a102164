"""Full-inference-window parity: a float64 numpy oracle of the reference
DYffusion window, and the check of the port's window against it.

``NumpyDYffusionWindowOracle`` is a copy of the JAX package's
``utils/parity_window.py`` over the port's ``DYffusionConfig`` and
``build_schedule``: the interpolator and forecaster (two
``utils/parity.py:NumpySFNOOracle``) under the cold sampler with the
``hack_for_imprecise_interpolation`` channel order, the prescriber overwrite
and the autoregressive hand-off, in float64 numpy, channels first, over the
two reference-format torch ``state_dict``s; no torch in its arithmetic.

``run_window_parity_check`` is the port's counterpart of
``scripts/parity_check.py:run_window_parity_check``: it loads a
reference-format forecaster checkpoint (its interpolator embedded, or
beside it) through ``interface.load_reference_checkpoint`` on a device (the
card unless told), runs one inference window of ``DYffusionStepper`` with
the interpolator's dropout off, re-runs the window through the oracle from
the checkpoint's ``state_dict``s, and asserts each step's max |diff| in
normalized space. ``fabricate_reference_checkpoints`` writes a checkpoint
pair and its statistics files in the reference format (``torch.save`` of
``state_dict`` and ``hyper_parameters``, LitEma shadows) from seeded port
SFNOs. Parity runs with the interpolator's dropout off on both sides: its
Bernoulli draws cannot match between numpy and torch; every weight,
transform and the sampler's algebra are covered.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion.dyffusion import DYffusionConfig, build_schedule
from .parity import NumpySFNOOracle

__all__ = ["NumpyDYffusionWindowOracle", "fabricate_reference_checkpoints",
           "window_inputs", "reference_oracles", "oracle_window", "load_parity_stepper",
           "run_window_parity_check"]


class NumpyDYffusionWindowOracle:
    """Numpy f64 re-implementation of the reference inference window.

    Channels-first throughout (B, C, H, W), matching the reference layout.

    Args:
        interpolator: oracle over the interpolator's torch state_dict; its
            network consumes ``concat([x_end_state, x_last_state])`` (+ static
            condition) at interpolation time t and emits the out channels
            (reference ``DYffusion._interpolate``, dyffusion.py:642-662).
        forecaster: oracle over the forecaster backbone's torch state_dict;
            consumes x_t (+ forward conditioning + static condition) at the
            encoded diffusion time (reference ``predict_x_last``,
            dyffusion.py:299-355).
        cfg: the DYffusion configuration (must have
            ``enable_interpolator_dropout`` falsy for determinism).
        out_channel_indices: positions of the out (predicted) channels inside
            the state channel order. Under ``hack_for_imprecise_interpolation``
            the state is [HGTsfc] + out_names, so this is ``[1..C_state-1]``.
        prescribed_channel: index of the prescribed variable within the OUT
            channels (None = no prescriber), with ``mask_value``/
            ``interpolate_mask`` as in the reference Prescriber
            (src/ace_inference/core/prescriber.py:8-99).
    """

    def __init__(
        self,
        interpolator: NumpySFNOOracle,
        forecaster: NumpySFNOOracle,
        cfg: DYffusionConfig,
        out_channel_indices: Optional[np.ndarray] = None,
        prescribed_channel: Optional[int] = None,
        mask_value: int = 1,
        interpolate_mask: bool = False,
    ):
        # Deterministic parity requires dropout OFF (draws cannot match
        # between numpy and jax). The STOCHASTIC leg instead passes an rng to
        # run_window: interpolator dropout runs float-bernoulli at the exact
        # rate on both sides and ensemble statistics are compared.
        if (cfg.enable_interpolator_dropout not in (False, None)
                and interpolator.dropout_mlp <= 0.0):
            raise ValueError(
                "enable_interpolator_dropout=True requires the interpolator "
                "oracle to be built with its dropout_mlp rate (stochastic "
                "leg) — or disable it for deterministic parity"
            )
        self.interp = interpolator
        self.fc = forecaster
        self.cfg = cfg
        self.sched = build_schedule(cfg)
        self.out_idx = (
            np.asarray(out_channel_indices, np.int64)
            if out_channel_indices is not None else None
        )
        self.prescribed_channel = prescribed_channel
        self.mask_value = mask_value
        self.interpolate_mask = interpolate_mask

    # ----------------------------------------------------------- network ops
    def _interpolate(self, x_end: np.ndarray, x_last: np.ndarray,
                     i_t: float, static: Optional[np.ndarray],
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Reference ``DYffusion._interpolate`` (dyffusion.py:642-662):
        x_end in state channels, x_last in forecaster-out channels; returns
        state channels (hack prepend on both sides when configured). ``rng``
        activates the interpolator's train-mode dropout (the reference keeps
        the interpolator in train mode during sampling when
        ``enable_interpolator_dropout``, dyffusion.py:226-240)."""
        B = x_end.shape[0]
        if self.cfg.hack_for_imprecise_interpolation:
            x_last = np.concatenate([x_end[:, :1], x_last], axis=1)
        inputs = np.concatenate([x_end, x_last], axis=1)
        t = np.full((B,), float(i_t), np.float64)
        out, _ = self.interp.forward(
            inputs, time=t, static_condition=static, collect=False, rng=rng
        )
        if self.cfg.hack_for_imprecise_interpolation:
            out = np.concatenate([x_end[:, :1], out], axis=1)
        return out

    def _predict_x_last(self, initial_condition: np.ndarray, x_t: np.ndarray,
                        s: int, static: Optional[np.ndarray]) -> np.ndarray:
        """Reference ``predict_x_last`` + ``_predict_last_dynamics``
        (dyffusion.py:286-355) for the deterministic conditionings."""
        cfg, sched = self.cfg, self.sched
        B = initial_condition.shape[0]
        if cfg.forward_conditioning == "data":
            cond = initial_condition
        elif cfg.forward_conditioning == "none":
            cond = None
        else:
            raise ValueError(
                f"window parity supports deterministic conditioning only, "
                f"got {cfg.forward_conditioning!r}"
            )
        t_enc = float(sched.encode_time(float(s)))
        out, _ = self.fc.forward(
            x_t, time=np.full((B,), t_enc, np.float64), condition=cond,
            static_condition=static, collect=False,
        )
        return out

    # --------------------------------------------------------- cold sampling
    def sample(self, initial_condition: np.ndarray,
               static: Optional[np.ndarray] = None,
               rng: Optional[np.random.Generator] = None,
               ) -> Tuple[Dict[int, np.ndarray], Optional[np.ndarray]]:
        """One full sampling pass (reference sample_loop, dyffusion.py:457-567).

        Returns ``(preds, ar_init)`` where preds maps dynamical step h (1..H)
        to (B, C_out, H, W) and ar_init is the autoregressive hand-off in out
        channels (None unless the config produces one). ``rng`` drives the
        interpolator's dropout when ``enable_interpolator_dropout``."""
        cfg, sched = self.cfg, self.sched
        rng = rng if cfg.enable_interpolator_dropout else None
        steps = list(sched.sampling_steps)
        N = sched.num_timesteps
        last_plus_one = steps[-1] + 1
        s_next_list = steps[1:] + [last_plus_one]
        s_nnext_list = steps[2:] + [last_plus_one, last_plus_one + 1]

        def hack_prepend(x):
            return np.concatenate([initial_condition[:, :1], x], axis=1)

        x_s = initial_condition
        preds: Dict[int, np.ndarray] = {}
        ar_init = None
        xhat = None
        dynamics_pred_step = 0
        for s, s_next, s_nnext in zip(steps, s_next_list, s_nnext_list):
            is_first = s == 0
            is_last = s == N - 1
            xhat = self._predict_x_last(initial_condition, x_s, s, static)
            xhat_state = (hack_prepend(xhat)
                          if cfg.hack_for_imprecise_interpolation else xhat)

            time_i_n = float(sched.d_to_i(s_next)) if not is_last else math.inf
            is_dynamics_pred = float(time_i_n).is_integer() or is_last

            if s_next <= N - 1:
                x_int_next = self._interpolate(
                    initial_condition, xhat, float(sched.d_to_i(s_next)),
                    static, rng=rng,
                )
            else:
                assert is_last
                x_int_next = xhat_state

            if cfg.sampling_type == "cold":
                if not cfg.use_cold_sampling_for_last_step and is_last:
                    if cfg.cold_ar_init:
                        x_int_s = self._interpolate(
                            initial_condition, xhat, float(sched.d_to_i(s)),
                            static, rng=rng,
                        )
                        ar = x_s + xhat_state - x_int_s
                        if cfg.hack_for_imprecise_interpolation:
                            ar = ar[:, 1:]
                        ar_init = ar
                    x_s = xhat_state
                else:
                    if s > 0:
                        x_int_s = self._interpolate(
                            initial_condition, xhat, float(sched.d_to_i(s)),
                            static, rng=rng,
                        )
                    else:
                        x_int_s = x_s
                    x_s = x_s + x_int_next - x_int_s
            elif cfg.sampling_type == "naive":
                x_s = x_int_next
            else:
                raise ValueError(cfg.sampling_type)

            dynamics_pred_step = (int(time_i_n) if s < N - 1
                                  else dynamics_pred_step + 1)
            if is_dynamics_pred:
                p = (x_s if (cfg.use_cold_sampling_for_intermediate_steps
                             or is_last) else x_int_next)
                if cfg.hack_for_imprecise_interpolation:
                    p = p[:, 1:]
                preds[dynamics_pred_step] = p

        if cfg.refine_intermediate_predictions:
            dyn_steps = cfg.prediction_timesteps or list(
                sched.dynamical_steps.values())
            for i_n in [i for i in dyn_steps if i < N]:
                p = self._interpolate(initial_condition, xhat, float(i_n),
                                      static, rng=rng)
                if cfg.hack_for_imprecise_interpolation:
                    p = p[:, 1:]
                preds[int(i_n) if float(i_n).is_integer() else i_n] = p
        return preds, ar_init

    # ------------------------------------------------------------ prescriber
    def _prescribe(self, pred_out: np.ndarray, target: Optional[np.ndarray],
                   mask: Optional[np.ndarray]) -> np.ndarray:
        """Reference Prescriber.__call__ on the packed out channels
        (prescriber.py:60-99): overwrite the prescribed channel with the
        target where mask == mask_value (or lerp when interpolate)."""
        if self.prescribed_channel is None or target is None or mask is None:
            return pred_out
        ch = self.prescribed_channel
        gen = pred_out[:, ch]
        if self.interpolate_mask:
            new = mask * target + (1.0 - mask) * gen
        else:
            region = np.rint(mask).astype(np.int64) == self.mask_value
            new = np.where(region, target, gen)
        out = pred_out.copy()
        out[:, ch] = new
        return out

    # ----------------------------------------------------------- window loop
    def run_window(
        self,
        x0_state_norm: np.ndarray,  # (B, C_state, H, W) normalized
        n_steps: int,
        forcing_norm: Optional[np.ndarray] = None,  # (B, T+1, Cf, H, W) normalized
        prescribed_target_norm: Optional[np.ndarray] = None,  # (B, T+1, H, W)
        mask: Optional[np.ndarray] = None,  # (B, T+1, H, W) raw
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The reference window loop (run_on_batch_multistep,
        stepper_multistep.py:362-427): every ``horizon`` steps one sampling
        pass runs from the last (prescribed) prediction; intermediate horizons
        come from the same pass; the prescriber overwrites every emitted step
        with the time-t target/mask; non-predicted input channels (HGTsfc
        under the hack) carry over across the hand-off.

        Returns ``(final_state (B, C_state, H, W), preds (B, n_steps, C_out,
        H, W))`` in normalized space.
        """
        cfg = self.cfg
        H_hor = cfg.timesteps
        x = np.asarray(x0_state_norm, np.float64)
        C_state = x.shape[1]
        out_idx = (self.out_idx if self.out_idx is not None
                   else np.arange(C_state))
        carry_idx = np.asarray(
            [i for i in range(C_state) if i not in set(out_idx.tolist())],
            np.int64,
        )
        emitted = []
        t_global = 0
        while t_global < n_steps:
            steps_this = min(H_hor, n_steps - t_global)
            static = (np.asarray(forcing_norm[:, t_global], np.float64)
                      if forcing_norm is not None else None)
            preds, ar_init = self.sample(x, static, rng=rng)
            seg_preds = []
            for h in range(1, steps_this + 1):
                t_abs = t_global + h
                p = self._prescribe(
                    preds[h],
                    prescribed_target_norm[:, t_abs]
                    if prescribed_target_norm is not None else None,
                    mask[:, t_abs] if mask is not None else None,
                )
                seg_preds.append(p)
            emitted.extend(seg_preds)
            # autoregressive hand-off (stepper_multistep.py:412-426)
            if ar_init is not None and steps_this == H_hor:
                t_abs = t_global + H_hor
                last = self._prescribe(
                    ar_init,
                    prescribed_target_norm[:, t_abs]
                    if prescribed_target_norm is not None else None,
                    mask[:, t_abs] if mask is not None else None,
                )
            else:
                last = seg_preds[-1]
            x_next = np.zeros_like(x)
            x_next[:, out_idx] = last
            if carry_idx.size:
                x_next[:, carry_idx] = x[:, carry_idx]
            x = x_next
            t_global += steps_this
        return x, np.stack(emitted, axis=1)


# ----------------------------------------------- the reference-format pair

def fabricate_reference_checkpoints(out_dir: str, embed_dim: int = 16, num_layers: int = 2,
                                    horizon: int = 6, img_shape: Tuple[int, int] = (16, 32),
                                    seed: int = 0) -> Dict[str, Any]:
    """Write a reference-format interpolator and forecaster checkpoint pair
    (``torch.save`` of ``state_dict`` and ``hyper_parameters``, the
    interpolator embedded in the forecaster under
    ``model.interpolator.model.*``, LitEma shadows ``model_ema.*`` equal to
    the forecaster's weights plus 1e-3) and ``centering.nc``/``scaling.nc``
    into ``out_dir``, as ``scripts/parity_check.py:fabricate_checkpoints``
    lays them out: the state ``HGTsfc`` (input only, under
    ``hack_for_imprecise_interpolation``), ``PRESsfc``,
    ``surface_temperature`` and ``air_temperature_0``, the forcing
    ``DSWRFtoa``, the prescriber over ``surface_temperature`` with the mask
    ``ocean_fraction``, forward conditioning "data", MLP dropout 0.1. The
    networks are port SFNOs with weights from ``seed`` (interpolator) and
    ``seed + 1`` (forecaster), made on the CPU, written in the reference's
    names (``utils/torch_convert.py:sfno_flax_to_torch``). Returns the paths
    and the names."""
    from ..data.hdf5 import write_hdf5
    from ..interface import get_model
    from .convert import state_dict_to_flax
    from .torch_convert import sfno_flax_to_torch

    base = ["PRESsfc", "surface_temperature", "air_temperature_0"]
    dropout_mlp = 0.1
    state_names = ["HGTsfc"] + base
    forcing_names = ["DSWRFtoa"]
    mask_name, prescribed = "ocean_fraction", "surface_temperature"
    c_state, c_out, c_f = len(state_names), len(base), len(forcing_names)
    os.makedirs(out_dir, exist_ok=True)
    stats_dir = os.path.join(out_dir, "data_statistics")
    os.makedirs(stats_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_names = sorted(set(state_names + forcing_names + [mask_name]))
    write_hdf5(os.path.join(stats_dir, "centering.nc"),
               {n: np.float64(rng.normal()) for n in all_names})
    write_hdf5(os.path.join(stats_dir, "scaling.nc"),
               {n: np.float64(abs(rng.normal()) + 0.5) for n in all_names})

    model_cfg = {"kind": "sfno", "embed_dim": embed_dim, "num_layers": num_layers,
                 "dropout_mlp": dropout_mlp, "activation_function": "gelu_exact"}

    def net(min_time, max_time, net_seed):
        m = get_model(model_cfg, img_shape, 2 * c_state + c_f, c_out, True, min_time,
                      max_time, device="cpu",
                      generator=torch.Generator().manual_seed(net_seed))
        return {k: np.ascontiguousarray(v) for k, v in sfno_flax_to_torch(
            state_dict_to_flax(m.state_dict()), mlp_dropout=True).items()}

    dcfg = {"_target_": "src.diffusion.dyffusion.DYffusion", "timesteps": horizon,
            "hack_for_imprecise_interpolation": True, "forward_conditioning": "data",
            "time_encoding": "dynamics"}
    tmin, tmax = build_schedule(DYffusionConfig(
        timesteps=horizon, hack_for_imprecise_interpolation=True)).forecaster_time_range
    interp_sd = net(1, max(horizon - 1, 1), seed)
    fc_sd = net(tmin, tmax, seed + 1)
    dm_cfg = {"_target_": "src.datamodules.fv3gfs.FV3GFSDataModule",
              "in_names": state_names + forcing_names, "out_names": base,
              "forcing_names": forcing_names, "horizon": horizon, "window": 1,
              "data_dir": None, "data_dir_stats": stats_dir,
              "prescriber": {"prescribed_name": prescribed, "mask_name": mask_name,
                             "mask_value": 1}}
    common = {"model_config": {"_target_": "src.models.sfno.sfnonet."
                                           "SphericalFourierNeuralOperatorNet",
                               "embed_dim": embed_dim, "num_layers": num_layers,
                               "dropout_mlp": dropout_mlp, "activation_function": "gelu"},
              "datamodule_config": dm_cfg, "num_predictions": 1, "use_ema": True,
              "enable_inference_dropout": False}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    interp_path = os.path.join(out_dir, "interpolator-sfno.ckpt")
    torch.save({"state_dict": {f"model.{k}": t(v) for k, v in interp_sd.items()},
                "hyper_parameters": dict(common, diffusion_config=None)}, interp_path)
    fc_state = {f"model.model.{k}": t(v) for k, v in fc_sd.items()}
    fc_state.update({f"model.interpolator.model.{k}": t(v) for k, v in interp_sd.items()})
    fc_state.update({"model_ema." + ("model." + k).replace(".", ""): t(v + 1e-3)
                     for k, v in fc_sd.items()})
    fc_path = os.path.join(out_dir, "forecaster-sfno.ckpt")
    torch.save({"state_dict": fc_state, "hyper_parameters": dict(common, diffusion_config=dcfg),
                "epoch": 1}, fc_path)
    return {"forecaster": fc_path, "interpolator": interp_path, "stats": stats_dir,
            "state_names": state_names, "out_names": base, "forcing_names": forcing_names,
            "mask_name": mask_name, "prescribed_name": prescribed,
            "img_shape": tuple(img_shape), "horizon": horizon}


# --------------------------------------------------------------- the check

def _overrides(stats_dir, interpolator_path, model_overrides) -> Dict[str, Any]:
    out: Dict[str, Any] = {"diffusion": {"enable_interpolator_dropout": False}}
    if stats_dir:
        out["datamodule"] = {"data_dir_stats": stats_dir}
    if interpolator_path:
        out["interpolator_checkpoint_path"] = interpolator_path
    if model_overrides:
        out["model"] = dict(model_overrides)
    return out


def _prescriber_cfg(config) -> Dict[str, Any]:
    return config.get("datamodule", {}).get("prescriber") or {}


def window_inputs(exp, config, n_steps: int, seed: int = 0) -> Dict[str, Optional[np.ndarray]]:
    """The check's window, channels last, from a numpy generator seeded
    with ``seed``, as ``scripts/parity_check.py`` draws it: standard normal
    raw fields normalized by the experiment's normalizers (``x0_norm`` (1,
    H, W, C_state), ``forcing_norm`` (1, T + 1, H, W, C_forcing)), and with a
    prescriber its normalized target (``tgt_norm`` (1, T + 1, H, W)) and a
    random 0/1 ``mask``."""
    p_cfg = _prescriber_cfg(config)
    state_names = list(exp.in_packer.names)
    out_names = list(exp.out_packer.names)
    forcing_names = list(exp.forcing_names)
    H_img, W_img = exp.model.cfg.img_shape
    rng = np.random.default_rng(seed)
    raw = {n: rng.standard_normal((1, n_steps + 1, H_img, W_img)).astype(np.float32)
           for n in dict.fromkeys(state_names + out_names + forcing_names)}
    mask = ((rng.random((1, n_steps + 1, H_img, W_img)) > 0.5).astype(np.float32)
            if p_cfg else None)
    norm = exp.normalizer
    x0_raw = torch.from_numpy(np.stack([raw[n][:, 0] for n in state_names], axis=-1))
    out = {"x0_norm": norm.normalize(x0_raw).float().numpy(), "forcing_norm": None,
           "tgt_norm": None, "mask": mask}
    if forcing_names:
        f_raw = torch.from_numpy(np.stack([raw[n] for n in forcing_names], axis=-1))
        out["forcing_norm"] = exp.forcing_normalizer.normalize(f_raw).float().numpy()
    if p_cfg:
        pn = p_cfg["prescribed_name"]
        ch = out_names.index(pn)
        out_norm = norm.subset(out_names)
        mu, sd_ = float(out_norm.means[ch]), float(out_norm.stds[ch])
        out["tgt_norm"] = (raw[pn] - mu) / sd_
    return out


def reference_oracles(forecaster_path: str, img_shape: Tuple[int, int],
                      interpolator_path: Optional[str] = None):
    """``(forecaster oracle, interpolator oracle, DYffusionConfig)`` read
    from a reference checkpoint's ``state_dict``s and hyperparameters (the
    interpolator's dropout off), the matrices rounded to float32 as the
    port's transforms hold them."""
    from ..interface import _fields
    from .torch_convert import (infer_sfno_architecture, load_lightning_checkpoint,
                                split_reference_state_dict, translate_reference_hparams)

    sd_full, hparams = load_lightning_checkpoint(forecaster_path)
    parts = split_reference_state_dict(sd_full)
    ref_cfg = translate_reference_hparams(hparams)
    horizon = int(ref_cfg.get("datamodule", {}).get("horizon", 6))
    diff_d = dict(ref_cfg.get("diffusion", {}))
    diff_d["enable_interpolator_dropout"] = False
    dcfg = DYffusionConfig(timesteps=horizon, **_fields(DYffusionConfig, diff_d))
    interp_sd = parts["interpolator"]
    if interp_sd is None and interpolator_path:
        interp_sd = split_reference_state_dict(
            load_lightning_checkpoint(interpolator_path)[0])["backbone"]
    mc = ref_cfg.get("model", {})

    def mk_oracle(net_sd, min_time, max_time):
        arch = infer_sfno_architecture(net_sd)
        return NumpySFNOOracle(
            net_sd, img_shape, num_layers=arch["num_layers"], embed_dim=arch["embed_dim"],
            operator_type=arch["operator_type"], scale_factor=int(mc.get("scale_factor", 1)),
            hard_thresholding_fraction=float(mc.get("hard_thresholding_fraction", 1.0)),
            encoder_layers=arch["encoder_layers"], use_mlp=arch["use_mlp"],
            with_time_emb=arch["with_time_emb"],
            time_scale_shift_before_filter=bool(mc.get("time_scale_shift_before_filter", True)),
            min_time=min_time, max_time=max_time,
            data_grid=str(mc.get("data_grid", "equiangular")), round_matrices_to_f32=True)

    tmin, tmax = build_schedule(dcfg).forecaster_time_range
    return (mk_oracle(parts["backbone"], tmin, tmax),
            mk_oracle(interp_sd, 1, max(horizon - 1, 1)), dcfg)


def oracle_window(forecaster_path: str, exp, config, inputs: Dict[str, Optional[np.ndarray]],
                  n_steps: int, interpolator_path: Optional[str] = None
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The oracle's window over ``inputs`` (``window_inputs``): the final
    state (1, H, W, C_state), the predictions (1, n_steps, H, W, C_out), both
    float64, and the oracle's host seconds."""
    p_cfg = _prescriber_cfg(config)
    state_names = list(exp.in_packer.names)
    out_names = list(exp.out_packer.names)
    fc, ip, dcfg = reference_oracles(forecaster_path, tuple(exp.model.cfg.img_shape),
                                     interpolator_path)
    oracle = NumpyDYffusionWindowOracle(
        interpolator=ip, forecaster=fc, cfg=dcfg,
        out_channel_indices=np.asarray([state_names.index(n) for n in out_names]),
        prescribed_channel=out_names.index(p_cfg["prescribed_name"]) if p_cfg else None,
        mask_value=int(p_cfg.get("mask_value", 1)) if p_cfg else 1,
        interpolate_mask=bool(p_cfg.get("interpolate", False)) if p_cfg else False)
    forcing = inputs["forcing_norm"]
    t0 = time.perf_counter()
    xf_o, preds_o = oracle.run_window(
        np.moveaxis(inputs["x0_norm"], -1, 1), n_steps,
        forcing_norm=np.moveaxis(forcing, -1, 2) if forcing is not None else None,
        prescribed_target_norm=inputs["tgt_norm"], mask=inputs["mask"])
    seconds = time.perf_counter() - t0
    return np.moveaxis(xf_o, 1, -1), np.moveaxis(preds_o, 2, -1), seconds


def load_parity_stepper(forecaster_path: str, stats_dir: Optional[str] = None,
                        interpolator_path: Optional[str] = None,
                        model_overrides: Optional[Dict[str, Any]] = None, device=None):
    """``(DYffusionStepper, config)`` of a reference checkpoint loaded as the
    check loads it (``interface.load_reference_checkpoint`` with the
    interpolator's dropout off, the prescriber from its datamodule)."""
    from ..inference.prescriber import PrescriberConfig
    from ..inference.stepper import DYffusionStepper
    from ..interface import load_reference_checkpoint

    exp, _, _, config = load_reference_checkpoint(
        forecaster_path, overrides=_overrides(stats_dir, interpolator_path, model_overrides),
        device=device)
    p_cfg = _prescriber_cfg(config)
    prescriber = None
    if p_cfg:
        prescriber = PrescriberConfig(
            prescribed_name=p_cfg["prescribed_name"], mask_name=p_cfg["mask_name"],
            mask_value=int(p_cfg.get("mask_value", 1)),
            interpolate=bool(p_cfg.get("interpolate", False))).build(
                list(exp.out_packer.names))
    return DYffusionStepper(exp, prescriber=prescriber), config


def run_window_parity_check(forecaster_path: str, stats_dir: Optional[str] = None,
                            n_steps: int = 13, tol: float = 1e-4, seed: int = 0,
                            interpolator_path: Optional[str] = None, device=None,
                            model_overrides: Optional[Dict[str, Any]] = None,
                            oracle: Optional[Tuple[np.ndarray, np.ndarray, float]] = None,
                            verbose: bool = True) -> Dict[str, Any]:
    """Load the checkpoint both ways, run the same window, return the
    report: ``per_step_max_abs_diff``, ``final_state_max_abs_diff``,
    ``max_abs_diff``, ``pred_scale``, the port window's seconds
    (``port_s``, synchronized), the oracle's host seconds (``oracle_s``) and
    its window under ``"oracle"`` (``oracle_window``'s triple, which a later
    call on the same checkpoint, steps and seed may pass back as ``oracle``
    instead of running it again). ``model_overrides`` lays ``SFNOConfig``
    fields over both networks (``{"use_pallas": True, "fused_tail": True}``
    for K1 and K3). Raises ``AssertionError`` where a step's or the final
    state's max |diff| passes ``tol``."""
    from ..interface import resolve_device

    dev = torch.device(device) if device is not None else resolve_device({})
    stepper, config = load_parity_stepper(forecaster_path, stats_dir, interpolator_path,
                                          model_overrides, dev)
    exp = stepper.exp
    inputs = window_inputs(exp, config, n_steps, seed)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev) if a is not None else None

    t0 = time.perf_counter()
    with torch.no_grad():
        xf, preds = stepper.run_window(on(inputs["x0_norm"]), on(inputs["forcing_norm"]),
                                       on(inputs["tgt_norm"]), on(inputs["mask"]),
                                       torch.Generator(device=dev).manual_seed(0), n_steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    port_s = time.perf_counter() - t0
    preds = preds.float().cpu().numpy()  # (1, n_steps, H, W, C_out)
    xf = xf.float().cpu().numpy()

    if oracle is None:
        oracle = oracle_window(forecaster_path, exp, config, inputs, n_steps, interpolator_path)
    xf_o, preds_o, oracle_s = oracle
    if preds_o.shape != preds.shape:
        raise ValueError(f"the oracle's window {preds_o.shape} is not this one's {preds.shape}")
    per_step = np.max(np.abs(preds - preds_o), axis=(0, 2, 3, 4))
    final_diff = float(np.max(np.abs(xf - xf_o)))
    report = {"n_steps": n_steps, "per_step_max_abs_diff": [float(v) for v in per_step],
              "final_state_max_abs_diff": final_diff, "max_abs_diff": float(per_step.max()),
              "tol": tol, "pred_scale": float(np.max(np.abs(preds_o))), "port_s": port_s,
              "oracle_s": oracle_s}
    if verbose:
        print(json.dumps(report, indent=1))
    report["oracle"] = oracle
    assert report["max_abs_diff"] <= tol and final_diff <= tol, (
        f"window parity violated: max diff {report['max_abs_diff']:.3e} (final state "
        f"{final_diff:.3e}) > tol {tol:g}")
    return report
