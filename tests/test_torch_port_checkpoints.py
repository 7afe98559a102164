"""The port's checkpoint loaders and command lines against the JAX package's,
on the CPU.

Debug sizes: the JAX package's own ``run_model`` trains the debug
interpolator and forecaster (``configs/experiment/debug_*.yaml``: embed 8,
one layer, 16 x 32, horizon 6; one epoch on a short synthetic series), and a
forecaster with three layers under ``scan_layers`` (the stacked layout);
reference Lightning checkpoints of both kinds are built from JAX SFNO
weights through ``sfno_flax_to_torch``, as ``tests/test_torch_convert.py``
builds them, with the interpolator embedded and ``model_ema.*`` shadows.
Rollouts compare with the interpolator's dropout off; their logs agree
within 1e-5 of each value (or of 1 where smaller; a percent difference, of
100).
"""

import argparse
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import spherical_dyffusion_tpu.interface as jinterface
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.run_inference import main_from_config as jmain_from_config
from spherical_dyffusion_tpu.train import run_model as jrun_model
from spherical_dyffusion_tpu.utils.torch_convert import sfno_flax_to_torch
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from spherical_dyffusion_tpu_torch.train import run_model
from spherical_dyffusion_tpu_torch.utils import flax_msgpack
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

LOG_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_init_once():
    """Each distinct JAX initialization runs once in this module. JAX's
    loaders and command lines build their parameter templates with
    ``Trainer._init_params`` and ``interface._init_sfno_variables``, jitted
    ``init``s compiled anew at every call (about 3 s each, four a DYffusion
    load); their results depend only on the experiment's kind and
    configuration, the network, the key and the inputs' shapes, so they are
    kept under those and handed out again: the same arrays a second compile
    would give."""
    from spherical_dyffusion_tpu.training.trainer import Trainer as JTrainer

    real, real_sfno = JTrainer._init_params, jinterface._init_sfno_variables
    seen = {}

    def sfno_once(model, img_shape, in_chans):
        key = ("sfno", repr(model), tuple(img_shape), in_chans)
        if key not in seen:
            seen[key] = real_sfno(model, img_shape, in_chans)
        return seen[key]

    def once(self, rng, dyn_norm, batch):
        exp = self.exp
        cond = batch.get("dynamical_condition")
        key = (type(exp).__name__, repr(exp.cfg), repr(exp.model),
               repr(getattr(exp, "diffusion_cfg", None)),
               np.asarray(jax.random.key_data(rng)).tobytes(), tuple(dyn_norm.shape),
               None if cond is None else tuple(np.shape(cond)))
        if key not in seen:
            seen[key] = real(self, rng, dyn_norm, batch)
        return seen[key]

    JTrainer._init_params, jinterface._init_sfno_variables = once, sfno_once
    yield
    JTrainer._init_params, jinterface._init_sfno_variables = real, real_sfno


def _common(d):
    return [f"ckpt_dir={d}", f"++log_dir={d / 'logs'}", "trainer.epochs=1",
            "datamodule.n_timesteps=12", "verbose=false"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's command lines, trained on the same configs."""
    jd, pd = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    out = {}
    for side, d, fn, extra in (("jax", jd, jrun_model, []),
                               ("port", pd, run_model, ["platform=cpu"])):
        ip = fn(None, ["experiment=debug_interpolation"] + _common(d) + extra)
        dy = ["experiment=debug_dyffusion",
              f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"] + _common(d) + extra
        fc = fn(None, dy)
        out[side] = {"interpolation": ip, "dyffusion": fc}
        if side == "jax":
            out[side]["scan"] = fn(None, dy + ["model.num_layers=3", "++model.scan_layers=true",
                                               "name=debug-dy-scan"])
    return out


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(abs(float(w)), 100.0 if "percent_diff" in k else 1.0)
        assert abs(float(got[k]) - float(w)) <= LOG_TOL * scale, (k, got[k], w)


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------- JAX checkpoints

def _leaf_equal(want, got, where=""):
    """Leaf for leaf: the same tree, types, dtypes, shapes and bytes (a JAX
    checkpoint holds no bfloat16 leaf)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _leaf_equal(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert np.shape(got) == np.shape(want), where
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("kind", ["interpolation", "dyffusion", "scan"])
def test_reader_matches_flax_on_jax_checkpoints(runs, kind):
    data = open(runs["jax"][kind]["ckpt_path"], "rb").read()
    _leaf_equal(serialization.msgpack_restore(data), flax_msgpack.restore(data))


@pytest.mark.parametrize("kind", ["interpolation", "dyffusion", "scan"])
def test_port_loads_jax_checkpoints(runs, kind):
    """The same config and weights (params and EMA, bit for bit; the stacked
    layout unstacked) as JAX's own loader."""
    path = runs["jax"][kind]["ckpt_path"]
    over = {"module": {"num_predictions": 2}}
    jexp, jparams, jema, jcfg = jinterface.load_experiment_checkpoint(path, overrides=over)
    exp, params, ema, cfg = interface.load_experiment_checkpoint(path, overrides=over,
                                                                 device="cpu")
    assert cfg == jcfg and exp.cfg.num_predictions == 2
    assert dataclasses.asdict(exp.cfg) == dataclasses.asdict(jexp.cfg)
    assert dataclasses.asdict(exp.model.cfg) == dataclasses.asdict(jexp.model.cfg)
    _equal(params, flax_to_state_dict(jparams))
    _equal(dict(exp.model.state_dict()), flax_to_state_dict(jparams))
    _equal(ema, flax_to_state_dict(jema))
    if kind == "scan":
        assert "blocks_mid" in jparams["params"] and exp.model.cfg.scan_layers


def _inference_cfg(path, out_dir, **kw):
    return {"checkpoint_path": str(path), "experiment_dir": str(out_dir),
            "n_forward_steps": 12, "forward_steps_in_memory": 6, "use_ema": True,
            "log_zonal_mean_images": False, "verbose": False,
            "overrides": {"diffusion": {"enable_interpolator_dropout": False}}, **kw}


@pytest.mark.parametrize("kind", ["dyffusion", "scan"])
def test_run_inference_matches_jax_on_jax_checkpoints(runs, kind, tmp_path):
    path = runs["jax"][kind]["ckpt_path"]
    jmain_from_config(_inference_cfg(path, tmp_path / "jax"))
    main_from_config(_inference_cfg(path, tmp_path / "port", platform="cpu"))
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())
    logs = [k for k in want if k.startswith("inference/")]
    assert len(logs) > 20 and got["n_forward_steps"] == want["n_forward_steps"] == 12
    _close({k: got[k] for k in logs}, {k: want[k] for k in logs})


# ------------------------------------------------------------ the CLIs

def _run_config(cfg):
    """A command line's config less what names its own files and device."""
    out = {k: v for k, v in cfg.items() if k not in ("platform", "ckpt_dir", "log_dir")}
    if "diffusion" in out:
        out["diffusion"] = {k: v for k, v in out["diffusion"].items()
                            if k != "interpolator_checkpoint_path"}
    return out


@pytest.mark.parametrize("kind", ["interpolation", "dyffusion"])
def test_train_cli_builds_the_jax_configs(runs, kind):
    j, p = runs["jax"][kind], runs["port"][kind]
    assert _run_config(p["config"]) == _run_config(j["config"])
    jt, pt = j["trainer"], p["trainer"]
    assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(jt.cfg)
    assert dataclasses.asdict(pt.exp.cfg) == dataclasses.asdict(jt.exp.cfg)
    assert dataclasses.asdict(pt.exp.model.cfg) == dataclasses.asdict(jt.exp.model.cfg)
    if kind == "dyffusion":
        assert dataclasses.asdict(pt.exp.diffusion_cfg) == \
            dataclasses.asdict(jt.exp.diffusion_cfg)
    assert len(p["history"]["step_losses"]) == 1 and p["trainer"].state.step == 1


def test_validate_mode_returns_jax_metric_keys(runs):
    jd = runs["jax"]["interpolation"]["config"]["ckpt_dir"]
    pd = runs["port"]["interpolation"]["config"]["ckpt_dir"]
    from pathlib import Path

    base = ["experiment=debug_interpolation", "++mode=validate", "++max_eval_batches=1"]
    want = jrun_model(None, base + _common(Path(jd)))["metrics"]
    got = run_model(None, base + _common(Path(pd)) + ["platform=cpu"])["metrics"]
    assert set(got) == set(want) == {"val/avg/rmse", "val/avg/crps", "val/avg/ssr"}
    assert all(np.isfinite(v) for v in got.values())


def test_overrides_deep_merge_at_reload(runs):
    path = runs["port"]["interpolation"]["ckpt_path"]
    exp, _, ema, cfg = interface.load_experiment_checkpoint(
        path, overrides={"module": {"num_predictions": 3}, "datamodule": {"n_timesteps": 30}})
    assert cfg["module"]["num_predictions"] == 3 and cfg["datamodule"]["n_timesteps"] == 30
    assert cfg["model"]["embed_dim"] == 8 and exp.cfg.num_predictions == 3
    assert ema is not None


def test_peel_sampler_reachable_through_overrides(runs):
    """``diffusion.peel_sampler`` flows from the overrides into the DYffusion
    config, and the peeled rollout equals the uniform scan sampler's with
    dropout off (1e-6 of the state's unit scale)."""
    path = runs["port"]["dyffusion"]["ckpt_path"]

    def rollout(peel):
        exp = interface.load_experiment_checkpoint(path, overrides={"diffusion": {
            "peel_sampler": peel, "enable_interpolator_dropout": False}})[0]
        assert exp.diffusion_cfg.peel_sampler is peel
        names = list(exp.in_packer.names) + list(exp.forcing_names)
        raw = SyntheticTimeSeries(names, n_timesteps=8, spatial_shape=(16, 32)).read_window(
            0, 8, names)
        x = torch.from_numpy(np.stack([raw[n][0] for n in exp.in_packer.names], -1)[None])
        f = torch.from_numpy(np.stack([raw[n] for n in exp.forcing_names], -1)[None])
        return DYffusionStepper(exp).run_window(x.float(), f.float(), None, None,
                                                torch.Generator().manual_seed(0), 6)[1]

    a, b = rollout(False), rollout(True)
    assert torch.isfinite(b).all()
    # float32 rounding of the O(1) normalized state the samplers carry
    assert (a - b).abs().max() <= 1e-6 * max(1.0, float(a.abs().max()))


# -------------------------------------------------- reference checkpoints

C, CF, HORIZON, SHAPE = 3, 1, 3, (8, 16)
STATE = [f"v{i}" for i in range(C)]
FORCING = ["f0"]


def _jax_net(in_chans, seed, dropout=0.1):
    cfg = JSFNOConfig(img_shape=SHAPE, in_chans=in_chans, out_chans=C, embed_dim=8,
                      num_layers=2, with_time_emb=True, dropout_mlp=dropout,
                      activation_function="gelu_exact", exact_norm=True, exact_dropout=True)
    v = jax.jit(lambda r: JSFNO(cfg).init(r, jnp.ones((1,) + SHAPE + (in_chans,)),
                                          time=jnp.ones((1,))))(jax.random.PRNGKey(seed))
    return jax.device_get(v)


def _torch(sd, prefix):
    return {prefix + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Reference Lightning checkpoints: a DYffusion forecaster with its
    interpolator embedded and LitEma shadows, and an interpolator alone."""
    d = tmp_path_factory.mktemp("ref")
    ip = sfno_flax_to_torch(_jax_net(2 * C + CF, 0), mlp_dropout=True)
    fc = sfno_flax_to_torch(_jax_net(C + CF, 1), mlp_dropout=True)
    fc_ema = {k: v * 0.5 for k, v in fc.items()}
    model_cfg = {"_target_": "src.models.sfno.sfnonet.SphericalFourierNeuralOperatorNet",
                 "embed_dim": 8, "num_layers": 2, "dropout_mlp": 0.1,
                 "activation_function": "gelu"}
    dm_cfg = {"_target_": "src.datamodules.fv3gfs.FV3GFSDataModule",
              "in_names": STATE + FORCING, "forcing_names": FORCING, "out_names": STATE,
              "horizon": HORIZON, "window": 1}
    dyff = {"state_dict": {**_torch(fc, "model.model."), **_torch(ip, "model.interpolator.model."),
                           **{"model_ema." + ("model." + k).replace(".", ""): torch.from_numpy(
                               np.array(v)) for k, v in fc_ema.items()}},
            "hyper_parameters": {
                "model_config": model_cfg, "datamodule_config": dm_cfg,
                "diffusion_config": {"_target_": "src.diffusion.dyffusion.DYffusion",
                                     "timesteps": HORIZON, "forward_conditioning": "none",
                                     "enable_interpolator_dropout": False,
                                     "interpolator_use_ema": False},
                "num_predictions": 2},
            "epoch": 3, "global_step": 100}
    ipol = {"state_dict": {**_torch(ip, "model."),
                           **{"model_ema." + k.replace(".", ""): torch.from_numpy(np.array(v))
                              for k, v in ip.items()}},
            "hyper_parameters": {"model_config": model_cfg, "datamodule_config": dm_cfg}}
    paths = {"dyffusion": d / "dyffusion.ckpt", "interpolation": d / "interpolation.ckpt"}
    torch.save(dyff, str(paths["dyffusion"]))
    torch.save(ipol, str(paths["interpolation"]))
    return paths


def _forward_inputs(in_chans, seed=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2,) + SHAPE + (in_chans - CF,)).astype(np.float32)
    cond = r.standard_normal((2,) + SHAPE + (CF,)).astype(np.float32)
    return x, cond, np.asarray([1.0, 2.0], np.float32)


@pytest.mark.parametrize("kind", ["interpolation", "dyffusion"])
def test_reference_checkpoint_loads_as_in_jax(reference, kind):
    """Config, weights (params and EMA, bit for bit) and one forward (1e-5)
    as JAX's ``load_reference_checkpoint``; the model runs exact gelu, norm
    and dropout."""
    path = str(reference[kind])
    jexp, jvars, jema, jcfg = jinterface.load_reference_checkpoint(path)
    exp, params, ema, cfg = interface.load_experiment_checkpoint(path, device="cpu")
    assert cfg == jcfg and cfg["_unit_normalization"] and cfg["experiment"] == kind
    mc = exp.model.cfg
    assert (mc.activation_function, mc.exact_norm, mc.exact_dropout) == ("gelu_exact", True, True)
    assert dataclasses.asdict(mc) == dataclasses.asdict(jexp.model.cfg)
    _equal(params, flax_to_state_dict(jvars))
    _equal(ema, flax_to_state_dict(jema))
    nets = [(exp.model, jexp.model, jvars)]
    if kind == "dyffusion":
        nets.append((exp.interpolator.model, jexp.interpolator.model, jexp.interpolator_params))
        _equal(dict(exp.interpolator.model.state_dict()),
               flax_to_state_dict(jexp.interpolator_params))
        assert dataclasses.asdict(exp.diffusion_cfg) == dataclasses.asdict(jexp.diffusion_cfg)
    for net, jnet, jv in nets:
        x, cond, t = _forward_inputs(net.cfg.in_chans)
        want = np.asarray(jnet.apply(jv, jnp.asarray(x), time=jnp.asarray(t),
                                     condition=jnp.asarray(cond)))
        with torch.no_grad():
            got = net(torch.from_numpy(x), time=torch.from_numpy(t),
                      condition=torch.from_numpy(cond)).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("legacy", [False, True])
def test_only_a_reference_checkpoint_is_read_without_weights_only(reference, tmp_path,
                                                                  monkeypatch, legacy):
    """A reference checkpoint whose hyperparameters hold an object that
    ``weights_only=True`` refuses still loads, as in JAX; any other torch
    file that it refuses (the port's own included) raises without being
    unpickled in full. Both torch file formats."""
    def save(obj, name):
        torch.save(obj, str(tmp_path / name), _use_new_zipfile_serialization=not legacy)
        return str(tmp_path / name)

    ref = torch.load(str(reference["interpolation"]), weights_only=True)
    ref["hyper_parameters"]["namespace"] = argparse.Namespace(a=1)
    _, params, ema, cfg = interface.load_experiment_checkpoint(save(ref, "ref.ckpt"),
                                                               device="cpu")
    _, want_params, want_ema, want_cfg = interface.load_experiment_checkpoint(
        str(reference["interpolation"]), device="cpu")
    _equal(params, want_params)
    _equal(ema, want_ema)
    assert cfg == want_cfg

    loads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(k["weights_only"])
                        or real_load(*a, **k))
    port = {"config_json": "{}", "params": {}, "namespace": argparse.Namespace(a=1)}
    other = {"weights": {}, "namespace": argparse.Namespace(a=1)}
    for payload, name in ((port, "port.ckpt"), (other, "other.pt")):
        with pytest.raises(pickle.UnpicklingError, match="only a reference checkpoint"):
            interface.load_experiment_checkpoint(save(payload, name), device="cpu")
    assert loads == [True, True]


def test_reference_checkpoint_cli_logs_match_jax(reference, tmp_path):
    cfg = dict(_inference_cfg(reference["dyffusion"], "", n_forward_steps=6,
                              forward_steps_in_memory=3), overrides=None)
    jmain_from_config(dict(cfg, experiment_dir=str(tmp_path / "jax")))
    out = main_from_config(dict(cfg, experiment_dir=str(tmp_path / "port"), platform="cpu"))
    assert out["stepper"].exp.model.cfg.exact_dropout
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())
    logs = [k for k in want if k.startswith("inference/")]
    assert logs
    _close({k: got[k] for k in logs}, {k: want[k] for k in logs})


def test_reference_checkpoint_reads_stats_files_as_jax(reference, tmp_path):
    """``datamodule.data_dir_stats`` holding ``centering.nc`` and
    ``scaling.nc`` (written by ``data/hdf5.py:write_hdf5``): the loader's
    normalizers are the files' (no ``_unit_normalization``), and the
    inference command line's logs equal JAX's with the same files."""
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5

    means = {n: np.float32(0.5 + 0.1 * i) for i, n in enumerate(STATE + FORCING)}
    stds = {n: np.float32(2.0 - 0.2 * i) for i, n in enumerate(STATE + FORCING)}
    write_hdf5(str(tmp_path / "centering.nc"), means)
    write_hdf5(str(tmp_path / "scaling.nc"), stds)
    over = {"datamodule": {"data_dir_stats": str(tmp_path)},
            "diffusion": {"enable_interpolator_dropout": False}}
    exp, _, _, cfg = interface.load_experiment_checkpoint(str(reference["dyffusion"]),
                                                          overrides=over, device="cpu")
    assert "_unit_normalization" not in cfg
    assert exp.normalizer.get_state() == {"means": {n: float(means[n]) for n in STATE},
                                          "stds": {n: float(stds[n]) for n in STATE}}
    assert exp.forcing_normalizer.get_state()["stds"] == {"f0": float(stds["f0"])}
    cfg = dict(_inference_cfg(reference["dyffusion"], "", n_forward_steps=6,
                              forward_steps_in_memory=3), overrides=over)
    jmain_from_config(dict(cfg, experiment_dir=str(tmp_path / "jax")))
    main_from_config(dict(cfg, experiment_dir=str(tmp_path / "port"), platform="cpu"))
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())
    logs = [k for k in want if k.startswith("inference/")]
    assert logs
    _close({k: got[k] for k in logs}, {k: want[k] for k in logs})
