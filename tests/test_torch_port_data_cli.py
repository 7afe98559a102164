"""The port's command lines on netCDF files against the JAX package's, on
the CPU, at debug size.

The files are written by the port's ``write_hdf5`` (the JAX package reads
them through h5py): an FV3GFS-like tree at 8 x 16 (members ``ic_0001`` and
``ic_0002``, the validation member ``validation/ic_0011``, each in two
files; four state variables, the forcing ``DSWRFtoa``, ``lat``/``lon``) and
its ``centering.nc``/``scaling.nc``. The networks are SFNOs at embed 8 x 1
layer with the port's seeded weights, carried to JAX (``utils/convert.py``)
so that no JAX initializer is compiled, and dropout off; the timesteps the
trainers draw are pinned in both packages. Tolerances: losses 1e-5
relative; ``metrics.json`` logs 1e-5 of each value (or of 1 where smaller;
a percent difference, of 100); normalizers bit for bit.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu import interface as jinterface
from spherical_dyffusion_tpu.run_inference import main_from_config as jmain_from_config
from spherical_dyffusion_tpu.train import run_model as jrun_model
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch.data.datamodule import FV3GFSDataModule
from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from spherical_dyffusion_tpu_torch.train import run_model
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)

STATE = ["PRESsfc", "surface_temperature", "air_temperature_0", "specific_total_water_0"]
FORCING = ["DSWRFtoa"]
H, W, HORIZON = 8, 16, 3
LOG_TOL = 1e-5


def _member(d, n_time, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for fi, n in enumerate([n_time // 2, n_time - n_time // 2]):
        variables = {v: (1.0 + 0.3 * rng.standard_normal((n, H, W))).astype(np.float32)
                     for v in STATE + FORCING}
        variables.update(lat=np.linspace(-78.75, 78.75, H), lon=np.linspace(0, 337.5, W))
        write_hdf5(os.path.join(d, f"data_{fi}.nc"), variables,
                   {"PRESsfc": {"units": "Pa", "long_name": "surface pressure"}})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("fv3gfs_cli")
    _member(str(r / "ic_0001"), 8, 0)
    _member(str(r / "ic_0002"), 8, 1)
    _member(str(r / "validation" / "ic_0011"), 10, 2)
    for fname, base in (("centering.nc", 1.0), ("scaling.nc", 0.3)):
        write_hdf5(str(r / fname), {v: np.float32(base + 0.01 * i)
                                    for i, v in enumerate(STATE + FORCING)})
    return str(r)


def _cfg(root, experiment="interpolation", ip_path=None, **dm):
    cfg = {"experiment": experiment, "seed": 0,
           "datamodule": {"kind": "fv3gfs", "in_names": STATE, "out_names": STATE,
                          "forcing_names": FORCING, "data_dir": root, "data_dir_stats": root,
                          "horizon": HORIZON, "prediction_horizon": HORIZON,
                          "prediction_horizon_long": HORIZON, "batch_size": 1,
                          "max_val_samples": 1, "prefetch_depth": 0, **dm},
           "model": {"kind": "sfno", "embed_dim": 8, "num_layers": 1},
           "module": {"enable_inference_dropout": False},
           "diffusion": {"forward_conditioning": "none", "enable_interpolator_dropout": False},
           "trainer": {"epochs": 1, "lr": 4e-3, "use_ema": False, "warmup_steps": 1}}
    if ip_path:
        cfg["diffusion"]["interpolator_checkpoint_path"] = ip_path
    return cfg


@pytest.fixture(scope="module")
def pin():
    """Both packages' timestep draws pinned to 1, 2, 1, ... per sample."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", lambda key, shape, minval, maxval, *a, **k:
               jnp.asarray(([1, 2] * shape[0])[:shape[0]], jnp.int32))
    real = torch.randint

    def fake(low, high=None, size=None, *a, **k):
        if size is not None and high is not None and len(size) == 1:
            return torch.tensor(([1, 2] * size[0])[:size[0]], dtype=torch.long)
        return real(low, high, size, *a, **k)

    mp.setattr(torch, "randint", fake)
    yield
    mp.undo()


def test_get_datamodule_builds_fv3gfs_as_jax(root):
    """``kind: fv3gfs`` builds the netCDF datamodule from the stats
    directory; the normalizers equal JAX's (and the stats files)."""
    cfg = _cfg(root)
    dm, jdm = interface.get_datamodule(cfg), jinterface.get_datamodule(cfg)
    assert isinstance(dm, FV3GFSDataModule)
    assert dataclasses.asdict(dm.cfg) == dataclasses.asdict(jdm.cfg)
    for a, b in ((dm.normalizer, jdm.normalizer), (dm.forcing_normalizer,
                                                   jdm.forcing_normalizer)):
        assert a.names == b.names
        assert a.means.numpy().tobytes() == np.asarray(b.means).tobytes()
        assert a.stds.numpy().tobytes() == np.asarray(b.stds).tobytes()
    assert np.isclose(float(dm.normalizer.stds[0]), 0.3)


@pytest.fixture(scope="module")
def trained(root, pin, tmp_path_factory):
    """The train command line with ``datamodule.kind: fv3gfs`` in both
    packages from one JSON config, one epoch of the interpolator (batch 1,
    3 samples), JAX started from the port's initial weights."""
    d = tmp_path_factory.mktemp("train")
    cfg = dict(_cfg(root, max_train_samples=3), name="fv3")
    path = d / "cfg.json"
    path.write_text(json.dumps(cfg))
    init = interface.get_experiment(cfg, interface.get_datamodule(cfg), device="cpu",
                                    seed=0).model.state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(init)["params"])

    def port_weights(self, rng, dyn_norm, batch):
        """JAX's interpolator variables with the port's weights: its
        "constants" (the SHT matrices) from a jitted apply that returns only
        them, so that no initializer is compiled."""
        exp = self.exp
        inputs = exp.get_inputs_from_dynamics(dyn_norm)
        c = exp.slice_condition(jnp.asarray(batch["dynamical_condition"][:1]), 1)
        t = jnp.ones((inputs.shape[0],), jnp.float32)
        consts = jax.jit(lambda p: exp.model.apply({"params": p}, inputs, time=t, condition=c,
                                                   mutable=["constants"])[1])(params)
        return {"params": params, **consts}

    mp = pytest.MonkeyPatch()
    mp.setattr(JTrainer, "_init_params", port_weights)
    try:
        want = jrun_model(str(path), [f"++ckpt_dir={d / 'jax'}", f"++log_dir={d / 'jlogs'}",
                                      "++verbose=false"])
    finally:
        mp.undo()
    got = run_model(str(path), [f"++ckpt_dir={d / 'port'}", f"++log_dir={d / 'plogs'}",
                                "++verbose=false", "platform=cpu"])
    # JAX's fit returns epoch means; its logged step losses are in its log
    rows = [json.loads(line) for line in (d / "jlogs" / "fv3" / "metrics.jsonl").open()]
    want["step_losses"] = [r["train/loss"] for r in rows if "train/loss" in r]
    return dict(want=want, got=got)


def test_train_cli_with_fv3gfs_matches_jax(trained):
    want, got = trained["want"], trained["got"]
    assert {k: v for k, v in got["config"].items() if k not in ("platform", "ckpt_dir",
                                                                "log_dir")} == \
        {k: v for k, v in want["config"].items() if k not in ("ckpt_dir", "log_dir")}
    assert isinstance(got["trainer"].dm, FV3GFSDataModule)
    assert dataclasses.asdict(got["trainer"].cfg) == dataclasses.asdict(want["trainer"].cfg)
    # the epoch's mean loss over its 3 steps, and the first step's (the
    # step JAX's log holds at its default logging interval)
    assert len(got["history"]["step_losses"]) == 3
    np.testing.assert_allclose(got["history"]["train_loss"], want["history"]["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["history"]["step_losses"][0], want["step_losses"][0],
                               rtol=1e-5)
    # the checkpoint rebuilds the fv3gfs datamodule and its normalizer
    exp, _, _, cfg = interface.load_experiment_checkpoint(got["ckpt_path"], device="cpu")
    assert cfg["datamodule"]["kind"] == "fv3gfs"
    assert exp.normalizer.get_state() == got["trainer"].dm.normalizer.get_state()


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(abs(float(w)), 100.0 if "percent_diff" in k else 1.0)
        assert abs(float(got[k]) - float(w)) <= LOG_TOL * scale, (k, got[k], w)


@pytest.fixture(scope="module")
def checkpoints(root, tmp_path_factory):
    """JAX (msgpack) checkpoints of an interpolator and a forecaster over
    the fv3gfs datamodule, holding the port's seeded weights."""
    d = tmp_path_factory.mktemp("ckpts")
    ip, fc = str(d / "ip.ckpt"), str(d / "fc.ckpt")
    icfg = _cfg(root)
    dm = interface.get_datamodule(icfg)
    inet = interface.get_experiment(icfg, dm, device="cpu", seed=0).model
    state = types.SimpleNamespace(params=state_dict_to_flax(inet.state_dict()), ema=None,
                                  opt_state=None, step=0)
    jinterface.save_experiment_checkpoint(ip, state, icfg)
    fcfg = _cfg(root, "dyffusion", ip)
    fnet = interface.get_experiment(fcfg, dm, device="cpu", seed=1).model
    state = types.SimpleNamespace(params=state_dict_to_flax(fnet.state_dict()), ema=None,
                                  opt_state=None, step=0)
    jinterface.save_experiment_checkpoint(fc, state, fcfg)
    return dict(ip=ip, fc=fc)


@pytest.mark.parametrize("n_repeats", [1, 2])
def test_run_inference_on_a_data_path_matches_jax(root, checkpoints, tmp_path, n_repeats):
    """``run_inference`` (DYffusion) over ``validation_loader.dataset.
    data_path`` (the validation member, its windows crossing the file
    boundary; with ``n_repeats`` 2 the rollout wraps around it):
    ``metrics.json`` as JAX's; the source is the files'."""
    run = {"checkpoint_path": checkpoints["fc"], "n_forward_steps": 12 if n_repeats > 1 else 6,
           "forward_steps_in_memory": 3, "log_zonal_mean_images": False, "verbose": False,
           "validation_loader": {"dataset": {
               "data_path": os.path.join(root, "validation", "ic_0011"),
               "n_repeats": n_repeats}}}
    jmain_from_config(dict(run, experiment_dir=str(tmp_path / "jax")))
    out = main_from_config(dict(run, experiment_dir=str(tmp_path / "port"), platform="cpu"))
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())
    logs = [k for k in want if k.startswith("inference/")]
    assert len(logs) > 20 and got["n_forward_steps"] == want["n_forward_steps"]
    _close({k: got[k] for k in logs}, {k: want[k] for k in logs})
    assert isinstance(out["stepper"].exp.normalizer.means, torch.Tensor)


def test_run_inference_without_the_data_path_falls_back_as_jax(checkpoints, tmp_path):
    """A ``data_path`` that does not exist: the synthetic source of
    ``forward_steps_in_memory + 1`` frames, repeated ``n_repeats`` times
    (1), not ``max(4, n_forward_steps)`` times, so 6 steps do not fit it:
    both packages refuse with the same error."""
    run = {"checkpoint_path": checkpoints["fc"], "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "log_zonal_mean_images": False, "verbose": False,
           "validation_loader": {"dataset": {"data_path": str(tmp_path / "missing")}}}
    errors = []
    for fn, extra in ((jmain_from_config, {}), (main_from_config, {"platform": "cpu"})):
        with pytest.raises(ValueError, match="n_repeats=1") as e:
            fn(dict(run, experiment_dir=str(tmp_path / "out"), **extra))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
