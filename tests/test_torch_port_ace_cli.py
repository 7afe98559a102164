"""Parity of the port's simultaneous forecaster, ACE checkpoint loader and
``stepper_type: ace`` inference with the JAX package, on the CPU.

Debug size: 8 x 16 grids (32 x 64 for the loader's quadrature check), 2
state channels and 1 forcing from each package's ``DebugDataModule`` (the
same numpy data), SFNOs at embed 8 x 1 layer with K1's route on (the JAX
kernel's einsum form, the port's wrapper computing its plain version).
Dropout is off, so both packages compute the same function. The SFNO
weights are the port's (seeded, with JAX's initializers' distributions),
carried to JAX by ``utils/convert.py``, so that no JAX initializer is
compiled; the JAX trainer is built and fitted once for the module. Tolerances:
losses 1e-5 relative; gradients 1e-4 of each tensor's largest entry (of
1e-4 of the network's largest where a tensor's cancels below that); model
outputs 1e-5 of their largest value; ``metrics.json`` logs 1e-4 relative
plus 1e-6 of the largest log of their metric.
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

from spherical_dyffusion_tpu import interface as jinterface
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.run_inference import main_from_config as jmain_from_config
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.utils.torch_convert import sfno_flax_to_torch
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch.data import hdf5
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops import pallas_contractions as pc
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from spherical_dyffusion_tpu_torch.training.experiments import SimultaneousForecastingExperiment
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

H, W = 8, 16


def _cfg(horizon=2, hao=1, batch_size=2, n_timesteps=12):
    return {
        "experiment": "simultaneous",
        "datamodule": {"kind": "debug", "channels": 2, "height": H, "width": W,
                       "horizon": horizon, "n_forcing": 1, "batch_size": batch_size,
                       "n_timesteps": n_timesteps},
        "model": {"kind": "sfno", "embed_dim": 8, "num_layers": 1, "use_pallas": True},
        "module": {"horizon_at_once": hao},
    }


def _jax_cfg(cfg):
    """``cfg`` without ``use_pallas`` (see ``_pair``)."""
    return {**cfg, "model": {k: v for k, v in cfg["model"].items() if k != "use_pallas"}}


def _boost(tree):
    return {k: (_boost(v) if isinstance(v, dict) else (v * 64.0 if k == "weight" else v))
            for k, v in tree.items()}


def _jax_variables(model, params, *args, **kwargs):
    """The JAX SFNO's variables for ``params``: its "constants" collection
    (the SHT matrices) from a jitted apply that returns only that
    collection, so no initializer and no forward is compiled."""
    consts = jax.jit(lambda p, a, k: model.apply({"params": p}, *a, mutable=["constants"],
                                                 **k)[1])(params, args, kwargs)
    return {"params": params, **consts}


def _port_sfno_params(**cfg):
    """The flax tree of a port SFNO's seeded weights."""
    model = SFNO(SFNOConfig(**cfg))
    model.init_weights(torch.Generator().manual_seed(0))
    return state_dict_to_flax(model.state_dict())["params"]


def _pair(cfg):
    """(JAX experiment, its variables, port experiment, the datamodules):
    the same weights (the port's, the spectral weights scaled up so the
    filter shows) in both. The port routes the dhconv through K1's
    wrapper; JAX contracts it with its einsum (the same function: K1's own
    parity with JAX's interpreted kernel is ``test_torch_port_train_k1.py``'s,
    and tracing the interpreted kernel's backward costs seconds a call)."""
    jdm = jinterface.get_datamodule(_jax_cfg(cfg))
    jexp = jinterface.get_experiment(_jax_cfg(cfg), jdm)
    dm = interface.get_datamodule(cfg)
    exp = interface.get_experiment(cfg, dm, device="cpu")
    C, CF = len(jdm.cfg.in_names), len(jdm.cfg.forcing_names)
    params = _boost(state_dict_to_flax(exp.model.state_dict())["params"])
    exp.model.load_state_dict(flax_to_state_dict(params))
    v = _jax_variables(jexp.model, params, jnp.zeros((1, H, W, C)),
                       condition=jnp.zeros((1, H, W, CF)))
    return jexp, v, exp, jdm, dm


def _batch(jdm, n=2):
    b = [jdm.dataset("train")[i] for i in range(n)]
    dyn = np.stack([s["dynamics"] for s in b])
    cond = np.stack([s["dynamical_condition"] for s in b])
    return np.asarray(jdm.normalizer.normalize(jnp.asarray(dyn))), cond


def _assert_grads(got: dict, want: dict):
    top = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-4 * scale, f"{k}: {err:.3g} vs 1e-4 x {scale:.3g}"


# ------------------------------------------------------ the simultaneous exp

@pytest.mark.parametrize("hao", [1, 2])
def test_simultaneous_train_loss_grads_and_predict_match_jax(hao, monkeypatch):
    """Horizon 2 at ``horizon_at_once`` 1 (two autoregressive steps, the
    first's prediction fed back detached) and 2 (one step): the loss and
    its per-step terms (1e-5), every gradient (``_assert_grads``), and
    ``predict``'s (B, hao, H, W, C) (1e-5 of its largest value). K1's route
    is counted on the CPU through the plain version it computes there: one
    forward and one dx per layer and autoregressive step, as the card's
    launch counts."""
    jexp, v, exp, jdm, _ = _pair(_cfg(horizon=2, hao=hao))
    assert exp.num_ar_steps == jexp.num_ar_steps == 2 // hao
    assert exp.ar_weights == jexp.ar_weights
    dyn, cond = _batch(jdm)
    consts = {k: x for k, x in v.items() if k != "params"}

    def jloss(p):
        return jexp.train_loss({**consts, "params": p}, jnp.asarray(dyn), jax.random.PRNGKey(0),
                               dynamical_condition=jnp.asarray(cond))

    (want, want_m), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    calls = {"plain": 0, "dx": 0}
    real_plain, real_conj = pc.dhconv_plain, pc.conj_transpose
    monkeypatch.setattr(pc, "dhconv_plain", lambda *a: calls.__setitem__(
        "plain", calls["plain"] + 1) or real_plain(*a))
    monkeypatch.setattr(pc, "conj_transpose", lambda *a: calls.__setitem__(
        "dx", calls["dx"] + 1) or real_conj(*a))
    loss, metrics = exp.train_loss(torch.tensor(dyn), torch.Generator().manual_seed(0),
                                   dynamical_condition=torch.tensor(cond))
    names = [n for n, _ in exp.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(exp.model.parameters()))
    steps = 2 // hao
    assert calls == {"plain": 2 * steps, "dx": steps}  # forwards + dx, dx; one layer
    assert set(metrics) == set(want_m) == {"loss"} | {f"loss_ar{i}" for i in range(steps)}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-5)
    _assert_grads({n: g.numpy() for n, g in zip(names, grads)},
                  {k: x.numpy() for k, x in flax_to_state_dict({"params": jgrads}).items()})

    inputs = dyn[:, 0]
    want_p = np.asarray(jax.jit(lambda x, c: jexp.predict(v, x, condition=c))(
        jnp.asarray(inputs), jnp.asarray(cond[:, 0])))
    with torch.no_grad():
        got_p = exp.predict(torch.tensor(inputs), condition=torch.tensor(cond[:, 0])).numpy()
    assert got_p.shape == want_p.shape == (2, hao, H, W, 2)
    assert np.abs(got_p - want_p).max() <= 1e-5 * np.abs(want_p).max()
    with pytest.raises(ValueError, match="sequential frames"):
        exp.train_loss(torch.tensor(dyn), torch.Generator(), random_timestep=torch.ones(2))


def test_simultaneous_dropout_draws_fold_in_the_step():
    """With dropout live, each autoregressive step draws from its own
    generator, ``fold_in(seed, step)`` (``seed`` one draw from the step's
    generator): the same generator state gives the same loss, another
    seed another; the two steps' generators differ, and ``fold_in`` is a
    pure function of (seed, step)."""
    from spherical_dyffusion_tpu_torch.training.experiments import fold_in

    cfg = _cfg(horizon=2, hao=1)
    cfg["model"] = dict(cfg["model"], dropout_mlp=0.5)
    dm = interface.get_datamodule(cfg)
    exp = interface.get_experiment(cfg, dm, device="cpu")
    dyn, cond = _batch(jinterface.get_datamodule(_jax_cfg(cfg)))

    def loss(seed):
        with torch.no_grad():
            return float(exp.train_loss(torch.tensor(dyn), torch.Generator().manual_seed(seed),
                                        dynamical_condition=torch.tensor(cond))[0])

    assert loss(3) == loss(3) != loss(4)
    first = [int(torch.randint(0, 2 ** 62, (1,), generator=fold_in(7, k))) for k in (0, 1, 0)]
    assert first[0] == first[2] != first[1]


def test_get_experiment_simultaneous_channel_counts_as_jax():
    """``get_experiment(experiment="simultaneous")`` builds the network JAX
    builds: ``window * C + CF`` inputs, ``hao * C_out`` outputs, no time
    embedding; hao defaults to the horizon; horizon must divide by it."""
    for cfg in (_cfg(horizon=4, hao=2), {**_cfg(horizon=3), "module": {}}):
        jdm = jinterface.get_datamodule(_jax_cfg(cfg))
        jexp = jinterface.get_experiment(_jax_cfg(cfg), jdm)
        exp = interface.get_experiment(cfg, interface.get_datamodule(cfg), device="cpu")
        assert isinstance(exp, SimultaneousForecastingExperiment)
        for k in ("in_chans", "out_chans", "with_time_emb"):
            assert getattr(exp.model.cfg, k) == getattr(jexp.model.cfg, k), k
        assert exp.horizon_at_once == jexp.horizon_at_once
        assert list(exp.forcing_names) == list(jexp.forcing_names)
    assert (exp.model.cfg.in_chans, exp.model.cfg.out_chans) == (3, 6)
    with pytest.raises(ValueError, match="divisible"):
        interface.get_experiment(_cfg(horizon=3, hao=2),
                                 interface.get_datamodule(_cfg(horizon=3, hao=2)), device="cpu")


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, row, step=None):
        self.rows.append(dict(row))

    def step_losses(self):
        return [r["train/loss"] for r in self.rows if "train/loss" in r]


FIT_CFG = _cfg(horizon=2, hao=1, batch_size=1, n_timesteps=4)
FIT_KW = dict(epochs=2, warmup_steps=1, log_every=1)


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's ``Trainer.fit`` of ``FIT_CFG``: 2 epochs of 2 steps at batch
    1, lr 4e-4 after one warm-up step, from ``_pair``'s weights; the port's
    experiment and datamodule over the same weights beside it."""
    jexp, v, exp, jdm, dm = _pair(FIT_CFG)
    jtr = JTrainer(jexp, jdm, JTrainerConfig(**FIT_KW))
    jtr.restore_payload = {"params": v}
    jlog = _Log()
    jhist = jtr.fit(val_every=100, verbose=False, logger=jlog)
    return dict(trainer=jtr, log=jlog, hist=jhist, exp=exp, dm=dm)


def test_simultaneous_fit_matches_jax(jax_fit):
    """``Trainer.fit`` against ``jax_fit``'s, from the same weights:
    per-step and epoch losses 1e-5 relative; ``rollout_validate`` gives
    ``{}``, as in JAX."""
    jtr, jlog = jax_fit["trainer"], jax_fit["log"]
    ttr = Trainer(jax_fit["exp"], jax_fit["dm"], TrainerConfig(**FIT_KW))
    thist = ttr.fit(val_every=100, verbose=False, logger=_Log())
    assert len(thist["step_losses"]) == len(jlog.step_losses()) == 4
    np.testing.assert_allclose(thist["step_losses"], jlog.step_losses(), rtol=1e-5)
    np.testing.assert_allclose(thist["train_loss"], jax_fit["hist"]["train_loss"], rtol=1e-5)
    assert ttr.rollout_validate(ttr.state) == {} == jtr.rollout_validate(jtr.state)


def test_simultaneous_validate_raises_as_in_jax(jax_fit):
    """JAX's ``fit`` cannot validate a simultaneous experiment: the
    ``validate`` it calls at each ``val_every`` epoch builds a forecasting
    eval step that calls ``predict`` with arguments the experiment does not
    take (``TypeError``; here on ``jax_fit``'s trained state). The port's
    ``fit`` raises a ``ValueError`` naming both JAX lines, before any
    validation work."""
    jtr = jax_fit["trainer"]
    with pytest.raises(TypeError, match="dynamical_condition"):
        jtr.validate(jtr.state)
    dm = interface.get_datamodule(FIT_CFG)
    ttr = Trainer(interface.get_experiment(FIT_CFG, dm, device="cpu"), dm,
                  TrainerConfig(**FIT_KW))
    with pytest.raises(ValueError, match=r"trainer\.py:996.*experiments\.py:487"):
        ttr.fit(val_every=1, verbose=False)


# ------------------------------------------------------- native ACE checkpoints

def _native_state(in_names, out_names, base, params, extra_builder, sigma_k=3, **cfg):
    """A native ACE checkpoint's stepper state, as JAX's tests fabricate it."""
    H_, W_ = base["img_shape"]
    state = {
        "module": {k: torch.as_tensor(np.array(x))
                   for k, x in sfno_flax_to_torch(params).items()},
        "normalizer": {"means": {n: 1.0 for n in in_names},
                       "stds": {n: 0.5 for n in in_names}},
        "img_shape": (H_, W_),
        "config": {"builder": {"type": "SphericalFourierNeuralOperatorNet",
                               "config": extra_builder},
                   "in_names": in_names, "out_names": out_names,
                   "normalization": {"means": {}, "stds": {}}, "ocean": None, **cfg},
        "area": torch.ones(H_, W_),
    }
    if sigma_k:
        state["sigma_coordinates"] = {"ak": list(np.linspace(0, 100.0, sigma_k + 1)),
                                      "bk": list(np.linspace(0, 1.0, sigma_k + 1))}
    return state


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The JAX tests' native checkpoint: an SFNO (embed 8, 1 layer, erf
    gelu, exact norm) over PRESsfc, one water level and the forcing
    DSWRFtoa, the dry-air corrector, data_grid given explicitly; the
    weights the port's, seeded. JAX's loader reads it once here."""
    in_names = ["PRESsfc", "specific_total_water_0", "DSWRFtoa"]
    base = dict(img_shape=(H, W), in_chans=3, out_chans=2, embed_dim=8, num_layers=1,
                with_time_emb=False, activation_function="gelu_exact", exact_norm=True)
    state = _native_state(in_names, in_names[:-1], base, _port_sfno_params(**base),
                          {"scale_factor": 1, "data_grid": "equiangular"},
                          corrector={"conserve_dry_air": True})
    path = str(tmp_path_factory.mktemp("ace") / "ace_native.ckpt")
    torch.save({"stepper": state}, path)
    jstep, jcfg = jinterface.load_ace_stepper_checkpoint(path)
    return dict(path=path, state=state, jstep=jstep, jcfg=jcfg)


def test_load_ace_stepper_checkpoint_matches_jax(native):
    """The loaded stepper: its network on a random input (1e-5 of the
    largest output), its config, loss (LpLoss -> l2_rel), corrector,
    normalizer and sigma, as JAX's loader gives them."""
    jstep, jcfg = native["jstep"], native["jcfg"]
    stepper, cfgd = interface.load_ace_stepper_checkpoint(native["path"], device="cpu")
    assert cfgd == jcfg
    assert dataclasses.asdict(stepper.cfg) == dataclasses.asdict(jstep.cfg)
    assert stepper.cfg.loss == "l2_rel"
    assert stepper.corrector is not None and stepper.module.cfg.exact_norm
    assert stepper.module.cfg.activation_function == "gelu_exact"
    assert stepper.normalizer.get_state() == jstep.normalizer.get_state()
    assert stepper.get_state()["sigma_coordinates"] == jstep.get_state()["sigma_coordinates"]
    x = np.random.default_rng(0).standard_normal((1, H, W, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jstep.model_fn)(jstep.params, jnp.asarray(x)))
    with torch.no_grad():
        got = stepper.model_fn(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_ace_loader_legendre_gauss_default_with_teeth(tmp_path):
    """A builder config without ``data_grid`` takes the reference default,
    legendre-gauss: at 32 latitude rows the loaded network equals a JAX
    legendre-gauss source within 1e-5, and the same weights on the
    equiangular grid differ by more than 1e-4 (the check can fail)."""
    Hq, Wq = 32, 64
    base = dict(img_shape=(Hq, Wq), in_chans=2, out_chans=2, embed_dim=8, num_layers=1,
                with_time_emb=False, scale_factor=1, activation_function="gelu_exact",
                exact_norm=True)
    model_lg = JSFNO(JSFNOConfig(data_grid="legendre-gauss", **base))
    params = _port_sfno_params(data_grid="legendre-gauss", **base)
    names = ["PRESsfc", "specific_total_water_0"]
    state = _native_state(names, names, base, params, {"scale_factor": 1}, sigma_k=0,
                          corrector=None)
    path = str(tmp_path / "ace_lg.ckpt")
    torch.save({"stepper": state}, path)
    stepper, _ = interface.load_ace_stepper_checkpoint(path, device="cpu")
    assert stepper.module.cfg.data_grid == "legendre-gauss" and stepper.sigma is None
    x = np.random.default_rng(1).standard_normal((1, Hq, Wq, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: model_lg.apply({"params": p}, a,
                                                          mutable=["constants"])[0])(
        params, jnp.asarray(x)))
    eq = interface.SFNO(dataclasses.replace(stepper.module.cfg, data_grid="equiangular"))
    eq.load_state_dict(stepper.module.state_dict())
    with torch.no_grad():
        got = stepper.model_fn(torch.from_numpy(x)).numpy()
        wrong = eq(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5
    assert np.abs(wrong - want).max() / scale > 1e-4


@pytest.mark.parametrize("legacy", [False, True])
def test_only_a_native_ace_checkpoint_is_read_without_weights_only(native, tmp_path,
                                                                   monkeypatch, legacy):
    """A native ACE checkpoint that ``weights_only=True`` refuses (an object
    in its config) is read again without it, and loads the same stepper;
    a file with ``config_json`` (the port's own), with neither a
    reference's nor an ACE stepper's keys, or with only ``module`` and
    ``config`` of them raises. Both torch formats."""
    def save(obj, name):
        torch.save(obj, str(tmp_path / name), _use_new_zipfile_serialization=not legacy)
        return str(tmp_path / name)

    state = dict(native["state"], config=dict(native["state"]["config"],
                                              namespace=argparse.Namespace(a=1)))
    stepper, _ = interface.load_ace_stepper_checkpoint(save({"stepper": state}, "ace.ckpt"),
                                                       device="cpu")
    want, _ = interface.load_ace_stepper_checkpoint(native["path"], device="cpu")
    for k, p in want.module.state_dict().items():
        assert torch.equal(stepper.module.state_dict()[k], p)
    loads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(k["weights_only"])
                        or real_load(*a, **k))
    port = {"config_json": "{}", "module": {}, "config": {},
            "namespace": argparse.Namespace(a=1)}
    other = {"weights": {}, "namespace": argparse.Namespace(a=1)}
    generic = {"module": {}, "config": {}, "namespace": argparse.Namespace(a=1)}
    for payload, name in ((port, "port.ckpt"), (other, "other.pt"), (generic, "generic.pt")):
        with pytest.raises(pickle.UnpicklingError, match="native ACE checkpoint"):
            interface.load_ace_stepper_checkpoint(save(payload, name), device="cpu")
    assert loads == [True, True, True]
    with pytest.raises(ValueError, match="not a native ACE checkpoint"):
        interface.load_ace_stepper_checkpoint(save({"stepper": {"module": {}}}, "x.pt"),
                                              device="cpu")


# ---------------------------------------------------- run_inference, ace path

def _log_tolerances(want: dict) -> dict:
    """``_assert_metrics``'s tolerance of each ``inference/`` log: 1e-4
    relative plus 1e-6 of the largest log of its metric."""
    logs = [k for k in want if k.startswith("inference/")]
    assert logs
    top = {}
    for k in logs:
        metric = k.rsplit("/", 1)[0]
        top[metric] = max(top.get(metric, 0.0), abs(want[k]))
    return {k: 1e-4 * abs(want[k]) + 1e-6 * top[k.rsplit("/", 1)[0]] for k in logs}


def _deviation(got: dict, want: dict):
    """The largest ``|got - want|`` of an ``inference/`` log in units of its
    ``_log_tolerances``, and that log's key."""
    return max((abs(got[k] - want[k]) / tol, k) for k, tol in _log_tolerances(want).items())


def _assert_metrics(got: dict, want: dict):
    """``metrics.json``: the same keys; every ``inference/`` log within its
    ``_log_tolerances``; the steps equal, ``loss_last_window`` 1e-5."""
    assert set(want) <= set(got)
    for k, tol in _log_tolerances(want).items():
        assert abs(got[k] - want[k]) <= tol, f"{k}: {got[k]} vs {want[k]}"
    assert got["n_forward_steps"] == want["n_forward_steps"]
    np.testing.assert_allclose(got["loss_last_window"], want["loss_last_window"], rtol=1e-5)


def _run_both(cfg, tmp_path):
    jmain_from_config(dict(cfg, experiment_dir=str(tmp_path / "jax")))
    out = main_from_config(dict(cfg, experiment_dir=str(tmp_path / "port"), platform="cpu"))
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())
    return out, got, want


def test_run_inference_ace_native_checkpoint_matches_jax(native, tmp_path):
    """``stepper_type: ace`` from the native checkpoint, 6 steps in windows
    of 3 with the diagnostics scored: ``metrics.json`` as JAX's
    (``_assert_metrics``). The run config's sigma replaces the checkpoint's
    (ak 0, bk to 0.1): on the synthetic source's O(1) fields the
    checkpoint's ak (33 Pa a level against a surface pressure of about 1)
    leaves the dry-air correction's denominator near 0, where float32
    rounding decides the result."""
    cfg = {"checkpoint_path": native["path"], "stepper_type": "ace", "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "verbose": False, "log_zonal_mean_images": False,
           "derived": True,
           "sigma_coordinates": {"ak": [0.0] * 4, "bk": [0.0, 0.03, 0.06, 0.1]}}
    out, got, want = _run_both(cfg, tmp_path)
    assert "inference/rmse/total_water_path" in want
    _assert_metrics(got, want)
    assert out["stepper"].corrector is not None and len(got["window_seconds"]) == 2


@pytest.fixture(scope="module")
def simultaneous_ckpt(tmp_path_factory, jax_fit):
    """A one-step simultaneous checkpoint of the JAX package (msgpack):
    ``jax_fit``'s trained weights and EMA (``horizon_at_once`` 1, window
    1)."""
    path = str(tmp_path_factory.mktemp("sim") / "ace.ckpt")
    jinterface.save_experiment_checkpoint(path, jax_fit["trainer"].state, _jax_cfg(FIT_CFG))
    return path


def test_run_inference_ace_from_simultaneous_checkpoint_matches_jax(simultaneous_ckpt,
                                                                    tmp_path):
    """``stepper_type: ace`` from a one-step simultaneous checkpoint with the
    prescribed ocean (``var_0`` where ``forcing_0`` rounds to 1), 8 steps in
    windows of 4, the EMA weights: ``metrics.json`` as JAX's."""
    cfg = {"checkpoint_path": simultaneous_ckpt, "stepper_type": "ace",
           "n_forward_steps": 8, "forward_steps_in_memory": 4, "verbose": False,
           "log_zonal_mean_images": False,
           "prescriber": {"prescribed_name": "var_0", "mask_name": "forcing_0"}}
    out, got, want = _run_both(cfg, tmp_path)
    _assert_metrics(got, want)
    st = out["stepper"]
    assert st.cfg.in_names == ["var_0", "var_1", "forcing_0"] and st.ocean is not None


def _ace_run(kind, native, simultaneous_ckpt):
    """The run configs of ``test_run_inference_ace_native_checkpoint_matches_jax``
    and ``test_run_inference_ace_from_simultaneous_checkpoint_matches_jax``,
    4 steps in windows of 2."""
    base = {"stepper_type": "ace", "n_forward_steps": 4, "forward_steps_in_memory": 2,
            "verbose": False, "log_zonal_mean_images": False}
    if kind == "native":
        return dict(base, checkpoint_path=native["path"], derived=True,
                    sigma_coordinates={"ak": [0.0] * 4, "bk": [0.0, 0.03, 0.06, 0.1]})
    return dict(base, checkpoint_path=simultaneous_ckpt,
                prescriber={"prescribed_name": "var_0", "mask_name": "forcing_0"})


# how much further from JAX's bf16 metrics a float32 run must stand than the
# port's bf16 run, both in units of _assert_metrics's per-log tolerance
F32_VS_BF16_MARGIN = 5.0


@pytest.mark.parametrize("kind", ["native", "simultaneous"])
def test_run_inference_ace_params_dtype_matches_jax(native, simultaneous_ckpt, tmp_path, kind):
    """``params_dtype: bfloat16`` on both ACE entries (a native checkpoint;
    an experiment checkpoint): the weights rounded to bf16 values, as JAX
    casts them (``_cast_tree_jit``), and ``metrics.json`` as JAX's
    (``_assert_metrics``). The rounding shows: weights moved off their
    float32 values, and from the experiment checkpoint (the native
    network's small spectral weights barely move its logs) a float32 run's
    ``metrics.json`` stands clearly further from JAX's: its largest log
    deviation, in units of ``_assert_metrics``'s tolerance, at least
    ``F32_VS_BF16_MARGIN`` times the bf16 run's (about 0.99 against 0.098
    on the CPU, where whether the float32 run also exceeds the tolerance
    depends on how the XLA-CPU build rounds)."""
    cfg = dict(_ace_run(kind, native, simultaneous_ckpt), params_dtype="bfloat16")
    out, got, want = _run_both(cfg, tmp_path)
    _assert_metrics(got, want)
    rounded = dict(out["stepper"].module.named_parameters())
    assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in rounded.values())
    f32 = main_from_config(dict(cfg, params_dtype=None, platform="cpu",
                                experiment_dir=str(tmp_path / "f32")))
    assert any(not torch.equal(p, rounded[k])
               for k, p in f32["stepper"].module.named_parameters())
    if kind == "simultaneous":
        bf16_dev, bf16_key = _deviation(got, want)
        f32_dev, f32_key = _deviation(
            json.loads((tmp_path / "f32" / "metrics.json").read_text()), want)
        assert f32_dev >= F32_VS_BF16_MARGIN * bf16_dev, (
            f"float32 run {f32_dev:.4f} ({f32_key}) against bf16 run {bf16_dev:.4f} "
            f"({bf16_key}) of the tolerance: not {F32_VS_BF16_MARGIN}x apart")


@pytest.mark.parametrize("kind", ["native", "simultaneous"])
def test_run_inference_ace_reads_a_data_path_as_jax(native, simultaneous_ckpt, tmp_path, kind):
    """Both ACE entries over ``validation_loader.dataset.data_path``: two
    netCDF files written by ``write_hdf5`` (a window crosses them) with the
    stepper's fields, ``lat``/``lon`` and, for the experiment checkpoint,
    whose sigma comes from the source, ``ak_*``/``bk_*``; ``metrics.json``
    as JAX's, the source's sigma in the stepper. A ``data_path`` that does
    not exist falls back to the synthetic source repeated ``max(4,
    n_forward_steps)`` times, as JAX's ``_ace_source`` does, so a rollout
    longer than a window still runs: ``metrics.json`` as JAX's."""
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5

    names = (["PRESsfc", "specific_total_water_0", "DSWRFtoa"] if kind == "native"
             else ["var_0", "var_1", "forcing_0"])
    rng = np.random.default_rng(7)
    d = tmp_path / "data"
    d.mkdir()
    for i, n in enumerate((3, 4)):
        variables = {v: (1.0 + 0.2 * rng.standard_normal((n, H, W))).astype(np.float32)
                     for v in names}
        variables.update(lat=np.linspace(-78.75, 78.75, H), lon=np.linspace(0, 337.5, W),
                         ak_0=np.float64(0.0), ak_1=np.float64(10.0), bk_0=np.float64(0.0),
                         bk_1=np.float64(0.5))
        write_hdf5(str(d / f"part_{i}.nc"), variables)
    cfg = dict(_ace_run(kind, native, simultaneous_ckpt), n_forward_steps=6,
               validation_loader={"dataset": {"data_path": str(d)}})
    out, got, want = _run_both(cfg, tmp_path)
    _assert_metrics(got, want)
    assert got["n_forward_steps"] == 6
    if kind == "simultaneous":
        assert out["stepper"].sigma.as_dict() == {"ak": [0.0, 10.0], "bk": [0.0, 0.5]}

    missing = dict(_ace_run(kind, native, simultaneous_ckpt),
                   validation_loader={"dataset": {"data_path": str(tmp_path / "absent")}})
    assert missing["n_forward_steps"] > missing["forward_steps_in_memory"]
    (tmp_path / "missing").mkdir()
    _, got, want = _run_both(missing, tmp_path / "missing")
    _assert_metrics(got, want)
    assert got["n_forward_steps"] == 4


def test_run_inference_ace_overrides_and_refusals(native, simultaneous_ckpt, tmp_path):
    """The run config's corrector, ocean and sigma override the native
    checkpoint's (a new mask name gets mean 0 and std 1, as in JAX); the
    ACE path refuses an ensemble, ``preds_dtype``, ``mask_value`` other
    than 1, a model of more than one step; it writes the prediction file."""
    from spherical_dyffusion_tpu.run_inference import (
        _apply_ace_physics_overrides as japply,
    )
    from spherical_dyffusion_tpu_torch.run_inference import _apply_ace_physics_overrides

    over = {"corrector": {"zero_global_mean_moisture_advection": False},
            "ocean": {"surface_temperature_name": "PRESsfc", "ocean_fraction_name": "land"},
            "sigma_coordinates": {"ak": [0.0, 5.0], "bk": [0.0, 1.0]}}
    jstep = native["jstep"]
    stepper, _ = interface.load_ace_stepper_checkpoint(native["path"], device="cpu")
    want, got = japply(over, jstep), _apply_ace_physics_overrides(over, stepper)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.normalizer.get_state() == want.normalizer.get_state()
    assert got.get_state()["sigma_coordinates"] == want.get_state()["sigma_coordinates"]
    assert got.module is stepper.module

    base = {"checkpoint_path": native["path"], "stepper_type": "ace", "platform": "cpu",
            "experiment_dir": str(tmp_path), "verbose": False}
    for bad, match in (({"n_ensemble": 2}, "n_ensemble"), ({"preds_dtype": "bfloat16"},
                                                          "preds_dtype"),
                       ({"prescriber": {"prescribed_name": "PRESsfc", "mask_name": "m",
                                        "mask_value": 0}}, "mask_value")):
        with pytest.raises(ValueError, match=match):
            main_from_config({**base, **bad})
    # the writers are ported (Queue 1 item 8b): the prognostic fields, (1, T, H, W)
    out = main_from_config({**base, "n_forward_steps": 4, "forward_steps_in_memory": 2,
                            "data_writer": {"save_prediction_files": True}})
    with hdf5.File(str(tmp_path / "autoregressive_predictions.nc")) as f:
        assert sorted(k for k in f.keys() if k not in ("lat", "lon")) == sorted(
            out["stepper"].cfg.out_names)
        assert all(f[n].shape == (1, 4) + tuple(stepper.area.shape)
                   for n in out["stepper"].cfg.out_names)
    with pytest.raises(ValueError, match="overrides"):
        main_from_config({**base, "overrides": {"datamodule": {"horizon": 2}}})
    exp = interface.load_experiment_checkpoint(simultaneous_ckpt, device="cpu")[0]
    from spherical_dyffusion_tpu_torch.run_inference import _run_ace_from_checkpoint

    exp.horizon_at_once = 2
    with pytest.raises(ValueError, match="one-step"):
        _run_ace_from_checkpoint(base, exp, {}, torch.device("cpu"))


def test_run_inference_ace_model_overrides_turn_the_kernels_on(native, tmp_path, monkeypatch):
    """A native checkpoint whose builder config names no kernel, with the
    run config's ``overrides["model"]`` setting ``use_pallas`` and
    ``fused_tail``: the loaded network routes through K1's and K3's
    wrappers (counted here through the plain versions they compute on the
    CPU: K1 once and K3 once per layer and step), and ``metrics.json``
    equals the run without the overrides bit for bit."""
    from spherical_dyffusion_tpu_torch.ops import fused_mlp

    calls = {"K1": 0, "K3": 0}
    real_k1, real_k3 = pc.dhconv_plain, fused_mlp.fused_block_tail_plain
    monkeypatch.setattr(pc, "dhconv_plain", lambda *a: calls.__setitem__(
        "K1", calls["K1"] + 1) or real_k1(*a))
    monkeypatch.setattr(fused_mlp, "fused_block_tail_plain", lambda *a, **k: calls.__setitem__(
        "K3", calls["K3"] + 1) or real_k3(*a, **k))
    cfg = {"checkpoint_path": native["path"], "stepper_type": "ace", "n_forward_steps": 4,
           "forward_steps_in_memory": 2, "verbose": False, "log_zonal_mean_images": False,
           "platform": "cpu"}
    metrics = []
    for over in (None, {"model": {"use_pallas": True, "fused_tail": True}}):
        out_dir = tmp_path / ("kernels" if over else "plain")
        res = main_from_config(dict(cfg, experiment_dir=str(out_dir),
                                    **({"overrides": over} if over else {})))
        mcfg = res["stepper"].module.cfg
        assert (mcfg.use_pallas, mcfg.fused_tail) == ((True, True) if over else (False, False))
        metrics.append(json.loads((out_dir / "metrics.json").read_text()))
    assert calls == {"K1": 4, "K3": 4}
    logs = [{k: v for k, v in m.items() if k.startswith("inference/")} for m in metrics]
    assert logs[0] == logs[1]


def test_run_inference_ace_slab_ocean_matches_jax(tmp_path, monkeypatch):
    """``stepper_type: ace`` with the run config's ``ocean.slab``: a native
    checkpoint whose network (embed 8, 1 layer) predicts the surface
    pressure, the surface temperature, one water level and the six surface
    energy fluxes the slab reads (``main_path.SLAB_FLUXES``), over netCDF
    files of ``main_path.AceBenchSource`` frames with the mixed-layer depth
    and the Q-flux added (``main_path.SLAB_FIELDS``), the checkpoint's
    normalizer at the source's statistics; 6 steps in windows of 3 with the
    dry-air corrector: ``metrics.json`` as JAX's (``_assert_metrics``'s
    tolerances; float32 sums of 1e5 Pa surface pressures differ by a few
    0.0078 Pa steps between the packages, so the surface pressure's logs
    may also move by 4 such steps, and the averages over the fields by 4
    steps over the field count). In
    the port's first window the surface temperature over the ocean (the
    mask rounds to 1) is the step's input plus the slab tendency of the
    generated fluxes, the target's Q-flux and depth
    (``inference/ocean.py:mixed_layer_temperature_tendency``) over 6 hours,
    computed here in float64: within 4 float32 spacings of the largest
    surface temperature, and moved by more than 100 of them."""
    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5
    from spherical_dyffusion_tpu_torch.inference.ace_stepper import SingleStepStepper
    from spherical_dyffusion_tpu_torch.inference.ocean import mixed_layer_temperature_tendency

    in_names, out_names, all_names = main_path.ace_names(1, 6, slab=True)
    base = dict(img_shape=(H, W), in_chans=len(in_names), out_chans=len(out_names),
                embed_dim=8, num_layers=1, with_time_emb=False,
                activation_function="gelu_exact", exact_norm=True)
    state = _native_state(in_names, out_names, base, _port_sfno_params(**base),
                          {"scale_factor": 1, "data_grid": "equiangular"}, sigma_k=1,
                          corrector={"conserve_dry_air": True})
    state["normalizer"] = {"means": {n: main_path._ace_mean(n) for n in in_names},
                           "stds": {n: main_path._ace_std(n) for n in in_names}}
    ckpt = str(tmp_path / "ace_slab.ckpt")
    torch.save({"stepper": state}, ckpt)
    src = main_path.AceBenchSource(all_names, 7, (H, W), seed=5)
    frames = src.read_window(0, 7, all_names)
    d = tmp_path / "data"
    d.mkdir()
    for i, (a, b) in enumerate(((0, 3), (3, 7))):
        variables = {n: frames[n][a:b] for n in all_names}
        variables.update(lat=np.linspace(-78.75, 78.75, H), lon=np.linspace(0, 337.5, W))
        write_hdf5(str(d / f"part_{i}.nc"), variables)
    slab = {"mixed_layer_depth_name": main_path.SLAB_FIELDS[0],
            "q_flux_name": main_path.SLAB_FIELDS[1]}
    cfg = {"checkpoint_path": ckpt, "stepper_type": "ace", "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "verbose": False, "log_zonal_mean_images": False,
           "validation_loader": {"dataset": {"data_path": str(d)}},
           "ocean": {"surface_temperature_name": "surface_temperature",
                     "ocean_fraction_name": main_path.MASK_NAME, "slab": slab}}
    windows = []
    real = SingleStepStepper.run_on_batch
    monkeypatch.setattr(SingleStepStepper, "run_on_batch",
                        lambda self, *a, **k: windows.append(real(self, *a, **k)) or windows[-1])
    out, got, want = _run_both(cfg, tmp_path)
    pa = 4 * float(np.spacing(np.float32(1e5)))
    assert set(want) <= set(got)
    for k, tol in _log_tolerances(want).items():
        steps = (pa if k.endswith("/PRESsfc") else
                 pa / len(out_names) if k.startswith("inference/avg/") else 0.0)
        assert abs(got[k] - want[k]) <= tol + steps, f"{k}: {got[k]} vs {want[k]}"
    assert got["n_forward_steps"] == want["n_forward_steps"] == 6
    np.testing.assert_allclose(got["loss_last_window"], want["loss_last_window"], rtol=1e-5)
    assert out["stepper"].ocean.type == "slab" and len(windows) == 2

    gen = {n: v[0].double() for n, v in windows[0].gen_data.items()}
    f64 = {n: torch.from_numpy(frames[n][:4]).double() for n in all_names}
    sst = "surface_temperature"
    spacing = 4 * float(np.spacing(np.float32(np.abs(frames[sst]).max())))
    moved = 0.0
    for t in range(1, 4):
        flux = (gen["DLWRFsfc"][t] - gen["ULWRFsfc"][t] + gen["DSWRFsfc"][t]
                - gen["USWRFsfc"][t] - gen["LHTFLsfc"][t] - gen["SHTFLsfc"][t])
        tend = mixed_layer_temperature_tendency(flux, f64["q_flux"][t],
                                                f64["mixed_layer_depth"][t])
        want_sst = f64[sst][t - 1] + tend * 21600.0
        ocean = torch.round(f64[main_path.MASK_NAME][t]) == 1
        assert ocean.any()
        assert float((gen[sst][t] - want_sst)[ocean].abs().max()) <= spacing
        moved = max(moved, float((want_sst - f64[sst][t - 1])[ocean].abs().max()))
    assert moved > 100 * spacing
