"""Parity of the port's training options with the JAX package, on the CPU:
remat (``checkpointing >= 3``), DYffusion's ``data+noise`` forward
conditionings, ``interpolator_use_ema``, and reference checkpoints with
non-linear filters.

Debug size: SFNOs at embed 16 x 2 layers (x 3 under ``scan_layers``) on
16 x 32, horizon 3, 5 state channels and 2 forcings from each package's
``DebugDataModule`` (the same numpy data), weights made by the JAX
initializers and carried over by ``utils/convert.py``. Where the two
packages are compared, dropout is off and the random draws are pinned in
both (the timesteps as ``tests/test_torch_port_train.py`` pins them, the
condition noise by patching each package's draw).

Tolerances: the training tests' (``tests/test_torch_port_train.py``):
losses 1e-5 relative, gradients 1e-4 of each tensor's largest entry (or of
1e-4 of the network's largest where a tensor's gradient cancels below
that); forwards 1e-5 of the largest output. Remat against no remat in the
port, with dropout and DropPath live: losses and gradients within 1e-6 of
each tensor's largest entry (the recompute is the same float32 arithmetic
on the same masks), and the generator's state after the step equal.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spherical_dyffusion_tpu.interface as jinterface
from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.diffusion import dyffusion as jdyffusion
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecast,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu.utils.torch_convert import sfno_flax_to_torch
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.diffusion import dyffusion
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig, predict_x_last
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

H, W, HORIZON, C, CF = 16, 32, 3, 5, 2
DM_KW = dict(channels=C, height=H, width=W, horizon=HORIZON, n_forcing=CF, batch_size=1)


def _model_kw(kind, **kw):
    base = dict(img_shape=(H, W), out_chans=C, embed_dim=16, num_layers=2,
                operator_type="dhconv", with_time_emb=True, max_time=HORIZON - 1)
    if kind == "interpolator":
        base.update(in_chans=2 * C + CF, min_time=1)
    else:
        base.update(in_chans=C + CF, min_time=0)
    base.update(kw)
    return base


def _boost(tree):
    return {k: (_boost(v) if isinstance(v, dict) else (v * 64.0 if k == "weight" else v))
            for k, v in tree.items()}


def _jax_model(kind, seed, **kw):
    cfg = JSFNOConfig(**_model_kw(kind, **kw))
    model = JSFNO(cfg)
    x = jnp.zeros((1, H, W, cfg.in_chans - CF))
    v = model.init(jax.random.PRNGKey(seed), x, time=jnp.ones((1,)), condition=jnp.zeros(
        (1, H, W, CF)))
    return model, {**v, "params": _boost(v["params"])}


def _port_model(kind, variables, **kw):
    net = SFNO(SFNOConfig(**_model_kw(kind, **kw)))
    net.load_state_dict(flax_to_state_dict(variables))
    return net


def _jax_side(dcfg_kw=None, fc_kw=None, **model_kw):
    """The JAX side, {"dm", "interp", "forecast", "ivars", "fvars", "kw"}."""
    jdm = JDebugDataModule(n_timesteps=8, **DM_KW)
    fc_kw = {**model_kw, **(fc_kw or {})}
    jim, ivars = _jax_model("interpolator", 0, **model_kw)
    jfm, fvars = _jax_model("forecaster", 1, **fc_kw)
    dk = {**dict(timesteps=HORIZON, forward_conditioning="none", time_encoding="dynamics"),
          **(dcfg_kw or {})}
    jinterp = JInterp(jim, JExperimentConfig(horizon=HORIZON), jdm.in_packer, jdm.out_packer,
                      jdm.normalizer)
    jfc = JForecast(jfm, jinterp, ivars, JDYffusionConfig(**dk), JExperimentConfig(
        horizon=HORIZON), jdm.in_packer, jdm.out_packer, jdm.normalizer,
        forcing_names=jdm.cfg.forcing_names, forcing_normalizer=jdm.forcing_normalizer)
    return dict(dm=jdm, interp=jinterp, forecast=jfc, ivars=ivars, fvars=fvars,
                kw=(dk, model_kw, fc_kw))


def _port_side(jside, **model_over):
    """The port side, {"dm", "interp", "forecast"}, with the JAX side's
    weights (and ``model_over`` changing both networks' configs)."""
    dk, model_kw, fc_kw = jside["kw"]
    dm = DebugDataModule(n_timesteps=8, **DM_KW)
    interp = InterpolationExperiment(
        _port_model("interpolator", jside["ivars"], **{**model_kw, **model_over}),
        ExperimentConfig(horizon=HORIZON), dm.in_packer, dm.out_packer, dm.normalizer)
    fc = DYffusionForecastingExperiment(
        _port_model("forecaster", jside["fvars"], **{**fc_kw, **model_over}), interp,
        DYffusionConfig(**dk), ExperimentConfig(horizon=HORIZON), dm.in_packer,
        dm.out_packer, dm.normalizer, forcing_names=dm.cfg.forcing_names,
        forcing_normalizer=dm.forcing_normalizer)
    return dict(dm=dm, interp=interp, forecast=fc)


def _build(dcfg_kw=None, fc_kw=None, **model_kw):
    """(JAX side, port side): the same weights and data in both packages."""
    jside = _jax_side(dcfg_kw, fc_kw, **model_kw)
    return jside, _port_side(jside)


@pytest.fixture
def pin_t(monkeypatch):
    """Pin both packages' timestep draws to ``t`` (one value per sample)."""

    def pin(t):
        t = list(t)
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, minval, maxval, *a, **k:
                            jnp.asarray(t[:shape[0]], jnp.int32))
        real = torch.randint

        def fake(low, high=None, size=None, *a, **k):
            if size is not None and high is not None and len(size) == 1:
                return torch.tensor(t[:size[0]], dtype=torch.long)
            return real(low, high, size, *a, **k)

        monkeypatch.setattr(torch, "randint", fake)

    return pin


def _assert_grads(got: dict, want: dict, rel: float = 1e-4):
    top = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, f"{k}: {err:.3g} vs {rel:g} x {scale:.3g}"


def _jax_value_and_grad(exp, variables, dyn, cond, **extra):
    consts = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return exp.train_loss({**consts, "params": p}, jnp.asarray(dyn), jax.random.PRNGKey(0),
                              dynamical_condition=jnp.asarray(cond), **extra)[0]

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    return float(loss), {k: v.numpy() for k, v in flax_to_state_dict({"params": grads}).items()}


def _port_value_and_grad(exp, dyn, cond, generator=None):
    loss, _ = exp.train_loss(torch.tensor(dyn), generator or torch.Generator().manual_seed(0),
                             dynamical_condition=torch.tensor(cond))
    names = [n for n, _ in exp.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(exp.model.parameters()))
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def _batch(jside, n=2):
    jdm = jside["dm"]
    b = [jdm.dataset("train")[i] for i in range(n)]
    dyn = np.stack([s["dynamics"] for s in b])
    cond = np.stack([s["dynamical_condition"] for s in b])
    return np.asarray(jdm.normalizer.normalize(jnp.asarray(dyn))), cond


# ------------------------------------------------------------------ remat

@pytest.mark.parametrize("kind,scan", [("interp", True), ("forecast", False)])
def test_remat_train_step_matches_jax(pin_t, kind, scan):
    """One training step's loss and gradients with ``checkpointing=3``
    against the JAX package's ``nn.remat`` model (its scan body too under
    ``scan_layers``), dropout off; the port remats every block (the blocks
    run again in the backward)."""
    kw = dict(checkpointing=3, scan_layers=scan, num_layers=3 if scan else 2)
    jside, tside = _build(**kw)
    dyn, cond = _batch(jside)
    pin_t((1, 2))
    calls = []
    for block in tside[kind].model.blocks:
        block.register_forward_pre_hook(lambda *a: calls.append(None))
    extra = dict(aux_params=jside["ivars"]) if kind == "forecast" else {}
    jl, jg = _jax_value_and_grad(jside[kind], jside["fvars" if kind == "forecast" else "ivars"],
                                 dyn, cond, **extra)
    tl, tg = _port_value_and_grad(tside[kind], dyn, cond)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)
    assert len(calls) == 2 * kw["num_layers"]


@pytest.mark.parametrize("kind,scan", [("interp", False), ("interp", True),
                                       ("forecast", False)])
def test_remat_replays_dropout_and_drop_path(kind, scan):
    """With MLP dropout, DropPath and position-embedding dropout live (0.1
    each, the interpolator's rates of the main path), a training step with
    remat gives the losses and gradients of the step without it (1e-6 of
    each tensor's largest entry) and leaves the caller's generator in the
    same state; the masks are live (a second draw gives another loss) and
    the recompute ran."""
    kw = dict(dropout_mlp=0.1, drop_path_rate=0.1, pos_emb_dropout=0.1, scan_layers=scan,
              num_layers=3 if scan else 2)
    jside = _jax_side(**kw)
    dyn, cond = _batch(jside)

    def step(checkpointing, seed=5):
        exp = _port_side(jside, checkpointing=checkpointing)[kind]
        calls = []
        for block in exp.model.blocks:
            block.register_forward_pre_hook(lambda *a: calls.append(None))
        gen = torch.Generator().manual_seed(seed)
        loss, grads = _port_value_and_grad(exp, dyn, cond, gen)
        return loss, grads, gen.get_state(), len(calls)

    l0, g0, s0, n0 = step(0)
    l3, g3, s3, n3 = step(3)
    assert (n0, n3) == (kw["num_layers"], 2 * kw["num_layers"])
    assert abs(l3 - l0) <= 1e-6 * abs(l0)
    _assert_grads(g3, g0, rel=1e-6)
    assert torch.equal(s3, s0)
    assert step(3, seed=6)[0] != l3


# --------------------------------------------------------- data+noise

def _pin_noise(monkeypatch, noise):
    """Both packages' condition noise is ``noise`` (numpy)."""
    real = jax.random.normal

    def jnoise(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return real(key, shape, dtype)

    monkeypatch.setattr(jdyffusion.jax.random, "normal", jnoise)
    monkeypatch.setattr(dyffusion, "forward_noise",
                        lambda x, generator, mesh=None: torch.from_numpy(noise).to(x.dtype))


@pytest.mark.parametrize("ctype", ["data+noise-v1", "data+noise-v2"])
def test_data_noise_predict_x_last_and_p_losses_match_jax(pin_t, monkeypatch, ctype):
    """``predict_x_last`` (per-sample steps 0 and 2 of N = 3: the factor
    t / (N - 1) at both ends) and ``p_losses`` with its gradients, on a
    forecaster built with the C extra condition channels in both packages,
    the noise pinned."""
    jside, tside = _build(dcfg_kw=dict(forward_conditioning=ctype),
                          fc_kw=dict(in_chans=2 * C + CF))
    dyn, cond = _batch(jside)
    noise = np.random.default_rng(3).standard_normal((2, H, W, C)).astype(np.float32)
    _pin_noise(monkeypatch, noise)
    jfc, fc = jside["forecast"], tside["forecast"]
    ic, xt = dyn[:, 0], dyn[:, 1]
    t = np.asarray([0.0, 2.0], np.float32)
    want = jdyffusion.predict_x_last(
        jfc._forecast_fn(jside["fvars"]), jfc.diffusion_cfg, jfc.sched, jnp.asarray(ic),
        jnp.asarray(xt), jnp.asarray(t), jax.random.PRNGKey(1),
        dynamical_condition=jnp.asarray(cond))
    with torch.no_grad():
        got = predict_x_last(fc._forecast_fn(), fc.diffusion_cfg, fc.sched,
                             torch.from_numpy(ic), torch.from_numpy(xt), torch.from_numpy(t),
                             dynamical_condition=torch.from_numpy(cond),
                             generator=torch.Generator().manual_seed(1))
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    pin_t((1, 2))
    jl, jg = _jax_value_and_grad(jfc, jside["fvars"], dyn, cond, aux_params=jside["ivars"])
    tl, tg = _port_value_and_grad(fc, dyn, cond)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)


def test_data_noise_is_drawn_from_the_generator():
    """Unpinned, the noise comes from the caller's generator: the same seed
    gives the same forecast, another seed another, and the "data"
    conditioning draws nothing."""
    _, tside = _build(dcfg_kw=dict(forward_conditioning="data+noise-v2"),
                      fc_kw=dict(in_chans=2 * C + CF))
    fc = tside["forecast"]
    x = torch.randn(1, H, W, C, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([1.0])

    def run(seed):
        with torch.no_grad():
            return predict_x_last(fc._forecast_fn(), fc.diffusion_cfg, fc.sched, x, x, t,
                                  static_condition=torch.zeros(1, H, W, CF),
                                  generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="generator"):
        predict_x_last(fc._forecast_fn(), fc.diffusion_cfg, fc.sched, x, x, t)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    data = dataclasses.replace(fc.diffusion_cfg, forward_conditioning="data")
    with torch.no_grad():
        predict_x_last(lambda *a: a[0], data, fc.sched, x, x, t, generator=gen)
    assert torch.equal(gen.get_state(), state)


# ----------------------------------------- experiments built from configs

CFG = {
    "experiment": "interpolation",
    "datamodule": {"kind": "debug", "channels": 2, "height": 8, "width": 16,
                   "horizon": 3, "n_forcing": 1, "batch_size": 4, "n_timesteps": 24},
    "model": {"kind": "sfno", "embed_dim": 8, "num_layers": 1, "dropout_mlp": 0.1},
    "module": {"enable_inference_dropout": True},
}


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """JAX interpolator checkpoints, trained one epoch with EMA and built
    without (as ``tests/test_cli.py`` makes them)."""
    d = tmp_path_factory.mktemp("ck")
    paths = {"ema": str(d / "ipol.ckpt"), "noema": str(d / "ipol_noema.ckpt")}
    dm = jinterface.get_datamodule(CFG)
    tr = JTrainer(jinterface.get_experiment(CFG, dm), dm,
                  JTrainerConfig(epochs=1, warmup_steps=2))
    tr.fit(verbose=False, val_every=100)
    jinterface.save_experiment_checkpoint(paths["ema"], tr.state, CFG)
    dm = jinterface.get_datamodule(CFG)
    tr = JTrainer(jinterface.get_experiment(CFG, dm), dm,
                  JTrainerConfig(epochs=0, steps_per_epoch=1, warmup_steps=1, use_ema=False))
    tr.fit(verbose=False, val_every=100)
    jinterface.save_experiment_checkpoint(paths["noema"], tr.state, CFG)
    return paths


def _dyffusion_cfg(path, **diffusion):
    return dict(CFG, experiment="dyffusion",
                diffusion={"forward_conditioning": "none", "interpolator_checkpoint_path": path,
                           **diffusion})


def _equal_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_interpolator_use_ema_through_get_experiment(jax_ckpts):
    """``interpolator_use_ema`` runs the interpolator checkpoint's EMA
    weights, those JAX's experiment runs (its ``aux_params``), bit for bit;
    without it the trained weights; the two differ."""
    _, params, ema, _ = interface.load_experiment_checkpoint(jax_ckpts["ema"], device="cpu")
    nets = {}
    for use_ema in (True, False):
        cfg = _dyffusion_cfg(jax_ckpts["ema"], interpolator_use_ema=use_ema)
        jexp = jinterface.get_experiment(cfg, jinterface.get_datamodule(cfg))
        exp = interface.get_experiment(cfg, interface.get_datamodule(cfg), device="cpu")
        want = flax_to_state_dict(jexp.aux_params)
        _equal_sd(exp.interpolator.model.state_dict(), want)
        _equal_sd(exp.interpolator.model.state_dict(), ema if use_ema else params)
        nets[use_ema] = want
    assert any(not torch.equal(nets[True][k], nets[False][k]) for k in nets[True])


def test_interpolator_use_ema_through_a_checkpoint(jax_ckpts, tmp_path):
    """A DYffusion checkpoint whose config sets ``interpolator_use_ema``
    rebuilds, through ``load_experiment_checkpoint``, with the
    interpolator's EMA weights, as in JAX."""
    cfg = _dyffusion_cfg(jax_ckpts["ema"], interpolator_use_ema=True)
    dm = jinterface.get_datamodule(cfg)
    tr = JTrainer(jinterface.get_experiment(cfg, dm), dm,
                  JTrainerConfig(epochs=0, steps_per_epoch=1, warmup_steps=1))
    path = str(tmp_path / "dyff.ckpt")
    jinterface.save_experiment_checkpoint(
        path, tr.init_state(next(iter(dm.train_batches(seed=0)))), cfg)
    jexp = jinterface.load_experiment_checkpoint(path)[0]
    exp, _, _, got_cfg = interface.load_experiment_checkpoint(path, device="cpu")
    assert got_cfg["diffusion"]["interpolator_use_ema"] is True
    _equal_sd(exp.interpolator.model.state_dict(), flax_to_state_dict(jexp.aux_params))
    _equal_sd(exp.interpolator.model.state_dict(),
              interface.load_experiment_checkpoint(jax_ckpts["ema"], device="cpu")[2])


def test_interpolator_use_ema_without_ema_raises(jax_ckpts):
    cfg = _dyffusion_cfg(jax_ckpts["noema"], interpolator_use_ema=True)
    with pytest.raises(ValueError, match="interpolator_use_ema"):
        jinterface.get_experiment(cfg, jinterface.get_datamodule(cfg))
    with pytest.raises(ValueError, match="interpolator_use_ema"):
        interface.get_experiment(cfg, interface.get_datamodule(cfg), device="cpu")


@pytest.mark.parametrize("ctype", ["data+noise-v1", "data+noise-v2"])
def test_data_noise_forecaster_channels_as_in_jax(jax_ckpts, ctype):
    """The JAX package builds a ``data+noise`` forecaster with condition
    channels for "data" only (C + CF = 3 here), so its first training step,
    which feeds the noised condition too (2C + CF = 5), fails; the port keeps
    that channel count and raises at experiment build, naming both."""
    cfg = _dyffusion_cfg(jax_ckpts["ema"], forward_conditioning=ctype)
    dm = jinterface.get_datamodule(cfg)
    jexp = jinterface.get_experiment(cfg, dm)
    assert jexp.model.cfg.in_chans == 3
    tr = JTrainer(jexp, dm, JTrainerConfig(epochs=1, steps_per_epoch=1, warmup_steps=1))
    with pytest.raises(flax.errors.ScopeParamShapeError, match=r"\(5, 8\).*\(3, 8\)"):
        tr.fit(verbose=False, val_every=100)
    with pytest.raises(ValueError, match="3 input channels.*feed it 5"):
        interface.get_experiment(cfg, interface.get_datamodule(cfg), device="cpu")


# ----------------------------------- reference checkpoints, non-linear filters

@pytest.mark.parametrize("operator_type", ["diagonal", "l-dependant"])
def test_reference_nonlinear_checkpoint_loads_as_in_jax(tmp_path, operator_type):
    """A reference Lightning interpolator checkpoint whose SFNO has the
    non-linear filter (every leaf randomized, exported by the JAX package's
    ``sfno_flax_to_torch``, as ``tests/test_parity.py`` builds them) loads
    into the port with JAX's weights and gives JAX's forward (1e-5); a
    ComplexReLU with a bias raises, as in JAX."""
    shape, cin = (16, 32), 2 * 3 + 1
    net = SFNO(SFNOConfig(img_shape=shape, in_chans=cin, out_chans=3, embed_dim=8, num_layers=2,
                          filter_type="non-linear", operator_type=operator_type,
                          spectral_layers=2, with_time_emb=True))
    rng = np.random.default_rng(4)
    sd = sfno_flax_to_torch(state_dict_to_flax(
        {k: torch.from_numpy(0.5 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
         for k, p in net.state_dict().items()}))
    hp = {"model_config": {"_target_": "src.models.sfno.sfnonet.SphericalFourierNeuralOperatorNet",
                           "filter_type": "non-linear", "operator_type": operator_type,
                           "embed_dim": 8, "num_layers": 2},
          "datamodule_config": {"in_names": ["a", "b", "c", "f"], "forcing_names": ["f"],
                                "out_names": ["a", "b", "c"], "horizon": 3, "window": 1}}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.array(a))
                               for k, a in sd.items()}, "hyper_parameters": hp}, path)
    jexp, jvars, _, _ = jinterface.load_reference_checkpoint(path)
    exp, params, _, _ = interface.load_experiment_checkpoint(path, device="cpu")
    assert exp.model.cfg.filter_type == "non-linear"
    assert exp.model.cfg.operator_type == operator_type
    _equal_sd(params, flax_to_state_dict(jvars))
    r = np.random.default_rng(5)
    x = r.standard_normal((2,) + shape + (cin - 1,)).astype(np.float32)
    c = r.standard_normal((2,) + shape + (1,)).astype(np.float32)
    t = np.asarray([1.0, 2.0], np.float32)
    want = np.asarray(jexp.model.apply(jvars, jnp.asarray(x), time=jnp.asarray(t),
                                       condition=jnp.asarray(c)))
    with torch.no_grad():
        got = exp.model(torch.from_numpy(x), time=torch.from_numpy(t),
                        condition=torch.from_numpy(c)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    sd["blocks.0.filter.activations.0.bias"] = np.zeros(1, np.float32)
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.array(a))
                               for k, a in sd.items()}, "hyper_parameters": hp}, path)
    with pytest.raises(NotImplementedError, match="ComplexReLU"):
        jinterface.load_reference_checkpoint(path)
    with pytest.raises(NotImplementedError, match="ComplexReLU"):
        interface.load_experiment_checkpoint(path, device="cpu")
