"""Parity of the port's training path with the JAX package, on the CPU.

Debug size: SFNOs at embed 16 x 2 layers on 16 x 32, horizon 3, 5 state
channels and 2 forcings from each package's ``DebugDataModule`` (the same
numpy data). Weights are made by the JAX initializers (spectral weights
scaled up so the filter shows) and carried into the port with
``utils/convert.py``. Dropout is off and the timesteps are pinned (both
packages' draws patched inside the test), so the two sides compute the
same function: the losses of ``InterpolationExperiment.train_loss`` and of
``p_losses`` (with its ``lambda_reconstruction2`` term) and their
gradients, ``Trainer.fit``, validation, a JAX mid-training state carried
across, and the port's checkpoint resume.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each tensor's largest
entry, or of 1e-4 of the network's largest gradient entry where a tensor's
gradient cancels below that (a bias followed by an instance norm, which
removes it, leaves rounding); parameters and EMA as each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecast,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, train_state_payload

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


def _build(n_timesteps=8, dcfg_kw=None, **model_kw):
    """(JAX side, port side), each {"dm", "interp", "forecast", "ivars",
    "fvars"}: the same weights and data in both packages."""
    jdm, dm = JDebugDataModule(n_timesteps=n_timesteps, **DM_KW), \
        DebugDataModule(n_timesteps=n_timesteps, **DM_KW)
    jim, ivars = _jax_model("interpolator", 0, **model_kw)
    jfm, fvars = _jax_model("forecaster", 1, **model_kw)
    dk = dict(timesteps=HORIZON, forward_conditioning="none", time_encoding="dynamics",
              **(dcfg_kw or {}))
    jinterp = JInterp(jim, JExperimentConfig(horizon=HORIZON), jdm.in_packer, jdm.out_packer,
                      jdm.normalizer)
    jfc = JForecast(jfm, jinterp, ivars, JDYffusionConfig(**dk), JExperimentConfig(
        horizon=HORIZON), jdm.in_packer, jdm.out_packer, jdm.normalizer,
        forcing_names=jdm.cfg.forcing_names, forcing_normalizer=jdm.forcing_normalizer)
    interp = InterpolationExperiment(_port_model("interpolator", ivars, **model_kw),
                                     ExperimentConfig(horizon=HORIZON), dm.in_packer,
                                     dm.out_packer, dm.normalizer)
    fc = DYffusionForecastingExperiment(
        _port_model("forecaster", fvars, **model_kw), interp, DYffusionConfig(**dk),
        ExperimentConfig(horizon=HORIZON), dm.in_packer, dm.out_packer, dm.normalizer,
        forcing_names=dm.cfg.forcing_names, forcing_normalizer=dm.forcing_normalizer)
    return (dict(dm=jdm, interp=jinterp, forecast=jfc, ivars=ivars, fvars=fvars),
            dict(dm=dm, interp=interp, forecast=fc))


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


def _assert_grads(got: dict, want: dict):
    top = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-4 * scale, f"{k}: {err:.3g} vs 1e-4 x {scale:.3g}"


def _jax_value_and_grad(exp, variables, dyn, cond, **extra):
    consts = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return exp.train_loss({**consts, "params": p}, jnp.asarray(dyn), jax.random.PRNGKey(0),
                              dynamical_condition=jnp.asarray(cond), **extra)[0]

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    return float(loss), {k: v.numpy() for k, v in flax_to_state_dict({"params": grads}).items()}


def _port_value_and_grad(exp, dyn, cond, **extra):
    loss, _ = exp.train_loss(torch.tensor(dyn), torch.Generator().manual_seed(0),
                             dynamical_condition=torch.tensor(cond), **extra)
    names = [n for n, _ in exp.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(exp.model.parameters()))
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def _batch(jside, n=2, seed=0):
    """n samples stacked, normalized (numpy)."""
    jdm = jside["dm"]
    b = [jdm.dataset("train")[i] for i in range(n)]
    dyn = np.stack([s["dynamics"] for s in b])
    cond = np.stack([s["dynamical_condition"] for s in b])
    return np.asarray(jdm.normalizer.normalize(jnp.asarray(dyn))), cond


# ------------------------------------------------------- losses and grads

@pytest.mark.parametrize("t", [(1, 2), (2, 1)])
def test_interpolation_train_loss_and_grads_match_jax(pin_t, t):
    jside, tside = _build()
    dyn, cond = _batch(jside)
    pin_t(t)
    jl, jg = _jax_value_and_grad(jside["interp"], jside["ivars"], dyn, cond)
    tl, tg = _port_value_and_grad(tside["interp"], dyn, cond)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)


def test_interpolation_train_loss_with_random_timestep_matches_jax():
    """The sparse 'interpolation'-strategy batch: [window frames, frame at
    t, last frame] with the loader's draw."""
    jside, tside = _build()
    dyn, cond = _batch(jside)
    rt = np.asarray([2, 1])
    sparse = np.stack([dyn[0, [0, 2, 3]], dyn[1, [0, 1, 3]]])
    csparse = np.stack([cond[0, [0, 2, 3]], cond[1, [0, 1, 3]]])
    jl, jg = _jax_value_and_grad(jside["interp"], jside["ivars"], sparse, csparse,
                                 random_timestep=jnp.asarray(rt))
    tl, tg = _port_value_and_grad(tside["interp"], sparse, csparse,
                                  random_timestep=torch.from_numpy(rt))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("t,dcfg_kw", [
    ((0, 2), {}),
    ((1, 2), {}),
    ((0, 2), dict(lambda_reconstruction2=0.5)),
    ((1, 2), dict(lambda_reconstruction2=0.5, reconstruction2_detach_x_last=True)),
])
def test_p_losses_and_grads_match_jax(pin_t, t, dcfg_kw):
    """The forecaster's loss through p_losses (the t > 0 mask; the second
    term, masked where t + 1 is past the last step, with and without the
    detached x_last) and its gradients; the frozen interpolator gets none."""
    jside, tside = _build(dcfg_kw=dcfg_kw)
    dyn, cond = _batch(jside)
    pin_t(t)
    jl, jg = _jax_value_and_grad(jside["forecast"], jside["fvars"], dyn, cond,
                                 aux_params=jside["ivars"])
    tl, tg = _port_value_and_grad(tside["forecast"], dyn, cond)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg)
    assert all(p.grad is None for p in tside["interp"].model.parameters())


# -------------------------------------------------------------------- fit

class _Log:
    def __init__(self):
        self.rows = []

    def log(self, row, step=None):
        self.rows.append((step, dict(row)))

    def step_losses(self):
        return [r["train/loss"] for _, r in self.rows if "train/loss" in r]


def _assert_trees(got: dict, want: dict, lr_sum: float):
    """Parameters (or EMA) after Adam updates of total learning rate
    ``lr_sum``: within 1e-5 of each tensor's largest entry (optax evaluates
    the bias corrections in float32, 1 - 0.999 rounding 1.3e-5 off, which
    moves an update by about 6e-6 of its size), plus 2e-3 of ``lr_sum``:
    where a gradient entry is near Adam's eps (1e-8), as for a bias that an
    instance norm all but removes, the update follows the gradient's
    float32 rounding (a fraction of the learning rate), in either
    package."""
    for k, w in want.items():
        w = w.numpy()
        tol = 1e-5 * float(np.abs(w).max()) + 2e-3 * lr_sum
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= tol, f"{k}: {err:.3g} vs {tol:.3g}"


@pytest.mark.parametrize("kind", ["interp", "forecast"])
def test_fit_matches_jax_fit(pin_t, kind):
    """Trainer.fit, 2 epochs of 2 steps, lr 4e-4 after one warm-up step
    (cosine to 0 over the 4 steps), from the same weights: per-step losses
    1e-5 relative; final parameters and EMA as ``_assert_trees``."""
    pin_t((1,))
    jside, tside = _build(n_timesteps=5)
    exp_j, exp_t = jside[kind], tside[kind]
    kw = dict(epochs=2, warmup_steps=1, log_every=1)
    jtr = JTrainer(exp_j, jside["dm"], JTrainerConfig(**kw))
    jtr.restore_payload = {"params": {"params": jside["ivars" if kind == "interp"
                                                      else "fvars"]["params"]}}
    jlog, tlog = _Log(), _Log()
    jhist = jtr.fit(val_every=100, verbose=False, logger=jlog)
    ttr = Trainer(exp_t, tside["dm"], TrainerConfig(**kw))
    thist = ttr.fit(val_every=100, verbose=False, logger=tlog)
    assert len(jlog.step_losses()) == len(tlog.step_losses()) == len(thist["step_losses"]) == 4
    np.testing.assert_allclose(thist["step_losses"], jlog.step_losses(), rtol=1e-5)
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"], rtol=1e-5)
    assert ttr.state.step == int(jtr.state.step) == 4 and ttr.state.updates == 4
    lr_sum = sum(ttr.schedule(k) for k in range(4))
    _assert_trees(dict(exp_t.model.state_dict()), flax_to_state_dict(jtr.state.params), lr_sum)
    _assert_trees(ttr.state.ema.state_dict(), flax_to_state_dict(jtr.state.ema.params), lr_sum)


def test_fit_with_scan_layers_matches_jax(pin_t):
    """F7: with ``scan_layers`` (3 layers: JAX stacks block 1) JAX's mask
    decays the middle block's 1-D leaves too; at weight decay 0.5, a leaf
    the port left undecayed would move by about 4e-4, far outside
    ``_assert_trees``. The interpolator's fit as ``test_fit_matches_jax_fit``."""
    pin_t((1,))
    jside, tside = _build(n_timesteps=5, num_layers=3, scan_layers=True)
    assert "blocks_mid" in jside["ivars"]["params"]
    kw = dict(epochs=2, warmup_steps=1, log_every=1, weight_decay=0.5)
    jtr = JTrainer(jside["interp"], jside["dm"], JTrainerConfig(**kw))
    jtr.restore_payload = {"params": {"params": jside["ivars"]["params"]}}
    jhist = jtr.fit(val_every=100, verbose=False, logger=_Log())
    ttr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    thist = ttr.fit(val_every=100, verbose=False)
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"], rtol=1e-5)
    lr_sum = sum(ttr.schedule(k) for k in range(4))
    _assert_trees(dict(tside["interp"].model.state_dict()),
                  flax_to_state_dict(jtr.state.params), lr_sum)
    _assert_trees(ttr.state.ema.state_dict(), flax_to_state_dict(jtr.state.ema.params), lr_sum)


def test_validate_matches_jax(pin_t):
    """Validation on the EMA weights: the interpolator's RMSE over its
    horizon steps (one member, dropout off), within 1e-5 relative."""
    jside, tside = _build(n_timesteps=5)
    jtr = JTrainer(jside["interp"], jside["dm"], JTrainerConfig())
    jtr.restore_payload = {"params": {"params": jside["ivars"]["params"]}}
    jstate = jtr.init_state(next(iter(jside["dm"].train_batches())))
    ttr = Trainer(tside["interp"], tside["dm"], TrainerConfig())
    tstate = ttr.init_state()
    want = jtr.validate(jstate)
    got = ttr.validate(tstate)
    assert set(got) == set(want) == {"val/avg/rmse"}
    assert abs(got["val/avg/rmse"] - want["val/avg/rmse"]) <= 1e-5 * want["val/avg/rmse"]
    fc = Trainer(tside["forecast"], tside["dm"], TrainerConfig(num_predictions=2,
                                                               val_ensemble_chunk=1))
    val = fc.validate(fc.init_state())
    assert set(val) == {"val/avg/rmse", "val/avg/crps", "val/avg/ssr"}
    assert all(np.isfinite(v) for v in val.values())


def test_jax_mid_training_state_carries_across(pin_t):
    """Two JAX steps, the TrainState converted (params, EMA, Adam moments
    and counts), then one more step on each side from it: parameters and
    EMA as ``_assert_trees``."""
    pin_t((2,))
    jside, tside = _build(n_timesteps=5)
    cfg = dict(epochs=1, warmup_steps=1)
    jtr = JTrainer(jside["interp"], jside["dm"], JTrainerConfig(**cfg))
    jtr.restore_payload = {"params": {"params": jside["ivars"]["params"]}}
    batches = list(jside["dm"].train_batches())
    state = jtr.init_state(batches[0])
    step = jtr._make_train_step()
    for b in batches:
        state, _ = step(state, jnp.asarray(b["dynamics"]), jnp.asarray(b["dynamical_condition"]),
                        jax.random.PRNGKey(1), None)
    ttr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**cfg))
    ttr.restore_payload = train_state_payload(state)
    tstate = ttr.init_state()
    assert (tstate.step, tstate.updates, tstate.ema.count) == (2, 2, 2)
    b = batches[1]
    state, _ = step(state, jnp.asarray(b["dynamics"]), jnp.asarray(b["dynamical_condition"]),
                    jax.random.PRNGKey(1), None)
    ttr.train_step(tstate, torch.from_numpy(b["dynamics"]),
                   torch.from_numpy(b["dynamical_condition"]), torch.Generator())
    lr_sum = sum(ttr.schedule(k) for k in range(3))
    _assert_trees(dict(tside["interp"].model.state_dict()), flax_to_state_dict(state.params),
                  lr_sum)
    _assert_trees(tstate.ema.state_dict(), flax_to_state_dict(state.ema.params), lr_sum)


# ------------------------------------------------------------- checkpoints

def _port_interpolator(seed=0):
    dm = DebugDataModule(n_timesteps=6, **DM_KW)
    net = SFNO(SFNOConfig(**_model_kw("interpolator", dropout_mlp=0.1, drop_path_rate=0.1)))
    net.init_weights(torch.Generator().manual_seed(seed))
    return InterpolationExperiment(net, ExperimentConfig(horizon=HORIZON), dm.in_packer,
                                   dm.out_packer, dm.normalizer), dm


def test_checkpoint_resume_continues_the_uninterrupted_run(tmp_path):
    """Dropout on: fit 2 epochs, against fit 1 epoch, save, load into a
    new trainer and fit on: the same step losses, parameters, EMA and
    optimizer moments, bit for bit (the checkpoint holds the epochs done
    and the generator's state); the checkpoint holds the JAX entries."""
    kw = dict(epochs=2, warmup_steps=1, accumulate_grad_batches=2, code_snapshot=False)
    exp, dm = _port_interpolator()
    full = Trainer(exp, dm, TrainerConfig(**kw))
    hist = full.fit(val_every=100, verbose=False)
    exp2, dm2 = _port_interpolator()
    first = Trainer(exp2, dm2, TrainerConfig(**kw, ckpt_dir=str(tmp_path)))
    h1 = first.fit(epochs=1, val_every=100, verbose=False)
    payload = Trainer.load_checkpoint(str(tmp_path / "last.ckpt"))
    assert {"params", "ema_params", "opt_state", "step", "config_json"} <= set(payload)
    assert payload["epoch"] == 1 and payload["opt_state"]["mini_step"] == 1
    exp3, dm3 = _port_interpolator(seed=5)  # other weights: the checkpoint's replace them
    resumed = Trainer(exp3, dm3, TrainerConfig(**kw))
    resumed.restore_payload = payload
    h2 = resumed.fit(val_every=100, verbose=False)
    assert h1["step_losses"] + h2["step_losses"] == hist["step_losses"]
    for a, b in zip(exp3.model.parameters(), exp.model.parameters()):
        assert torch.equal(a, b)
    for k, v in full.state.ema.state_dict().items():
        assert torch.equal(resumed.state.ema.state_dict()[k], v)
    opt_a, opt_b = full._opt_state(full.state), resumed._opt_state(resumed.state)
    assert opt_a["updates"] == opt_b["updates"] == 3
    for k in ("exp_avg", "exp_avg_sq"):
        assert all(torch.equal(opt_a[k][n], opt_b[k][n]) for n in opt_a[k])


def test_reset_optimizer_starts_fresh_moments(tmp_path):
    exp, dm = _port_interpolator()
    tr = Trainer(exp, dm, TrainerConfig(epochs=1, warmup_steps=1, code_snapshot=False,
                                        ckpt_dir=str(tmp_path)))
    tr.fit(val_every=100, verbose=False)
    exp2, dm2 = _port_interpolator()
    tr2 = Trainer(exp2, dm2, TrainerConfig(epochs=1, reset_optimizer=True))
    tr2.restore_payload = Trainer.load_checkpoint(str(tmp_path / "last.ckpt"))
    state = tr2.init_state()
    assert state.updates == 0 and not state.optimizer.state and state.step == 3
    assert all(torch.equal(a, b) for a, b in zip(exp2.model.parameters(),
                                                 exp.model.parameters()))


def test_watch_model_reports_per_submodule_norms():
    exp, dm = _port_interpolator()
    tr = Trainer(exp, dm, TrainerConfig(watch_model=True))
    state = tr.init_state()
    b = next(iter(dm.train_batches()))
    m = tr.train_step(state, b["dynamics"], b["dynamical_condition"], torch.Generator())
    parts = {k: float(v) for k, v in m.items() if k.startswith("grad_norm/")}
    assert {"grad_norm/block_0", "grad_norm/pos_embed"} <= set(parts)
    total = float(np.sqrt(sum(v ** 2 for v in parts.values())))
    assert abs(total - float(m["grad_norm"])) <= 1e-5 * total

