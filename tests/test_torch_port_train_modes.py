"""Parity of the trainer's other modes with the JAX package, on the CPU.

``fit_in_memory`` (the fused epoch) and its streaming form, the ``fit``
dispatch on ``fit_mode``, bf16 Adam moments (``adam_mu_dtype``), bf16-compute
training steps, the rollout validation, gradient histograms and the code
snapshot. Debug size as ``tests/test_torch_port_train.py``: SFNOs at embed
16 x 2 layers on 16 x 32, horizon 3, 5 state channels and 2 forcings from
each package's ``DebugDataModule`` (the same numpy data), weights made by
the JAX initializers and carried into the port by ``utils/convert.py``.
Dropout is off and the timesteps are pinned in both packages (``pin_t``), so
both sides compute the same function. The JAX trainers run on a mesh of one
CPU device. JAX's fused loop returns epoch means only, so its per-step
losses are read from inside its scan (``jax.debug.callback``).

Tolerances: losses 1e-5 relative; parameters and EMA after Adam updates as
``_assert_trees`` (``tests/test_torch_port_train.py``: 1e-5 of each
tensor's largest entry, plus 2e-3 of the learning rates' sum for entries
whose gradient is near Adam's eps); bf16 stages as each test states.
"""

import io
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spherical_dyffusion_tpu.ops.contractions as jcontractions
import spherical_dyffusion_tpu.ops.sht as jsht
from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.parallel.mesh import make_mesh
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecast,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu.training.trainer import _histogram_wire, _wd_mask
from spherical_dyffusion_tpu.utils.code_snapshot import snapshot_code as jsnapshot_code
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.training.optim import AdamWLowMu
from spherical_dyffusion_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
    grad_histogram,
    histogram_wire,
)
from spherical_dyffusion_tpu_torch.utils.code_snapshot import snapshot_code
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

H, W, HORIZON, C, CF = 16, 32, 3, 5, 2
PKG = os.path.dirname(os.path.abspath(main_path.__file__))
BF16_ULP = 2.0 ** -7  # one bf16 step relative to the value (8 significant bits)


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


def _build(n_timesteps=5, batch_size=1, dm_kw=None, **model_kw):
    """(JAX side, port side), each {"dm", "interp", "forecast"} (and the
    JAX variables "ivars", "fvars"): the same weights and data."""
    kw = dict(channels=C, height=H, width=W, horizon=HORIZON, n_forcing=CF,
              batch_size=batch_size, n_timesteps=n_timesteps, **(dm_kw or {}))
    jdm, dm = JDebugDataModule(**kw), DebugDataModule(**kw)
    jim, ivars = _jax_model("interpolator", 0, **model_kw)
    jfm, fvars = _jax_model("forecaster", 1, **model_kw)
    dk = dict(timesteps=HORIZON, forward_conditioning="none", time_encoding="dynamics")
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


def _jtrainer(jside, kind, **cfg):
    """A JAX trainer on one CPU device, started from the side's weights."""
    tr = JTrainer(jside[kind], jside["dm"], JTrainerConfig(**cfg),
                  mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    tr.restore_payload = {"params": {"params": jside["ivars" if kind == "interp"
                                                     else "fvars"]["params"]}}
    return tr


@pytest.fixture
def pin_t(monkeypatch):
    """Pin both packages' timestep draws to ``t`` (one value per sample)."""

    def pin(t):
        t = list(t)
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, minval, maxval, *a, **k:
                            jnp.asarray((t * shape[0])[:shape[0]], jnp.int32))
        real = torch.randint

        def fake(low, high=None, size=None, *a, **k):
            if size is not None and high is not None and len(size) == 1:
                return torch.tensor((t * size[0])[:size[0]], dtype=torch.long)
            return real(low, high, size, *a, **k)

        monkeypatch.setattr(torch, "randint", fake)

    return pin


@pytest.fixture
def jax_step_losses(monkeypatch):
    """The per-step losses of JAX's fused loop, read from inside its scan."""
    seen = []
    real = JTrainer._make_train_step_body

    def body(self):
        step = real(self)

        def wrapped(state, *a):
            state, metrics = step(state, *a)
            jax.debug.callback(lambda v: seen.append(float(v)), metrics["loss"],
                               ordered=True)
            return state, metrics

        return wrapped

    monkeypatch.setattr(JTrainer, "_make_train_step_body", body)
    return seen


def _assert_trees(got: dict, want: dict, lr_sum: float):
    """As ``tests/test_torch_port_train.py``: 1e-5 of each tensor's largest
    entry (optax's float32 bias corrections) plus 2e-3 of ``lr_sum`` (an
    update where a gradient entry is near Adam's eps follows its float32
    rounding)."""
    for k, w in want.items():
        w = w.numpy()
        tol = 1e-5 * float(np.abs(w).max()) + 2e-3 * lr_sum
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= tol, f"{k}: {err:.3g} vs {tol:.3g}"


def _lr_sum(tr, n):
    return sum(tr.schedule(k) for k in range(n))


# ------------------------------------------------------------ fused epoch

@pytest.mark.parametrize("accumulate", [1, 2])
def test_fit_in_memory_matches_jax(pin_t, jax_step_losses, accumulate):
    """Two fused epochs of 3 steps (7 samples at batch 2: the 7th row never
    trains, drop-last), with and without ``accumulate_grad_batches=2``:
    per-step losses and epoch means 1e-5 relative, the step counts, the
    final parameters and EMA as ``_assert_trees``."""
    pin_t((1,))
    jside, tside = _build(n_timesteps=10, batch_size=2)
    kw = dict(epochs=2, warmup_steps=1, accumulate_grad_batches=accumulate)
    jtr = _jtrainer(jside, "interp", **kw)
    jhist = jtr.fit_in_memory(val_every=100, verbose=False)
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    hist = tr.fit_in_memory(val_every=100, verbose=False)
    assert len(hist["step_losses"]) == len(jax_step_losses) == int(jtr.state.step) == 6
    np.testing.assert_allclose(hist["step_losses"], jax_step_losses, rtol=1e-5)
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"], rtol=1e-5)
    assert tr.state.step == 6 and tr.state.updates == 6 // accumulate
    lr_sum = _lr_sum(tr, tr.state.updates)
    _assert_trees(dict(tside["interp"].model.state_dict()),
                  flax_to_state_dict(jtr.state.params), lr_sum)
    _assert_trees(tr.state.ema.state_dict(), flax_to_state_dict(jtr.state.ema.params), lr_sum)
    assert hist["upload"]["bytes"] == sum(
        v.nbytes for v in tside["dm"].dataset("train")[0].values()) * 7


def _port_interpolator(seed=0, n_timesteps=9, batch_size=2):
    dm = DebugDataModule(channels=C, height=H, width=W, horizon=HORIZON, n_forcing=CF,
                         batch_size=batch_size, n_timesteps=n_timesteps)
    net = SFNO(SFNOConfig(**_model_kw("interpolator", dropout_mlp=0.1, drop_path_rate=0.1)))
    net.init_weights(torch.Generator().manual_seed(seed))
    return InterpolationExperiment(net, ExperimentConfig(horizon=HORIZON), dm.in_packer,
                                   dm.out_packer, dm.normalizer), dm


def test_fit_in_memory_resume_continues_the_uninterrupted_run(tmp_path):
    """Dropout on: two fused epochs, against one, a checkpoint, and a new
    trainer resuming from it: the same step losses, parameters, EMA and
    moments, bit for bit (an epoch's draws depend on the epoch alone)."""
    kw = dict(epochs=2, warmup_steps=1, code_snapshot=False)
    exp, dm = _port_interpolator()
    full = Trainer(exp, dm, TrainerConfig(**kw))
    hist = full.fit_in_memory(val_every=100, verbose=False)
    exp2, dm2 = _port_interpolator()
    first = Trainer(exp2, dm2, TrainerConfig(**kw, ckpt_dir=str(tmp_path)))
    h1 = first.fit_in_memory(epochs=1, val_every=100, verbose=False)
    exp3, dm3 = _port_interpolator(seed=5)
    resumed = Trainer(exp3, dm3, TrainerConfig(**kw))
    resumed.restore_payload = Trainer.load_checkpoint(str(tmp_path / "last.ckpt"))
    h2 = resumed.fit_in_memory(val_every=100, verbose=False)
    assert h1["step_losses"] + h2["step_losses"] == hist["step_losses"]
    for a, b in zip(exp3.model.parameters(), exp.model.parameters()):
        assert torch.equal(a, b)
    for k, v in full.state.ema.state_dict().items():
        assert torch.equal(resumed.state.ema.state_dict()[k], v)


def test_fused_epoch_equals_fit_over_the_same_rows_and_generator():
    """``main_path.fused_epoch`` at debug size, dropout and DropPath live:
    its losses equal, bit for bit, ``fit``'s over the same rows (epoch 0's
    shuffle) with the fused epoch's generator, from the same weights. It
    builds the interpolator's trainer alone where none is given."""
    kw = dict(embed=16, layers=2, img_shape=(H, W), horizon=HORIZON, n_state=C, device="cpu")
    trs = main_path.build_training(n_samples=4, forecaster=False, **kw)
    assert list(trs) == ["interpolator"]
    b = trs["interpolator"]
    got = main_path.fused_epoch(n_steps=4, **kw)
    assert got["steps"] == 4 and len(got["step_ms"]) == 4 and got["upload_bytes"] > 0
    assert list(got["trainer"].exp.model.state_dict()) == list(b.exp.model.state_dict())
    b.generator = b.epoch_generator(0)
    want = b.fit(epochs=1, val_every=2, verbose=False)["step_losses"]
    assert got["losses"] == want


@pytest.mark.parametrize("segment_samples,seg,n_seg", [
    (1, 2, 4),    # below the batch: one batch a segment
    (3, 2, 4),    # not a multiple of the batch: rounded down
    (4, 4, 2),    # dividing the epoch exactly
    (6, 6, 1),    # the remainder (one batch) dropped
    (10, 8, 1),   # above the epoch: capped at spe * bs
])
def test_streaming_matches_jax(pin_t, jax_step_losses, segment_samples, seg, n_seg):
    """Streaming over 8 samples at batch 2 (4 steps an epoch), one epoch:
    the steps JAX's rounding gives (``seg // 2 * n_seg``), per-step losses
    and the epoch mean 1e-5 relative, and the parameters as
    ``_assert_trees``; the host waited once per segment."""
    pin_t((2,))
    jside, tside = _build(n_timesteps=11, batch_size=2)
    kw = dict(epochs=1, warmup_steps=1)
    jtr = _jtrainer(jside, "interp", **kw)
    jhist = jtr.fit_in_memory(val_every=100, verbose=False, segment_samples=segment_samples)
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    hist = tr.fit_in_memory(val_every=100, verbose=False, segment_samples=segment_samples)
    steps = seg // 2 * n_seg
    assert len(hist["step_losses"]) == len(jax_step_losses) == int(jtr.state.step) == steps
    assert len(hist["segment_wait_s"]) == 1 and len(hist["segment_wait_s"][0]) == n_seg
    np.testing.assert_allclose(hist["step_losses"], jax_step_losses, rtol=1e-5)
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"], rtol=1e-5)
    _assert_trees(dict(tside["interp"].model.state_dict()),
                  flax_to_state_dict(jtr.state.params), _lr_sum(tr, steps))


def test_streaming_segments_draw_from_their_own_generators():
    """Dropout on: a streamed epoch of 2 segments equals, bit for bit, the
    same rows run by hand with ``epoch_generator(0, segment)`` per
    segment."""
    kw = dict(epochs=1, warmup_steps=1)
    exp, dm = _port_interpolator(n_timesteps=11)
    tr = Trainer(exp, dm, TrainerConfig(**kw))
    got = tr.fit_in_memory(verbose=False, val_every=100, segment_samples=4)["step_losses"]
    exp2, dm2 = _port_interpolator(n_timesteps=11)
    ref = Trainer(exp2, dm2, TrainerConfig(**kw))
    state = ref.init_state()
    ds = dm2.dataset("train")
    perm = np.random.default_rng(0).permutation(len(ds))
    want = []
    for si in range(2):
        gen = ref.epoch_generator(0, si)
        for s in range(2):
            rows = perm[si * 4 + 2 * s: si * 4 + 2 * s + 2]
            b = {k: torch.from_numpy(np.stack([ds[int(i)][k] for i in rows]))
                 for k in ("dynamics", "dynamical_condition")}
            want.append(float(ref.train_step(state, b["dynamics"], b["dynamical_condition"],
                                             gen)["loss"]))
    assert got == want


@pytest.mark.parametrize("mode,segment_samples,error", [
    ("fit_in_memory", None, None), ("streaming", 4, None),
    ("streaming", None, "segment_samples"), ("nonsense", None, "Unknown fit_mode")])
def test_fit_dispatches_on_fit_mode(mode, segment_samples, error):
    """``fit`` goes to ``fit_in_memory`` for the fused and streaming modes
    (streaming with ``segment_samples``), and raises JAX's errors for
    streaming without a segment size and for an unknown mode."""
    exp, dm = _port_interpolator()
    tr = Trainer(exp, dm, TrainerConfig(epochs=1, fit_mode=mode,
                                        segment_samples=segment_samples))
    calls = []
    real = tr.fit_in_memory
    tr.fit_in_memory = lambda **k: calls.append(k) or real(**k)
    if error:
        with pytest.raises(ValueError, match=error):
            tr.fit(verbose=False)
        assert not calls
        return
    hist = tr.fit(verbose=False, val_every=100)
    assert [c["segment_samples"] for c in calls] == [segment_samples]
    # 6 samples at batch 2: 3 fused steps; one segment of 4 samples, 2 steps
    assert len(hist["step_losses"]) == (3 if segment_samples is None else 2)


# ------------------------------------------------------- bf16 Adam moments

def _optax_chain(lr, mu_dtype):
    return optax.chain(optax.clip_by_global_norm(0.5),
                       optax.adamw(lr, weight_decay=5e-3, mask=_wd_mask, mu_dtype=mu_dtype))


def test_bf16_mu_optimizer_matches_optax():
    """Five steps of ``AdamWLowMu`` (bf16 ``exp_avg``) against
    ``optax.adamw(mu_dtype=bfloat16)`` on the same gradients (made by numpy,
    of varied scales), clipped as the trainer clips: the stored moment
    within one bf16 step of optax's (the float32 ``mu`` before the rounding
    differs by optax's float32 arithmetic only), ``nu`` 5e-6 relative (the
    two clips), the parameters within 1e-6 of their scale plus five steps'
    learning rate times one bf16 step of the update."""
    r = np.random.default_rng(3)
    shapes = {"w": (6, 5), "b": (5,), "k": (3, 4, 2)}
    p0 = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.standard_normal(s) * 10.0 ** r.integers(-3, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lr = 1e-2
    tx = _optax_chain(lr, jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    decay = [params[k] for k in shapes if len(shapes[k]) >= 2]
    tx_t = AdamWLowMu([{"params": decay, "weight_decay": 5e-3},
                       {"params": [params["b"]], "weight_decay": 0.0}], lr=lr)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        torch.nn.utils.clip_grad_norm_(list(params.values()), 0.5)
        tx_t.step()
    adam = opt[1][0]
    for k, p in params.items():
        st = tx_t.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        mu_j = np.asarray(adam.mu[k].astype(jnp.float32))
        mu_t = st["exp_avg"].float().numpy()
        assert np.all(np.abs(mu_t - mu_j) <= BF16_ULP * np.abs(mu_j) + 1e-30), k
        # the trainer's clip (torch's clip_grad_norm_: max_norm / (norm + 1e-6))
        # scales by about 1e-6 / norm less than optax's (max_norm / norm)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]),
                                   rtol=5e-6, atol=1e-30)
        want = np.asarray(jp[k])
        tol = 1e-6 * np.abs(want).max() + 5 * lr * BF16_ULP
        assert np.abs(p.detach().numpy() - want).max() <= tol, k


def test_fit_with_bf16_mu_matches_jax(pin_t, tmp_path):
    """``adam_mu_dtype="bfloat16"``: 3 steps of ``fit``, every stored
    ``exp_avg`` bf16 and within one bf16 step of JAX's ``mu`` (plus 1e-3 of
    its largest entry, or of 1e-4 of the network's where a bias before an
    instance norm leaves only rounding in its gradient); the
    parameters as ``_assert_trees`` plus the learning rates' sum times one
    bf16 step (where the two ``mu`` round a tie apart, the update moves by
    one bf16 step of ``mu``); the checkpoint holds the bf16 moment and a new
    trainer resumes it unchanged."""
    pin_t((1,))
    jside, tside = _build(n_timesteps=6)
    kw = dict(epochs=1, warmup_steps=1, adam_mu_dtype="bfloat16", lr=1e-3)
    jtr = _jtrainer(jside, "interp", **kw)
    jtr.fit(val_every=100, verbose=False)
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw, code_snapshot=False,
                                                             ckpt_dir=str(tmp_path)))
    tr.fit(val_every=100, verbose=False)
    assert tr.state.step == int(jtr.state.step) == 3
    _assert_trees(dict(tside["interp"].model.state_dict()),
                  flax_to_state_dict(jtr.state.params), _lr_sum(tr, 3) * (1 + BF16_ULP / 2e-3))
    mu_j = flax_to_state_dict({"params": jtr.state.opt_state[1][0].mu})
    named = dict(tside["interp"].model.named_parameters())
    top = max(float(v.abs().max()) for v in mu_j.values())
    for n, p in named.items():
        got = tr.state.optimizer.state[p]["exp_avg"]
        assert got.dtype == torch.bfloat16
        w = mu_j[n].numpy()
        assert np.all(np.abs(got.float().numpy() - w) <= BF16_ULP * np.abs(w)
                      + 1e-3 * max(np.abs(w).max(), 1e-4 * top)), n
    payload = Trainer.load_checkpoint(str(tmp_path / "last.ckpt"))
    assert all(v.dtype == torch.bfloat16 for v in payload["opt_state"]["exp_avg"].values())
    tr2 = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    tr2.restore_payload = payload
    st2 = tr2.init_state()
    for n, p in named.items():
        assert torch.equal(st2.optimizer.state[p]["exp_avg"],
                           tr.state.optimizer.state[p]["exp_avg"])


def test_resume_from_jax_msgpack_with_bf16_mu(pin_t, tmp_path):
    """A JAX msgpack checkpoint whose ``opt_state`` holds a bf16 ``mu``
    (``Trainer.load_checkpoint`` reads it through ``utils/flax_msgpack.py``):
    the port stores that ``mu`` bit for bit in bf16, the ``nu``, the counts
    and the weights as JAX's; one more step on each side as
    ``_assert_trees``."""
    pin_t((2,))
    jside, tside = _build(n_timesteps=5)
    kw = dict(epochs=1, warmup_steps=1, adam_mu_dtype="bfloat16")
    jtr = _jtrainer(jside, "interp", **kw)
    batches = list(jside["dm"].train_batches())
    state = jtr.init_state(batches[0])
    step = jtr._make_train_step()
    for b in batches:
        state, _ = step(state, jnp.asarray(b["dynamics"]), jnp.asarray(b["dynamical_condition"]),
                        jax.random.PRNGKey(1), None)
    path = str(tmp_path / "jax.ckpt")
    jtr.save_checkpoint(state, path, extra_config={"experiment": "interpolation"})
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    tr.restore_payload = Trainer.load_checkpoint(path)
    tstate = tr.init_state()
    assert (tstate.step, tstate.updates) == (2, 2)
    mu = flax_to_state_dict({"params": state.opt_state[1][0].mu})
    for n, p in tside["interp"].model.named_parameters():
        got = tstate.optimizer.state[p]["exp_avg"]
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(), mu[n]), n
    b = batches[1]
    state, _ = step(state, jnp.asarray(b["dynamics"]), jnp.asarray(b["dynamical_condition"]),
                    jax.random.PRNGKey(1), None)
    tr.train_step(tstate, torch.from_numpy(b["dynamics"]),
                  torch.from_numpy(b["dynamical_condition"]), torch.Generator())
    _assert_trees(dict(tside["interp"].model.state_dict()), flax_to_state_dict(state.params),
                  _lr_sum(tr, 3))


# -------------------------------------------------------- bf16 compute

class _Float32Dots:
    """``jax.numpy`` whose einsums asked for a float32 result take bf16
    operands as float32 values (exact products), as
    ``tests/test_torch_port_options.py`` patches the JAX modules: this
    XLA-CPU build refuses some bf16 x bf16 -> float32 dot shapes."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(eq, *ops, preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def jax_bf16(monkeypatch):
    """``tests/test_torch_port_options.py``'s fixture: the JAX package's bf16
    matmul dtype on the CPU as on the TPU (bf16 operands, float32 sums)."""
    for mod in (jsht, jcontractions):
        monkeypatch.setattr(mod, "_effective_matmul_dtype", lambda requested: requested)
        monkeypatch.setattr(mod, "jnp", _Float32Dots())


# a bf16-compute step: each bf16 rounding point is the same in both
# packages, but a float32 sum that lands on the other side of a bf16
# boundary moves that value by one bf16 step (2^-8 of it), and the SFNO
# carries such flips through its layers, forward and backward. The L1 loss
# averages them out (measured 3.5e-7 and 1.4e-7 relative); the gradients
# agree to 4.1e-3 of the network's largest entry (measured), and a float32
# step of the same weights is as close to JAX's bf16 gradients (4.2e-3), so
# at this size the gradients do not single out the rounding points (the
# forward does: tests/test_torch_port_options.py); the port's bf16 step
# differs from its own float32 step by more than F32_VS_BF16, so the bf16
# path is the one compared
BF16_LOSS_REL = 1e-5
BF16_GRAD_REL = 1e-2
F32_VS_BF16 = 1e-4


def _jax_loss_and_grads(jside, kind, dyn, cond):
    jexp, variables = jside[kind], jside["ivars" if kind == "interp" else "fvars"]
    extra = {} if kind == "interp" else {"aux_params": jside["ivars"]}
    consts = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return jexp.train_loss({**consts, "params": p}, jnp.asarray(dyn), jax.random.PRNGKey(0),
                               dynamical_condition=jnp.asarray(cond), **extra)[0]

    jl, jg = jax.value_and_grad(loss_fn)(variables["params"])
    return float(jl), {k: v.numpy() for k, v in flax_to_state_dict({"params": jg}).items()}


def _port_loss_and_grads(texp, dyn, cond):
    loss, _ = texp.train_loss(torch.from_numpy(dyn), torch.Generator().manual_seed(0),
                              dynamical_condition=torch.from_numpy(cond))
    names = [n for n, _ in texp.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(texp.model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("kind", ["interp", "forecast"])
def test_bf16_compute_train_step_matches_jax(pin_t, jax_bf16, kind):
    """``compute_dtype`` and ``sht_matmul_dtype`` bfloat16 with K1 asked for
    (``use_pallas``: JAX's Pallas dhconv in interpret mode takes complex64,
    the port's K1 float32), one step's loss and gradients against JAX's
    ``value_and_grad`` of the same step: the loss within
    ``BF16_LOSS_REL``, every gradient float32 and within ``BF16_GRAD_REL``
    of the network's largest gradient entry; the port's float32 step of the
    same weights moves some gradient by more than ``F32_VS_BF16`` of it."""
    pin_t((1, 2))
    bf = dict(compute_dtype="bfloat16", sht_matmul_dtype="bfloat16", use_pallas=True)
    jside, tside = _build(n_timesteps=6, batch_size=2, **bf)
    jdm = jside["dm"]
    b = next(iter(jdm.train_batches(seed=0)))
    dyn = np.array(jdm.normalizer.normalize(jnp.asarray(b["dynamics"])))
    cond = np.array(b["dynamical_condition"])
    jl, jg = _jax_loss_and_grads(jside, kind, dyn, cond)
    tl, tg = _port_loss_and_grads(tside[kind], dyn, cond)
    assert abs(tl - jl) <= BF16_LOSS_REL * abs(jl)
    top = max(float(np.abs(v).max()) for v in jg.values())
    assert set(tg) == set(jg)
    for n, g in tg.items():
        assert g.dtype == torch.float32
        err = float(np.abs(g.numpy() - jg[n]).max())
        assert err <= BF16_GRAD_REL * top, f"{n}: {err:.3g} vs {BF16_GRAD_REL} x {top:.3g}"
    _, g32 = _port_loss_and_grads(_build(n_timesteps=6, batch_size=2, use_pallas=True)[1][kind],
                                  dyn, cond)
    assert max(float((g32[n] - g).abs().max()) for n, g in tg.items()) > F32_VS_BF16 * top


def test_bf16_product_backward_is_the_cpu_forms_autograd(monkeypatch):
    """``ops/matmul.py:Product16`` (the card's bf16 product; PyTorch gives
    ``bmm`` with ``out_dtype`` no derivative): its forward taken as the
    product of the bf16 values in float32 (``torch.bmm`` patched, since the
    CPU has no ``out_dtype``), its gradients equal, bit for bit, autograd of
    the CPU form ``torch.bmm(a.float(), b.float())`` on bf16 operands."""
    from spherical_dyffusion_tpu_torch.ops.matmul import Product16

    real = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: real(
        a.float(), b.float()) if out_dtype is not None else real(a, b))
    r = np.random.default_rng(5)
    a0 = torch.from_numpy(r.standard_normal((3, 7, 5)).astype(np.float32))
    b0 = torch.from_numpy(r.standard_normal((3, 5, 4)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((3, 7, 4)).astype(np.float32))
    grads = []
    for form in (lambda a, b: Product16.apply(a, b), lambda a, b: real(a.float(), b.float())):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = form(a.to(torch.bfloat16), b.to(torch.bfloat16))
        assert y.dtype == torch.float32
        grads.append(torch.autograd.grad(y, (a, b), g))
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def test_build_training_takes_a_compute_dtype():
    """``main_path.build_training(dtype=...)`` sets both networks' compute
    and transform dtypes; a bf16 step at debug size runs on the CPU, its
    gradients float32 and finite."""
    trs = main_path.build_training(embed=16, layers=2, img_shape=(H, W), horizon=HORIZON,
                                   n_state=C, n_samples=2, dtype="bfloat16", device="cpu")
    rec = main_path.train_steps(n_steps=2, trainers=trs)
    for name, tr in trs.items():
        cfg = tr.exp.model.cfg
        assert cfg.compute_dtype == cfg.sht_matmul_dtype == "bfloat16"
        assert all(np.isfinite(rec[name]["losses"]))
        assert all(torch.isfinite(p).all() for p in tr.exp.model.parameters())
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            main_path.build_training(embed=16, layers=2, img_shape=(H, W), dtype="bfloat16")


# ----------------------------------------------------- rollout validation

def _forecast_trainers(jside, tside, **kw):
    cfg = dict(epochs=1, warmup_steps=1, **kw)
    return (_jtrainer(jside, "forecast", **cfg),
            Trainer(tside["forecast"], tside["dm"], TrainerConfig(**cfg)))


def test_rollout_validate_matches_jax(pin_t):
    """After one step (so that the EMA differs from the weights), a 6-step
    rollout of the validation source on the EMA weights: the same keys,
    every value within 1e-4 relative (of its own size, or of 1e-6 where it
    is near zero)."""
    pin_t((1,))
    jside, tside = _build(n_timesteps=12)
    jtr, tr = _forecast_trainers(jside, tside, rollout_val_steps=6, ema_decay=0.5)
    batches = list(jside["dm"].train_batches())
    jstate = jtr.init_state(batches[0])
    jstate, _ = jtr._make_train_step()(
        jstate, jnp.asarray(batches[0]["dynamics"]),
        jnp.asarray(batches[0]["dynamical_condition"]), jax.random.PRNGKey(1), jside["ivars"])
    tstate = tr.init_state()
    tr.train_step(tstate, torch.from_numpy(batches[0]["dynamics"]),
                  torch.from_numpy(batches[0]["dynamical_condition"]), torch.Generator())
    want = jtr.rollout_validate(jstate)
    got = tr.rollout_validate(tstate)
    assert want and set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= 1e-4 * max(abs(w), 1e-2), (k, got[k], w)


def test_rollout_validate_is_empty_for_the_interpolator():
    jside, tside = _build(n_timesteps=6)
    jtr = _jtrainer(jside, "interp")
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig())
    assert jtr.rollout_validate(None) == {} == tr.rollout_validate(tr.init_state())


def test_fit_calls_rollout_validate_at_its_epochs():
    """``rollout_val_every=2`` over 3 epochs: one rollout, after the second
    epoch, in the history and the logs."""
    jside, tside = _build(n_timesteps=6)
    tr = Trainer(tside["forecast"], tside["dm"], TrainerConfig(
        epochs=3, warmup_steps=1, rollout_val_every=2, rollout_val_steps=3))
    epochs = []
    real = tr.rollout_validate
    tr.rollout_validate = lambda st: epochs.append(tr.epochs_done) or real(st)

    class Log:
        rows = []

        def log(self, row, step=None):
            self.rows.append(dict(row))

    log = Log()
    hist = tr.fit(verbose=False, val_every=100, logger=log)
    assert epochs == [1] and len(hist["rollout_val"]) == 1
    assert any(set(hist["rollout_val"][0]) <= set(r) for r in log.rows)


def test_step_after_rollout_validate_equals_the_step_without():
    """Dropout on, EMA weights: two trainers from the same weights take a
    step, one runs a rollout validation, both take another step: the
    losses, weights, EMA and generators are equal bit for bit."""
    jside, tside = _build(n_timesteps=9, drop_path_rate=0.1, dropout_mlp=0.1)
    jside2, tside2 = _build(n_timesteps=9, drop_path_rate=0.1, dropout_mlp=0.1)
    trs = [Trainer(t["forecast"], t["dm"], TrainerConfig(warmup_steps=1, rollout_val_steps=3,
                                                         ema_decay=0.5))
           for t in (tside, tside2)]
    states = [t.init_state() for t in trs]
    batches = list(tside["dm"].train_batches())[:2]
    losses = [[], []]
    for i, b in enumerate(batches):
        for j, (t, st) in enumerate(zip(trs, states)):
            if i == 1 and j == 0:
                assert t.rollout_validate(st)
            losses[j].append(float(t.train_step(st, b["dynamics"], b["dynamical_condition"],
                                                t.generator)["loss"]))
    assert losses[0] == losses[1]
    assert torch.equal(trs[0].generator.get_state(), trs[1].generator.get_state())
    for a, b in zip(tside["forecast"].model.parameters(), tside2["forecast"].model.parameters()):
        assert torch.equal(a, b)
    ea, eb = states[0].ema.state_dict(), states[1].ema.state_dict()
    assert all(torch.equal(ea[k], eb[k]) for k in ea)


# -------------------------------------------------------- histograms

@pytest.mark.parametrize("case", ["normal", "scales", "constant", "integers"])
def test_grad_histogram_matches_jnp_histogram(case):
    """``grad_histogram`` of a list of tensors against ``jnp.histogram`` of
    their concatenated values with 64 bins: counts equal exactly, edges
    within one float32 ulp of the range (``jnp.linspace``'s arithmetic);
    the constant case takes the range (v - 0.5, v + 0.5); values on an edge
    (the integers) fall as JAX puts them, the maximum in the last bin."""
    r = np.random.default_rng(7)
    if case == "normal":
        xs = [r.standard_normal(s) for s in ((40, 30), (1500,), (3, 7, 11))]
    elif case == "scales":
        xs = [r.standard_normal(2100) * 1e-4, r.standard_normal(17) * 3.0, np.zeros(5)]
    elif case == "constant":
        xs = [np.full((30, 4), 0.25), np.full(9, 0.25)]
    else:
        xs = [r.integers(-32, 33, size=1000).astype(np.float64), np.asarray([64.0, -64.0])]
    xs = [x.astype(np.float32) for x in xs]
    counts, edges = grad_histogram([torch.from_numpy(x) for x in xs])
    want_c, want_e = jnp.histogram(jnp.concatenate([jnp.ravel(jnp.asarray(x)) for x in xs]),
                                   bins=64)
    assert counts.dtype == torch.float64 and counts.shape == (64,) and edges.shape == (65,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c, np.float64))
    rng = float(want_e[-1] - want_e[0])
    assert np.abs(edges.numpy() - np.asarray(want_e)).max() <= np.spacing(np.float32(rng))
    assert counts.sum() == sum(x.size for x in xs)
    assert histogram_wire(counts.numpy(), np.asarray(want_e)) == _histogram_wire((want_c, want_e))


def test_grad_histogram_spreads_large_tensors_over_rows():
    """A tensor larger than the partial-count rows, with a remainder: the
    same counts as ``jnp.histogram``."""
    x = np.random.default_rng(2).standard_normal(1024 * 5 + 37).astype(np.float32)
    counts, _ = grad_histogram([torch.from_numpy(x)])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jnp.histogram(x, bins=64)[0]))


def test_grad_histogram_counts_past_2_24_where_jax_saturates():
    """A bin holding more than 2^24 values: JAX's float32 counts stop at
    16,777,216 (ROADMAP Queue 3, a fault of the reference), the port's
    float64 counts hold every value, and the other bins agree."""
    n = 2 ** 24 + 1000
    x = np.concatenate([np.zeros(n, np.float32), np.ones(10, np.float32)])
    want, _ = jnp.histogram(jnp.asarray(x), bins=64)
    got, _ = grad_histogram([torch.from_numpy(x)])
    assert float(want[0]) == 2.0 ** 24 and float(got[0]) == n
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want, np.float64)[1:])


@pytest.mark.parametrize("scan", [False, True])
def test_fit_logs_gradient_histograms_as_jax(pin_t, scan):
    """``watch_histograms`` and ``watch_model`` with ``log_every=1``, 2 steps
    of ``fit``: the logged keys equal JAX's (``train/grad_hist/<subtree>``
    and ``train/grad_norm/<subtree>``, ``blocks_mid`` under
    ``scan_layers``), the norms within 1e-4 of the largest; each histogram
    a wandb histogram whose counts sum to the
    subtree's parameter count, its edges within 1e-4 of JAX's range; at
    the first step, from the same weights, the counts differ from JAX's by
    at most 1% of the values (a value within a float32 rounding of an edge
    may fall on the other side)."""
    pin_t((1,))
    model_kw = dict(num_layers=3, scan_layers=True) if scan else {}
    jside, tside = _build(n_timesteps=5, **model_kw)
    kw = dict(epochs=1, warmup_steps=1, log_every=1, watch_histograms=True, watch_model=True)

    class Log:
        def __init__(self):
            self.rows = []

        def log(self, row, step=None):
            self.rows.append((step, dict(row)))

    jlog, tlog = Log(), Log()
    _jtrainer(jside, "interp", **kw).fit(val_every=100, verbose=False, logger=jlog)
    tr = Trainer(tside["interp"], tside["dm"], TrainerConfig(**kw))
    tr.fit(val_every=100, verbose=False, logger=tlog)

    def hists(log):
        return [(s, {k: v for k, v in r.items() if k.startswith("train/grad_hist/")})
                for s, r in log.rows if any(k.startswith("train/grad_hist/") for k in r)]

    jh, th = hists(jlog), hists(tlog)
    assert [s for s, _ in jh] == [s for s, _ in th] == [0, 1]
    params = jside["ivars"]["params"]
    assert set(th[0][1]) == set(jh[0][1]) == {f"train/grad_hist/{k}" for k in params}
    for (_, trow), (_, jrow) in zip(th, jh):
        for k, t in trow.items():
            j = jrow[k]
            assert t["_type"] == "histogram" and len(t["values"]) == 64 and len(t["bins"]) == 65
            n = sum(int(np.prod(np.shape(x)))
                    for x in jax.tree_util.tree_leaves(params[k.split("/")[-1]]))
            assert sum(t["values"]) == sum(j["values"]) == n
            span = j["bins"][-1] - j["bins"][0]
            assert np.abs(np.subtract(t["bins"], j["bins"])).max() <= 1e-4 * span, k
    for k, t in th[0][1].items():
        assert np.abs(np.subtract(t["values"], jh[0][1][k]["values"])).sum() <= 0.02 * sum(
            t["values"]), k
    # the per-subtree norms of watch_model group as JAX's tree does (F9)
    jn = {k: v for k, v in jlog.rows[0][1].items() if k.startswith("train/grad_norm/")}
    tn = {k: v for k, v in tlog.rows[0][1].items() if k.startswith("train/grad_norm/")}
    assert set(tn) == set(jn) == {f"train/grad_norm/{k}" for k in params}
    for k, v in jn.items():
        assert abs(tn[k] - v) <= 1e-4 * max(jn.values()), k


# ------------------------------------------------------- code snapshot

def _tree(root):
    files = {"pkg/a.py": "x = 1\n", "pkg/sub/b.yaml": "k: v\n", "pkg/sub/c.md": "# c\n",
             "pkg/native/d.cpp": "int d;\n", "pkg/native/e.h": "#pragma once\n",
             "pkg/skip.txt": "no\n", "pkg/__pycache__/f.py": "no\n", "pkg/.hidden/g.py": "no\n",
             "pkg/results/h.py": "no\n"}
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(root / "pkg")


def test_code_snapshot_matches_jax_on_shared_extensions(tmp_path):
    """On a tree of the extensions both packages take (and files and
    directories both leave out), the port's archive equals JAX's byte for
    byte."""
    root = _tree(tmp_path / "src")
    a = snapshot_code(str(tmp_path / "port.tar.gz"), roots=[root])
    b = jsnapshot_code(str(tmp_path / "jax.tar.gz"), roots=[root])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_code_snapshot_of_the_port_is_stable_and_holds_its_kernels(tmp_path):
    """The default snapshot (the port's package): two calls give the same
    bytes; it holds every ``csrc/*.cu`` and ``*.cuh`` and the JSON
    configs, with mtime 0 and uid/gid 0."""
    a = snapshot_code(str(tmp_path / "a.tar.gz"))
    b = snapshot_code(str(tmp_path / "b.tar.gz"))
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        members = tar.getmembers()
    names = {m.name for m in members}
    csrc = os.path.join(PKG, "csrc")
    for fn in os.listdir(csrc):
        assert f"spherical_dyffusion_tpu_torch/csrc/{fn}" in names
    assert "spherical_dyffusion_tpu_torch/configs/trainer/default.json" in names
    assert all(m.mtime == 0 and m.uid == m.gid == 0 for m in members)
    assert not any("/build/" in n or "__pycache__" in n for n in names)


def test_fit_writes_one_code_snapshot_beside_the_checkpoints(tmp_path):
    """``code_snapshot`` (the default) with a ``ckpt_dir``: a fit of two
    epochs writes ``code.tar.gz`` once, beside ``last.ckpt``; a second
    trainer's fit into the same directory leaves the same bytes."""
    exp, dm = _port_interpolator()
    tr = Trainer(exp, dm, TrainerConfig(epochs=2, steps_per_epoch=1, ckpt_dir=str(tmp_path)))
    writes = []
    import spherical_dyffusion_tpu_torch.training.trainer as tmod

    real = tmod.snapshot_code
    tmod.snapshot_code = lambda *a, **k: writes.append(a) or real(*a, **k)
    try:
        tr.fit(verbose=False, val_every=100)
        first = (tmp_path / "code.tar.gz").read_bytes()
        exp2, dm2 = _port_interpolator()
        Trainer(exp2, dm2, TrainerConfig(epochs=1, ckpt_dir=str(tmp_path))).fit(
            verbose=False, val_every=100)
    finally:
        tmod.snapshot_code = real
    assert len(writes) == 2 and (tmp_path / "last.ckpt").exists()
    assert (tmp_path / "code.tar.gz").read_bytes() == first


def test_trainer_config_names_the_item_of_each_refusal():
    # ckpt_mirror and save_to_wandb are ported (item 8e): accepted
    TrainerConfig(ckpt_mirror="s3://b/p", save_to_wandb=True)
    with pytest.raises(NotImplementedError, match="adam_mu_dtype"):
        TrainerConfig(adam_mu_dtype="float16")
    # optax's float32 mu is torch.optim.AdamW's own state: only bf16 takes AdamWLowMu
    for mu, kind in [(None, torch.optim.AdamW), ("float32", torch.optim.AdamW),
                     ("bfloat16", AdamWLowMu)]:
        exp, dm = _port_interpolator()
        opt = Trainer(exp, dm, TrainerConfig(adam_mu_dtype=mu)).init_state().optimizer
        assert type(opt) is kind
