"""Parity of the port's training pieces below the trainer, on the CPU.

K1's backward (``DhconvFunction``: dx as K1 over the conjugate-transposed
image, dW as a float32 product), the losses, schedules, EMA and the
optimizer step, against the JAX package (``dhconv_pallas`` in interpret
mode, ``training/losses.py``, the optax schedules and chain,
``ema_update``), with inputs made by numpy from a seed; the fused kernels'
refusal of autograd (F6); ``TrainerConfig``'s refusals; the windowed dataset
and datamodule copies. Tolerances are float32 summation-order error unless a
test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.data.datasets import WindowedDataset as JWindowedDataset
from spherical_dyffusion_tpu.ops.pallas_contractions import dhconv_pallas
from spherical_dyffusion_tpu.training import losses as jlosses
from spherical_dyffusion_tpu.training import schedules as jsched
from spherical_dyffusion_tpu.training.ema import ema_init, ema_update
from spherical_dyffusion_tpu.training.trainer import _wd_mask
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.data.datasets import WindowedDataset
from spherical_dyffusion_tpu_torch.models.modules import MLP2d
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.ops.fused_mlp import fused_block_tail, fused_mlp
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
    IMAGE_CI,
    IMAGE_CO,
    DhconvFunction,
    conj_transpose,
    dhconv,
    dhconv_weight_grad,
    dhconv_weight_image,
    split_tf32,
)
from spherical_dyffusion_tpu_torch.training import losses as tlosses
from spherical_dyffusion_tpu_torch.training import schedules as tsched
from spherical_dyffusion_tpu_torch.training.ema import EMA
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ K1 backward

@pytest.mark.parametrize("lead,L,M,CI,CO", [((2,), 3, 7, 20, 12), ((1, 2), 2, 5, 16, 8),
                                             ((3,), 4, 9, 6, 33)])
def test_dhconv_backward_matches_jax_vjp_of_pallas(lead, L, M, CI, CO):
    """The Function's dx and dW (the plain products on the CPU) against
    ``jax.vjp`` of ``dhconv_pallas`` in interpret mode, within 1e-5 of the
    largest entry; the output carries a grad_fn."""
    r = np.random.default_rng(0)
    x = r.standard_normal(lead + (L, M, CI, 2)).astype(np.float32)
    w = (r.standard_normal((CI, CO, L, 2)) / CI).astype(np.float32)
    g = r.standard_normal(lead + (L, M, CO, 2)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = dhconv(xt, wt)
    assert "DhconvFunction" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))

    xc = jnp.asarray(x[..., 0] + 1j * x[..., 1], jnp.complex64)
    _, vjp = jax.vjp(lambda a, b: dhconv_pallas(a, b, interpret=True), xc, jnp.asarray(w))
    # JAX's cotangents of complex values are the conjugates of the real-pair
    # gradients: (gr, gi) enters as gr - i gi, and dx = dxr - i dxi returns
    jdx, jdw = vjp(jnp.asarray(g[..., 0] - 1j * g[..., 1], jnp.complex64))
    jdx = np.stack([np.asarray(jdx).real, -np.asarray(jdx).imag], -1)
    assert _rel(dx.numpy(), jdx) <= 1e-5
    assert _rel(dw.numpy(), np.asarray(jdw)) <= 1e-5


def test_dhconv_function_gradcheck_float64(monkeypatch):
    """The backward formulas (dx = g conj(W)^T, dW = sum conj(x)^T g) are
    the exact derivatives of the forward: gradcheck in float64, with the
    plain products (float32 in the port) computed in float64 here."""
    from spherical_dyffusion_tpu_torch.ops import pallas_contractions as pc

    def plain64(x, w):
        def mm(a, b):
            return torch.einsum("...lmi,iol->...lmo", a, b)

        xr, xi, wr, wi = x[..., 0], x[..., 1], w[..., 0], w[..., 1]
        return torch.stack([mm(xr, wr) - mm(xi, wi), mm(xr, wi) + mm(xi, wr)], -1)

    monkeypatch.setattr(pc, "dhconv_plain", plain64)
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((2, 3, 4, 5, 2))).requires_grad_()
    w = torch.from_numpy(r.standard_normal((5, 6, 3, 2))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: DhconvFunction.apply(a, b, None, None), (x, w))


def test_dhconv_backward_saves_nothing_without_grad():
    """Under no_grad (the frozen interpolator) the call records nothing."""
    x = torch.randn(1, 3, 4, 5, 2, requires_grad=True)
    w = torch.randn(5, 6, 3, 2, requires_grad=True)
    with torch.no_grad():
        y = dhconv(x, w)
    assert y.grad_fn is None and not y.requires_grad


def _k1_as_the_kernel(x, image, CI, CO, L):
    """y from an image as the kernel computes it (see
    tests/test_torch_port_tensor_cores.py): the swizzle undone, per l the
    real GEMM over K = 2 CI of (xr, -xi) and (xi, xr) with the (wr, wi)
    columns, hi.hi + hi.lo + lo.hi in float64."""
    nct, nch = image.shape[1], image.shape[2]
    n = torch.arange(IMAGE_CO)[:, None]
    chunk = torch.arange(8)[None, :] ^ (n % 8)
    idx = (chunk[:, :, None] * 4 + torch.arange(4)).reshape(IMAGE_CO, -1)
    t = torch.gather(image, -1, idx.expand(image.shape))
    t = t.reshape(L, nct, nch, 2, IMAGE_CO, IMAGE_CI, 2).permute(3, 0, 1, 4, 2, 5, 6)
    t = t.reshape(2, L, nct * IMAGE_CO, nch * IMAGE_CI, 2)[:, :, :CO, :CI]
    bh, bl = t[0].flatten(-2).double(), t[1].flatten(-2).double()
    xr, xi = x[..., 0], x[..., 1]
    outs = []
    for a in (torch.stack([xr, -xi], -1), torch.stack([xi, xr], -1)):
        ah, al = (v.flatten(-2).double() for v in split_tf32(a))
        mm = lambda p, q: torch.einsum("...lmk,lok->...lmo", p, q)  # noqa: E731
        outs.append(mm(ah, bh) + mm(ah, bl) + mm(al, bh))
    return torch.stack(outs, -1)


@pytest.mark.parametrize("L,M,CI,CO", [(3, 7, 20, 136), (2, 5, 40, 16)])
def test_conj_transposed_image_contracts_like_autograd_dx(L, M, CI, CO):
    """The backward's image (conj(w)^T), contracted as the kernel reads it,
    equals dx from autograd of contract_dhconv within 1e-6 of its largest
    entry."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, L, M, CI, 2)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((CI, CO, L, 2)) / CI).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((2, L, M, CO, 2)).astype(np.float32))
    image = dhconv_weight_image(w, conj_t=True)
    assert image.shape == (L, -(-CI // 128), -(-CO // 16), 2, 128, 32)
    torch.testing.assert_close(image, dhconv_weight_image(conj_transpose(w).contiguous()),
                               rtol=0, atol=0)
    got = _k1_as_the_kernel(g, image, CO, CI, L)
    xg = x.clone().requires_grad_()
    want, = torch.autograd.grad(contract_dhconv(xg, w), xg, g)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
    dw = dhconv_weight_grad(x, g)
    wg = w.clone().requires_grad_()
    want_dw, = torch.autograd.grad(contract_dhconv(x, wg), wg, g)
    assert _rel(dw.numpy(), want_dw.numpy()) <= 1e-6


def test_dhconv_weight_grad_puts_back_the_matmul_precision():
    """dW switches TF32 off for its product and puts the caller's setting
    back, whichever it was; the product is the same either way here."""
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((1, 3, 5, 4, 2)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((1, 3, 5, 6, 2)).astype(np.float32))
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        got = {}
        for tf32 in (True, False):
            flags.allow_tf32 = tf32
            got[tf32] = dhconv_weight_grad(x, g)
            assert flags.allow_tf32 == tf32
    finally:
        flags.allow_tf32 = before
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)


# --------------------------------------------------------------------- F6

def test_fused_kernels_refuse_autograd():
    """F6: the kernels without a backward raise under grad, on the CPU as
    on the card, and run under no_grad."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, generator=g)
    w1 = torch.randn(16, 32, generator=g, requires_grad=True)
    b1, w2, b2 = torch.zeros(32), torch.randn(32, 16, generator=g), torch.zeros(16)
    a, c = torch.ones(2, 1, 16), torch.zeros(2, 1, 16)
    with pytest.raises(RuntimeError, match="fused_mlp: the kernel has no backward"):
        fused_mlp(x, w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="fused_block_tail: the kernel has no backward"):
        fused_block_tail(x, a, c, w1, b1, w2, b2)
    xf = torch.randn(1, 4, 3, 4, 2, requires_grad=True)
    A = torch.randn(3, 4, 3)
    C = torch.randn(3, 2, 2)
    with pytest.raises(RuntimeError, match="fused_rank: the kernel has no backward"):
        fused_rank(xf, A, A, C)
    with torch.no_grad():
        assert fused_mlp(x, w1, b1, w2, b2).shape == (2, 8, 16)
        assert fused_rank(xf, A, A, C).shape == xf.shape


def test_fused_modules_refuse_training():
    """F6 through the modules: MLP2d(fused=True) and SFNO(fused_rank=True)
    in a training forward raise; the plain forms train."""
    mlp = MLP2d(8, 16, 8, drop_rate=0.1, fused=True)
    x = torch.randn(4, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        mlp(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kw = dict(img_shape=(16, 32), in_chans=5, out_chans=5, embed_dim=16, num_layers=3,
              factorization="cp", rank=0.25)
    net = SFNO(SFNOConfig(**kw), fused_rank=True)
    net.init_weights(torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="fused_rank: the kernel has no backward"):
        net(torch.randn(1, 16, 32, 5))
    plain = SFNO(SFNOConfig(**kw))
    plain.load_state_dict(net.state_dict())
    plain(torch.randn(1, 16, 32, 5)).sum().backward()
    assert all(p.grad is not None for p in plain.parameters())


# ----------------------------------------------------------------- losses

@pytest.mark.parametrize("name", ["l1", "mae", "l2", "mse", "l1_rel", "l2_rel"])
def test_losses_match_jax(name):
    r = np.random.default_rng(4)
    p = r.standard_normal((2, 8, 16, 3)).astype(np.float32)
    t = r.standard_normal((2, 8, 16, 3)).astype(np.float32)
    got = float(tlosses.get_loss_fn(name)(torch.from_numpy(p), torch.from_numpy(t)))
    want = float(jlosses.get_loss_fn(name)(jnp.asarray(p), jnp.asarray(t)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_weighted_losses_match_jax():
    r = np.random.default_rng(5)
    p = r.standard_normal((2, 8, 16, 3)).astype(np.float32)
    t = r.standard_normal((2, 8, 16, 3)).astype(np.float32)
    w = r.random((8, 16)).astype(np.float32)
    for tf, jf in ((tlosses.area_weighted_mse, jlosses.area_weighted_mse),
                   (tlosses.global_mean_loss, jlosses.global_mean_loss)):
        got = float(tf(torch.from_numpy(w))(torch.from_numpy(p), torch.from_numpy(t)))
        want = float(jf(jnp.asarray(w))(jnp.asarray(p), jnp.asarray(t)))
        assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get_loss_fn("huber")


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize("name,warmup,total", [("constant", 0, 10), ("cosine", 0, 10),
                                               ("warmup_cosine", 3, 10),
                                               ("warmup_cosine", 0, 5),
                                               ("warmup_cosine", 100, 8)])
def test_schedules_match_optax_at_every_step(name, warmup, total):
    """Every step of a short run, past its end too; step 0 of warmup_cosine
    is 0 (float32 rounding on the optax side: 1e-6 relative)."""
    got = tsched.get_scheduler(name, 4e-4, total, warmup)
    want = jsched.get_scheduler(name, 4e-4, total, warmup)
    for step in range(total + 3):
        g, w = got(step), float(want(step))
        assert abs(g - w) <= 1e-6 * 4e-4, (step, g, w)
    if name == "warmup_cosine":
        assert got(0) == 0.0


# -------------------------------------------------------------------- EMA

def test_ema_matches_jax_over_five_updates():
    """The count warm-up min(decay, (1 + n) / (10 + n)) and the average of
    a state_dict, against ema_update, after each of 5 updates."""
    net = torch.nn.Linear(4, 3)
    r = np.random.default_rng(6)
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    ema = EMA(net, decay=0.9)
    jema = ema_init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(5):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(torch.from_numpy(r.standard_normal(p.shape).astype(np.float32)))
        ema.update(net)
        jema = ema_update(jema, {n: jnp.asarray(p.detach().numpy())
                                 for n, p in net.named_parameters()}, 0.9)
        for n in params:
            np.testing.assert_allclose(ema.state_dict()[n].numpy(), np.asarray(jema.params[n]),
                                       rtol=1e-6, atol=1e-7)
    assert ema.count == int(jema.count) == 5
    ema.state_dict()["weight"].add_(0)  # a copy: the average never aliases the weights
    assert ema.state_dict()["weight"].data_ptr() != net.weight.data_ptr()


# --------------------------------------------------------------- optimizer

class _GradientExperiment:
    """A stand-in experiment whose loss is sum(p * G_step): its gradients
    are the given G, so the trainer's update is held to optax's."""

    def __init__(self, model, grads):
        self.model = model
        self.grads = grads  # per step: name -> array
        self.normalizer = DebugDataModule(channels=1, height=2, width=4,
                                          n_timesteps=8).normalizer
        self.calls = 0

    def train_loss(self, dyn, generator, dynamical_condition=None):
        g = self.grads[self.calls]
        self.calls += 1
        loss = sum((p * torch.from_numpy(g[n])).sum() for n, p in self.model.named_parameters())
        return loss, {"loss": loss}


@pytest.mark.parametrize("accumulate", [1, 2])
def test_adamw_clip_mask_schedule_match_the_optax_chain(accumulate):
    """Over 3 applied updates (6 steps when accumulating 2), on a converted
    SFNO tree: clip_by_global_norm, adamw with the weight-decay mask
    (>= 2-D, not pos_embed) and warmup_cosine, and MultiSteps, against
    trainer.py's optax chain fed the same gradients. Parameters within 1e-5
    of their largest entry: optax evaluates Adam's bias
    corrections in float32 (1 - 0.999 rounds 1.3e-5 off), torch in float64,
    which moves each update by about 6e-6 of its size."""
    kw = dict(img_shape=(8, 16), in_chans=3, out_chans=3, embed_dim=8, num_layers=2,
              with_time_emb=True)
    net = SFNO(SFNOConfig(**kw))
    net.init_weights(torch.Generator().manual_seed(7))
    r = np.random.default_rng(8)
    n_steps = 3 * accumulate
    grads = [{n: (r.standard_normal(p.shape) * 0.3).astype(np.float32)
              for n, p in net.named_parameters()} for _ in range(n_steps)]
    params0 = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    exp = _GradientExperiment(net, grads)
    cfg = TrainerConfig(lr=1e-2, warmup_steps=2, epochs=1, steps_per_epoch=6,
                        accumulate_grad_batches=accumulate, use_ema=False)
    tr = Trainer(exp, None, cfg)
    state = tr.init_state()
    dummy = torch.zeros(1)
    for _ in range(n_steps):
        tr.train_step(state, dummy, None, torch.Generator())
    assert state.updates == 3 and state.step == n_steps

    nest = {}
    for n, v in params0.items():  # the flat names as a nested tree, as flax keeps them
        d = nest
        *path, leaf = n.split(".")
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(v)
    sched = jsched.get_scheduler("warmup_cosine", 1e-2, 6, 2)
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adamw(sched, weight_decay=5e-3, mask=_wd_mask))
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    opt = tx.init(nest)
    p = nest

    def as_tree(g):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(g[".".join(k.key for k in path)]), nest)

    for step in range(n_steps):
        upd, opt = tx.update(as_tree(grads[step]), opt, p)
        p = optax.apply_updates(p, upd)
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(p)}
    for n, t in net.named_parameters():
        scale = float(np.abs(flat[n]).max()) or 1.0
        assert float(np.abs(t.detach().numpy() - flat[n]).max()) <= 1e-5 * scale, n


# ---------------------------------------------------------- TrainerConfig

@pytest.mark.parametrize("field,value", [
    ("grad_reduce_dtype", "bfloat16"), ("zero_shard_opt_state", True),
    ("ckpt_mirror", "s3://bucket/prefix"), ("save_to_wandb", True)])
def test_trainer_config_refuses_unported_values(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TrainerConfig(**{field: value})


def test_trainer_config_keeps_the_jax_fields():
    """Same field names and defaults as the JAX TrainerConfig; the code
    snapshot beside checkpoints, rng_impl and the other fit modes are
    accepted."""
    from spherical_dyffusion_tpu.training.trainer import TrainerConfig as JTrainerConfig

    jf = {f.name: f.default for f in dataclasses.fields(JTrainerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    assert jf == tf
    TrainerConfig(ckpt_dir="/nowhere")
    TrainerConfig(ckpt_dir="/nowhere", code_snapshot=False, rng_impl="threefry")
    TrainerConfig(fit_mode="streaming", segment_samples=4, adam_mu_dtype="bfloat16",
                  watch_histograms=True, rollout_val_every=10)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("strategy", ["sequential", "direct", "random", "interpolation"])
def test_windowed_dataset_copy_matches_jax(strategy):
    """The same windows, packed and normalized, from the same source."""
    jdm = JDebugDataModule(channels=3, height=8, width=16, horizon=3, n_forcing=2,
                           n_timesteps=12)
    dm = DebugDataModule(channels=3, height=8, width=16, horizon=3, n_forcing=2,
                         n_timesteps=12)
    np.testing.assert_allclose(dm.normalizer.means.numpy(), np.asarray(jdm.normalizer.means),
                               rtol=1e-6)
    jds = JWindowedDataset(jdm._source("train"), jdm.cfg.in_names, 3,
                           forcing_names=jdm.cfg.forcing_names,
                           forcing_normalizer=jdm.forcing_normalizer, strategy=strategy, seed=3)
    ds = WindowedDataset(dm._source("train"), dm.cfg.in_names, 3,
                         forcing_names=dm.cfg.forcing_names,
                         forcing_normalizer=dm.forcing_normalizer, strategy=strategy, seed=3)
    assert len(ds) == len(jds) == 9
    for i in (0, 4, 8):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_datamodule_batches_match_jax():
    """Shuffled train batches (host torch tensors) and val batches."""
    kw = dict(channels=3, height=8, width=16, horizon=3, n_forcing=2, n_timesteps=12,
              batch_size=2, max_val_samples=3)
    jdm, dm = JDebugDataModule(**kw), DebugDataModule(**kw)
    for got, want in ((list(dm.train_batches(seed=4)), list(jdm.train_batches(seed=4))),
                      (list(dm.val_batches()), list(jdm.val_batches()))):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6, atol=1e-6)
    assert dm.grid.horizontal.shape == (8, 16)
