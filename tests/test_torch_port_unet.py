"""Parity of the port's UNet (``models/unet.py``) with the JAX package, on the CPU.

Each module (``WSConv``, ``ChanLayerNorm``, ``ConvBlock`` with and without
the time scale-shift, ``ResnetBlock`` with its 1x1 projection,
``LinearAttention``, ``FullAttention``, ``PreNormResidual``) and the whole
UNet on an even grid with a time embedding and both conditions, on 45 x 90
through the bilinear and the nearest outer resampler, with
``keep_spatial_dims`` and in ``debug_mode``, get the same numpy inputs from a
seed in float32. The weights are the port's, drawn from a seed and carried to
JAX by ``utils/convert.py`` (no JAX initializer is compiled; the parameter
tree's names and shapes are JAX's ``eval_shape`` of its ``init``). Dropout
is off for parity and checked by its statistics.

Tolerances: outputs 1e-5 of the largest output value (GroupNorm's one-pass
variance in flax against torch's two-pass leaves a few 1e-7 of it); the
gradients of one loss 1e-4 of each tensor's largest entry, or 1e-7 of the
network's largest entry where a tensor's gradient is rounding alone (the
bias of a conv whose GroupNorm group holds its channel alone, which the
norm removes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.models import unet as junet
from spherical_dyffusion_tpu_torch.models import modules as tmodules
from spherical_dyffusion_tpu_torch.models import unet
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)


def _fill(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights: norm scales around 1, everything else around 0."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            v = rng.standard_normal(p.shape).astype(np.float32) * 0.3
            if name.rsplit(".", 1)[-1] in ("scale", "g"):
                v = 1.0 + v
            p.copy_(torch.from_numpy(v))
    return module


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, 2, 3, 1).detach().numpy()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{err:.3g} vs {tol} x {np.abs(want).max()}"


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ modules

def test_wsconv_matches_jax():
    x = _x((2, 6, 10, 5))
    port = _fill(unet.WSConv(5, 8), 1)
    want = junet.WSConv(8).apply(state_dict_to_flax(port.state_dict()), jnp.asarray(x))
    _close(_nhwc(port(_nchw(x))), want)


def test_chan_layer_norm_matches_jax():
    x = _x((2, 6, 10, 8)) * 3.0 + 1.0
    port = _fill(unet.ChanLayerNorm(8), 2)
    want = junet.ChanLayerNorm(8).apply(state_dict_to_flax(port.state_dict()), jnp.asarray(x))
    _close(_nhwc(port(_nchw(x))), want)


@pytest.mark.parametrize("scale_shift", [False, True])
def test_conv_block_matches_jax(scale_shift):
    x = _x((2, 6, 10, 4))
    port = _fill(unet.ConvBlock(4, 16, groups=8), 3)
    ss_np = (_x((2, 1, 1, 16), 4), _x((2, 1, 1, 16), 5)) if scale_shift else None
    want = junet.ConvBlock(16, 8).apply(
        state_dict_to_flax(port.state_dict()), jnp.asarray(x),
        tuple(jnp.asarray(a) for a in ss_np) if ss_np else None)
    ss = tuple(_nchw(a) for a in ss_np) if ss_np else None
    _close(_nhwc(port(_nchw(x), ss)), want)


def test_resnet_block_with_projection_matches_jax():
    x, temb = _x((2, 6, 10, 4)), _x((2, 12), 6)
    port = _fill(unet.ResnetBlock(4, 16, groups=8, time_emb_dim=12), 7)
    assert hasattr(port, "Conv_0")
    want = junet.ResnetBlock(16, 8, time_emb_dim=12).apply(
        state_dict_to_flax(port.state_dict()), jnp.asarray(x), jnp.asarray(temb))
    _close(_nhwc(port(_nchw(x), torch.from_numpy(temb))), want)


@pytest.mark.parametrize("kind", ["LinearAttention", "FullAttention"])
def test_attention_matches_jax(kind):
    x = _x((2, 5, 7, 16))
    port = _fill(getattr(unet, kind)(16, heads=2, dim_head=8), 8)
    want = getattr(junet, kind)(16, 2, 8).apply(state_dict_to_flax(port.state_dict()),
                                                jnp.asarray(x))
    _close(_nhwc(port(_nchw(x))), want)


def test_pre_norm_residual_matches_jax():
    """flax names the attention handed to a top-level ``PreNormResidual``
    ``fn``; the port passes it with the call."""
    x = _x((2, 5, 7, 16))
    pre, fn = _fill(unet.PreNormResidual(16), 9), _fill(unet.LinearAttention(16, 2, 8), 10)
    tree = state_dict_to_flax(pre.state_dict())
    tree["params"]["fn"] = state_dict_to_flax(fn.state_dict())["params"]
    want = junet.PreNormResidual(16, junet.LinearAttention(16, 2, 8)).apply(
        tree, jnp.asarray(x))
    _close(_nhwc(pre(_nchw(x), fn)), want)


# --------------------------------------------------------------- the UNet

UNETS = {
    "even_time_conditions": dict(img_shape=(16, 32), in_chans=5, out_chans=3, dim=8,
                                 dim_mults=(1, 2), with_time_emb=True),
    "bilinear_45x90": dict(img_shape=(45, 90), in_chans=2, out_chans=2, dim=8,
                           dim_mults=(1, 2), outer_sample_mode="bilinear",
                           upsample_dims=(48, 96)),
    "nearest_45x90": dict(img_shape=(45, 90), in_chans=2, out_chans=2, dim=8,
                          dim_mults=(1, 2), outer_sample_mode="nearest",
                          upsample_dims=(48, 96)),
    "keep_spatial_dims": dict(img_shape=(12, 20), in_chans=2, out_chans=2, dim=8,
                              dim_mults=(1, 2), keep_spatial_dims=True, with_time_emb=True),
    "debug_mode": dict(img_shape=(16, 32), in_chans=2, out_chans=2, dim=64,
                       dim_mults=(1, 2, 4, 8), debug_mode=True),
}


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _port_unet(kw, seed=0):
    net = unet.UNet(unet.UNetConfig(**kw))
    net.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases and norm affines off their init values
        g = torch.Generator().manual_seed(seed + 100)
        for n, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _inputs(kw, B=2):
    H, W = kw["img_shape"]
    x = _x((B, H, W, 3 if kw["in_chans"] == 5 else kw["in_chans"]), 11)
    extra = {}
    if kw["in_chans"] == 5:  # condition (1 channel) and static condition (1 channel)
        extra = dict(condition=_x((B, H, W, 1), 12), static_condition=_x((B, H, W, 1), 13))
    t = np.array([1.0, 2.5], np.float32)[:B] if kw.get("with_time_emb") else None
    return x, t, extra


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_matches_jax(name):
    """The parameter tree is JAX's (names and shapes of its ``init``, by
    ``eval_shape``), and the forward equals JAX's within 1e-5 of the
    largest output."""
    kw = UNETS[name]
    net = _port_unet(kw)
    x, t, extra = _inputs(kw)
    jm = junet.UNet(junet.UNetConfig(**kw))
    jt = jnp.asarray(t) if t is not None else None
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), time=jt,
                                            **jextra))
    assert _flat_shapes(shapes["params"]) == {k: tuple(v.shape)
                                              for k, v in net.state_dict().items()}
    want = jax.jit(lambda p, x, t, e: jm.apply(p, x, time=t, **e))(
        state_dict_to_flax(net.state_dict()), jnp.asarray(x), jt, jextra)
    got = net(torch.from_numpy(x), time=torch.from_numpy(t) if t is not None else None,
              **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got.detach().numpy(), want)
    if name == "debug_mode":
        assert net.init_conv.kernel.shape[-1] == 8 and len(net.resamples_down) == 3


def test_unet_loss_gradients_match_jax():
    """One level (``down0_conv``, the bottleneck, ``up0_conv``) keeps every
    kind of parameter and halves JAX's compile."""
    kw = dict(UNETS["even_time_conditions"], dim_mults=(1,))
    net = _port_unet(kw, seed=3)
    x, t, extra = _inputs(kw)
    jm = junet.UNet(junet.UNetConfig(**kw))

    def loss(p):
        y = jm.apply(p, jnp.asarray(x), time=jnp.asarray(t),
                     **{k: jnp.asarray(v) for k, v in extra.items()})
        return jnp.mean(y ** 2)

    jg = jax.jit(jax.grad(loss))(state_dict_to_flax(net.state_dict()))
    want = {k: np.asarray(v) for k, v in _flat(jg["params"]).items()}
    y = net(torch.from_numpy(x), time=torch.from_numpy(t),
            **{k: torch.from_numpy(v) for k, v in extra.items()})
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(torch.mean(y ** 2), params)
    got = {n: g.numpy() for n, g in zip(names, grads)}
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        assert float(np.abs(got[k] - w).max()) <= 1e-4 * scale, k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------------------------ dropout

def _four_sigma(p, n):
    return 4.0 * np.sqrt(p * (1 - p) / n)


def test_dropout_keep_rate_scale_and_form(monkeypatch):
    """A ConvBlock at 64 channels drops on its channels-last view by the
    quantized rule (keep t/256, kept values scaled 256/t); the bottleneck
    attention's matrix at 3 x 5 = 15 pixels (not a multiple of 4; 1058 at
    the published width) takes the exact rate (keep 1 - rate, scale
    1/(1 - rate)), as JAX's module decides on its own last axis; at 4 x 4
    pixels the quantized rule again."""
    exact_calls = []
    real = tmodules.exact_dropout
    monkeypatch.setattr(tmodules, "exact_dropout",
                        lambda x, rate, g, mesh=None: exact_calls.append(tuple(x.shape))
                        or real(x, rate, g, mesh))
    gen = torch.Generator().manual_seed(0)

    # the ConvBlock: the quantized form on (B, H, W, 64)
    block = _fill(unet.ConvBlock(64, 64, groups=8, dropout=0.3), 0)
    t = round(0.7 * 256)
    x = torch.randn(2, 64, 24, 40).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = block(x)
        y = block(x, deterministic=False, generator=gen)
    kept = y != 0
    frac = float(kept.float().mean())
    assert abs(frac - t / 256) <= _four_sigma(t / 256, kept.numel())
    torch.testing.assert_close(y[kept], (ref * (256.0 / t))[kept], rtol=1e-6, atol=0)
    assert not exact_calls

    # the attention matrix: exact where its last axis is not a multiple of 4
    attn = _fill(unet.FullAttention(16, heads=2, dim_head=8, dropout=0.25), 1)
    seen = []
    monkeypatch.setattr(torch, "softmax", lambda a, dim: seen.append(a.shape) or
                        torch.nn.functional.softmax(a, dim=dim))
    with torch.no_grad():
        attn(torch.randn(1, 16, 3, 5), deterministic=False, generator=gen)
        assert exact_calls == [(1, 2, 15, 15)] and seen[-1] == (1, 2, 15, 15)
        attn(torch.randn(1, 16, 4, 4), deterministic=False, generator=gen)
        assert exact_calls == [(1, 2, 15, 15)]
    # the exact form's statistics
    a = torch.ones(400, 1058)
    d = tmodules.exact_dropout(a, 0.1, gen)
    kept = d != 0
    assert abs(float(kept.float().mean()) - 0.9) <= _four_sigma(0.9, a.numel())
    torch.testing.assert_close(d[kept], torch.full_like(d[kept], 1 / 0.9))
