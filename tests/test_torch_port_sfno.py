"""Parity of the PyTorch port's SFNO with the JAX package, on the CPU.

Weights are made by the JAX package's initializers from a seed and carried
into the port with ``utils/convert.py``; inputs are made with numpy. The
forward runs in float32 on both sides (the conftest sets JAX to the highest
matmul precision). The SFNO stacks a dozen float32 products and transforms,
summed in different orders by the two frameworks, so outputs agree to a few
float32 ulps of their largest magnitude; the tolerance is 1e-5 of it.
(With the JAX initializers the outputs are small, about 1e-2, so every
tolerance here is relative to the largest output.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REL = 1e-5


def _assert_close(got, want, rel=REL):
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs error {err:.3g} vs {rel:g} x {scale:.3g}"


def _cfg_kwargs(**kw):
    base = dict(img_shape=(16, 32), in_chans=7, out_chans=5, embed_dim=16, num_layers=3,
                operator_type="dhconv", with_time_emb=True, dropout_mlp=0.1,
                drop_path_rate=0.1, min_time=1, max_time=5)
    base.update(kw)
    return base


def _inputs(seed=0, B=2, C=5, CF=2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, 16, 32, C)).astype(np.float32)
    cond = r.standard_normal((B, 16, 32, CF)).astype(np.float32)
    t = np.asarray([1.0, 3.5][:B], np.float32)
    return x, cond, t


def _boost_filters(tree):
    """The JAX initializer draws spectral weights at std 1/(ci*co), which
    leaves the filter a negligible share of the output; scale them up so the
    spectral path (SHT, dhconv, ISHT, regridding) shows in the comparison."""
    return {k: (_boost_filters(v) if isinstance(v, dict) else
                (v * 64.0 if k == "weight" else v)) for k, v in tree.items()}


def _jax_forward(cfg_kw, x, cond, t, seed=0):
    model = JSFNO(JSFNOConfig(**cfg_kw))
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), time=jnp.asarray(t),
                           static_condition=jnp.asarray(cond))
    variables = {**variables, "params": _boost_filters(variables["params"])}
    y = model.apply(variables, jnp.asarray(x), time=jnp.asarray(t),
                    static_condition=jnp.asarray(cond))
    return variables, np.asarray(y)


def _port_forward(cfg_kw, variables, x, cond, t):
    model = SFNO(SFNOConfig(**cfg_kw))
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        y = model(torch.from_numpy(x), time=torch.from_numpy(t),
                  static_condition=torch.from_numpy(cond))
    return y.numpy()


@pytest.mark.parametrize("use_pallas,fused_mlp", [(False, False), (True, True),
                                                   (True, False), (False, True)])
def test_sfno_forward_matches_jax(use_pallas, fused_mlp):
    """Deterministic forward (dropout and DropPath configured but off), with
    the kernel routes on and off on both sides: on the CPU the port's
    wrappers compute their plain versions, the JAX kernels run interpreted."""
    kw = _cfg_kwargs(use_pallas=use_pallas, fused_mlp=fused_mlp)
    x, cond, t = _inputs()
    variables, want = _jax_forward(kw, x, cond, t)
    got = _port_forward(kw, variables, x, cond, t)
    assert got.shape == want.shape == (2, 16, 32, 5) and got.dtype == np.float32
    _assert_close(got, want)


def test_sfno_variants_match_jax():
    """Two encoder layers, time scale-shift after the filter, time rescale,
    erf gelu, no big skip, exact norm, no position embedding."""
    kw = _cfg_kwargs(encoder_layers=2, time_scale_shift_before_filter=False,
                     time_rescale=True, activation_function="gelu_exact", big_skip=False,
                     exact_norm=True, pos_embed=False, num_layers=2)
    x, cond, t = _inputs(seed=3)
    variables, want = _jax_forward(kw, x, cond, t, seed=1)
    _assert_close(_port_forward(kw, variables, x, cond, t), want)


def test_scan_layers_params_carry_over():
    """A tree saved with scan_layers (middle blocks stacked under
    blocks_mid/block) loads into the port and gives the JAX forward."""
    kw = _cfg_kwargs(scan_layers=True, num_layers=4)
    x, cond, t = _inputs(seed=4)
    variables, want = _jax_forward(kw, x, cond, t, seed=2)
    assert "blocks_mid" in variables["params"]
    _assert_close(_port_forward(kw, variables, x, cond, t), want)


def test_bf16_compute_matches_jax_and_promotes_residual_stream():
    """Under bf16 compute the Dense layers run in bf16 and every block
    returns float32 (the JAX package's promotion of the residual stream).
    bf16 rounds at other places in the two frameworks, so the outputs agree
    to bf16 precision only: 3e-2 of the largest output (bf16 keeps 8 bits,
    a relative step of 4e-3, and a dozen layers compound it)."""
    kw = _cfg_kwargs(compute_dtype="bfloat16", use_pallas=True, fused_mlp=True)
    x, cond, t = _inputs(seed=5)
    variables, want = _jax_forward(kw, x, cond, t, seed=3)
    model = SFNO(SFNOConfig(**kw))
    model.load_state_dict(flax_to_state_dict(variables))
    seen = []
    for block in model.blocks:
        block.register_forward_hook(lambda mod, args, out: seen.append(out.dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x), time=torch.from_numpy(t),
                    static_condition=torch.from_numpy(cond)).numpy()
    assert seen == [torch.float32] * 3
    _assert_close(got, want, rel=3e-2)


def test_dropout_is_live_only_when_not_deterministic():
    kw = _cfg_kwargs(fused_mlp=True)
    x, cond, t = _inputs(seed=6)
    model = SFNO(SFNOConfig(**kw))
    model.init_weights(torch.Generator().manual_seed(0))
    args = (torch.from_numpy(x),)
    kwargs = dict(time=torch.from_numpy(t), static_condition=torch.from_numpy(cond))
    with torch.no_grad():
        det = model(*args, **kwargs)
        a = model(*args, **kwargs, deterministic=False,
                  generator=torch.Generator().manual_seed(1))
        b = model(*args, **kwargs, deterministic=False,
                  generator=torch.Generator().manual_seed(1))
        c = model(*args, **kwargs, deterministic=False,
                  generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, det) and not torch.equal(a, c)


# values the JAX package rejects, each with the exception it raises there
# (at model build: its SFNOConfig checks nothing itself); the port refuses
# them too, with the same exception type
REJECTED = [
    (dict(operator_type="foo"), ValueError),
    (dict(operator_type="l-dependant"), ValueError),  # a linear filter's operator
    (dict(factorization="foo"), ValueError),
    (dict(factorization="tucker", operator_type="diagonal"), NotImplementedError),
    (dict(factorization="tt", operator_type="diagonal"), NotImplementedError),
    (dict(filter_type="foo"), ValueError),
    (dict(spectral_transform="foo"), ValueError),
    (dict(normalization_layer="foo"), ValueError),
    (dict(filter_type="non-linear", complex_activation="modulus"), ValueError),
    (dict(activation_function="foo"), ValueError),
    (dict(data_grid="foo"), ValueError),
]


@pytest.mark.parametrize("fields,exc", REJECTED,
                         ids=["-".join(f"{k}={v}" for k, v in f.items()) for f, _ in REJECTED])
def test_unsupported_config_fields_raise(fields, exc):
    kw = dict(img_shape=(8, 16), in_chans=3, out_chans=3, embed_dim=8, num_layers=2, **fields)
    with pytest.raises(exc):
        JSFNO(JSFNOConfig(**kw)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, 3)))
    with pytest.raises(exc):
        SFNO(SFNOConfig(**kw))


def test_config_fields_mirror_jax():
    port = {f.name: f.default for f in dataclasses.fields(SFNOConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JSFNOConfig)}
    assert port == ref
