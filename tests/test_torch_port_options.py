"""Parity of the port's SFNO model options with the JAX package, on the CPU.

Every function of the option modules (the contractions, the folded and FFT
SHT paths, the planar FFT transforms, the spatial layer norm) and then the
SFNO forward for each option, against the JAX package, with weights made by
the JAX initializers from a seed (spectral weights scaled up so the filter
shows) and carried into the port by ``utils/convert.py``, unrolled and
stacked (``scan_layers``). Embed 16 x 2 layers (x 3 under ``scan_layers``)
on 16 x 32, dropout and DropPath configured but off.

Tolerances: float32 results agree to a few float32 ulps of their largest
magnitude, 1e-5 of it (the SFNO tests' tolerance). bf16 stages
(``sht_matmul_dtype``/``spectral_io_dtype`` = bfloat16) are held against the
JAX package's own bf16 path, whose CPU fallback to float32 the ``jax_bf16``
fixture lifts (as in ``tests/test_torch_port_rank.py``): a single stage with
equal rounded operands agrees to float32 summation order, 1e-6; a whole
SFNO to 1e-2 of its largest output, because a float32 sum that lands on the
other side of a bf16 rounding boundary moves that operand by one bf16 step
(2^-8 relative) and the SFNO carries such flips through its layers; a port
SFNO computed in float32 misses the JAX bf16 forward by more than 1e-4, so
the comparison sees the rounding points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spherical_dyffusion_tpu.ops.contractions as jcontractions
import spherical_dyffusion_tpu.ops.sht as jsht
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.models.modules import SpatialLayerNorm as JSpatialLayerNorm
from spherical_dyffusion_tpu.ops.fft import InverseRealFFT2 as JInverseRealFFT2
from spherical_dyffusion_tpu.ops.fft import RealFFT2 as JRealFFT2
from spherical_dyffusion_tpu_torch.models.modules import SpatialLayerNorm
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops import contractions as tc
from spherical_dyffusion_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

BF16 = torch.bfloat16
REL = 1e-5
REL_BF16_OPERANDS = 1e-6
REL_BF16_SFNO = 1e-2
# bf16 stages behind an FFT: the two frameworks' float32 FFTs differ in their
# last bits, so an FFT value near a bf16 rounding boundary rounds the other
# way (one bf16 step, 2^-8 of it) and moves its terms of the next product
REL_BF16_AFTER_FFT = 1e-3
F32_MISSES_BF16 = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def _rand(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    t = np.asarray(t)
    if np.iscomplexobj(t):
        return np.stack([t.real, t.imag], -1).astype(np.float32)
    return t.astype(np.float32)


def _c(a):
    """A stacked (..., 2) numpy pair as a JAX complex64 array."""
    return jnp.asarray(a[..., 0]) + 1j * jnp.asarray(a[..., 1])


class _Float32Dots:
    """``jax.numpy`` with one change: an einsum asked for a float32 result
    takes its bf16 operands as float32 values. A product of two bf16 values
    is exact in float32, so this is the bf16 dot with float32 sums that the
    TPU runs, for the dot shapes (the folded SHT's) that this XLA-CPU build
    refuses in bf16."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(eq, *ops, preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package computes its bf16 matmul dtype on the CPU as on the
    TPU: bf16 operands, float32 products and sums (the package's files stay
    as they are; only their module attributes are patched for one test)."""
    for mod in (jsht, jcontractions):
        monkeypatch.setattr(mod, "_effective_matmul_dtype", lambda requested: requested)
        monkeypatch.setattr(mod, "jnp", _Float32Dots())


# ------------------------------------------------------------ contractions

@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("operator_type", ["dhconv", "diagonal"])
def test_dense_contractions_match_jax(operator_type, separable):
    """contract_dhconv (separable: one weight per channel and l) and
    contract_diagonal (per (l, m)), through the ``contract`` dispatch with
    K1 asked for: only a dhconv filter that is not separable may take it,
    every other operator computes its plain function."""
    r = np.random.default_rng(1)
    L, M, ci, co = 6, 5, 4, 3
    x = _rand(r, 2, L, M, ci, 2)
    shape = (ci,) + (() if separable else (co,)) + (L,) + \
        ((M,) if operator_type == "diagonal" else ()) + (2,)
    w = _rand(r, *shape)
    want = jcontractions.contract(_c(x), jnp.asarray(w), operator_type, separable)
    for use_pallas in (False, True):
        got = tc.contract(torch.from_numpy(x), torch.from_numpy(w), use_pallas,
                          operator_type=operator_type, separable=separable)
        assert got.shape == want.shape + (2,)
        assert _rel(_np(got), _np(want)) <= REL
    with pytest.raises(ValueError, match="operator_type"):
        tc.contract(torch.from_numpy(x), torch.from_numpy(w), operator_type="l-dependant")


@pytest.mark.parametrize("io", [None, "bfloat16"])
def test_merged_dhconv_matches_jax(jax_bf16, io):
    """contract_dhconv_stacked (one product, real and imaginary parts as
    free axes) in float32 and with bf16 operands and emit, against the JAX
    package's merged GEMM; the float32 port misses its bf16 form."""
    r = np.random.default_rng(2)
    x, w = _rand(r, 2, 6, 7, 5, 2), _rand(r, 5, 4, 6, 2, scale=0.3)
    want = jcontractions.contract_dhconv_stacked(jnp.asarray(x), jnp.asarray(w))
    got = tc.contract_dhconv_stacked(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(_np(got), _np(want)) <= REL
    jdt, tdt = (None, None) if io is None else (jnp.bfloat16, BF16)
    want = jcontractions.contract_dhconv_stacked(jnp.asarray(x), jnp.asarray(w),
                                                 matmul_dtype=jnp.bfloat16, out_dtype=jdt)
    got = tc.contract_dhconv_stacked(torch.from_numpy(x), torch.from_numpy(w), BF16, tdt)
    assert got.dtype == (torch.float32 if io is None else BF16)
    assert _rel(_np(got), _np(want.astype(jnp.float32))) <= REL_BF16_OPERANDS
    four = tc.contract_dhconv(torch.from_numpy(x), torch.from_numpy(w), BF16, tdt)
    assert _rel(_np(got), _np(four)) <= REL_BF16_OPERANDS
    assert _rel(_np(tc.contract_dhconv_stacked(torch.from_numpy(x), torch.from_numpy(w))),
                _np(want.astype(jnp.float32))) > F32_MISSES_BF16


def _tucker_operands(seed, ci=6, co=5, R=3, L=5, M=4):
    r = np.random.default_rng(seed)
    return dict(A=_rand(r, ci, R, 2), B=_rand(r, co, R, 2), C=_rand(r, L, R, 2),
                core=_rand(r, R, R, R, 2), G1=_rand(r, ci, R, 2), G2=_rand(r, R, co, R, 2),
                G3=_rand(r, R, L, 2), xs=_rand(r, 2, L, M, ci, 2),
                zs=_rand(r, 2, L, M, 2 * R, 2))


def test_tucker_and_tt_match_jax_float32():
    """The spectral-space Tucker and TT contractions, the Tucker rank
    kernel and the rank pipeline's per-l mix, in float32."""
    o = _tucker_operands(3)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    jt = {k: jnp.asarray(v) for k, v in o.items()}
    pairs = [
        (tc.contract_dhconv_tucker(t["xs"], {k: t[k] for k in ("A", "B", "C", "core")}),
         jcontractions.contract_dhconv_tucker(_c(o["xs"]),
                                              {k: jt[k] for k in ("A", "B", "C", "core")})),
        (tc.contract_dhconv_tt(t["xs"], {k: t[k] for k in ("G1", "G2", "G3")}),
         jcontractions.contract_dhconv_tt(_c(o["xs"]), {k: jt[k] for k in ("G1", "G2", "G3")})),
        (tc.tucker_rank_kernel(t["core"], t["C"]),
         jcontractions.tucker_rank_kernel(jt["core"], jt["C"])),
    ]
    K = jcontractions.tucker_rank_kernel(jt["core"], jt["C"])
    pairs.append((tc.tucker_spectral_mix_stacked(t["zs"], torch.from_numpy(np.asarray(K))),
                  jcontractions.tucker_spectral_mix_stacked(jt["zs"], K)))
    for got, want in pairs:
        want = _np(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(_np(got), want) <= REL


@pytest.mark.parametrize("io", [None, "bfloat16"])
def test_tucker_mix_bf16_holds_jax_rounding_points(jax_bf16, io):
    """The Tucker rank mix with bf16 operands: the rank spectrum formed in
    the emitted spectrum's dtype, rounded with K for the product, float32
    sums, the emit."""
    o = _tucker_operands(4)
    jdt, tdt = (None, None) if io is None else (jnp.bfloat16, BF16)
    zs = o["zs"] if io is None else _np(torch.from_numpy(o["zs"]).to(BF16))
    K = jcontractions.tucker_rank_kernel(jnp.asarray(o["core"]), jnp.asarray(o["C"]))
    zj = jnp.asarray(zs) if io is None else jnp.asarray(zs).astype(jnp.bfloat16)
    want = jcontractions.tucker_spectral_mix_stacked(zj, K, jnp.bfloat16, jdt)
    zt = torch.from_numpy(zs) if io is None else torch.from_numpy(zs).to(BF16)
    Kt = torch.from_numpy(np.asarray(K))
    got = tc.tucker_spectral_mix_stacked(zt, Kt, BF16, tdt)
    assert got.dtype == (torch.float32 if io is None else BF16)
    assert _rel(_np(got), _np(want.astype(jnp.float32))) <= REL_BF16_OPERANDS
    assert _rel(_np(tc.tucker_spectral_mix_stacked(zt.float(), Kt)),
                _np(want.astype(jnp.float32))) > F32_MISSES_BF16


# -------------------------------------------------- folded and FFT SHT paths

SHT_SHAPES = {"even": (16, 32, 12, 13), "odd lmax": (16, 32, 11, 13)}


@pytest.mark.parametrize("shape", list(SHT_SHAPES))
@pytest.mark.parametrize("fold,lon", [(True, "matmul"), (False, "fft"), (True, "fft")])
def test_sht_options_match_jax_float32(fold, lon, shape):
    """The folded Legendre stage and the FFT longitude stage, forward and
    inverse, on both grids, in float32. With an odd lmax the JAX package
    falls back to the unfolded form without a word, and so does the port;
    with even nlat and lmax the folded transform equals the unfolded one."""
    r = np.random.default_rng(5)
    dims = SHT_SHAPES[shape]
    for grid in ("legendre-gauss", "equiangular"):
        x = _rand(r, 2, 16, 32, 3)
        s = _rand(r, 2, dims[2], dims[3], 3, 2)
        jf = jsht.RealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)
        ji = jsht.InverseRealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)
        pf = RealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)
        pi = InverseRealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)
        assert pf.folded == pi.folded == (fold and shape == "even")
        want_f = _np(jf(jnp.asarray(x), stacked=True))
        want_i = _np(ji(jnp.asarray(s)))
        got_f, got_i = pf(torch.from_numpy(x)), pi(torch.from_numpy(s))
        assert _rel(_np(got_f), want_f) <= REL and _rel(_np(got_i), want_i) <= REL
        plain_f = RealSHT(*dims, grid=grid)(torch.from_numpy(x))
        plain_i = InverseRealSHT(*dims, grid=grid)(torch.from_numpy(s))
        assert _rel(_np(got_f), _np(plain_f)) <= REL and _rel(_np(got_i), _np(plain_i)) <= REL


@pytest.mark.parametrize("fold,lon", [(True, "matmul"), (False, "fft"), (True, "fft")])
def test_sht_options_bf16_hold_jax_rounding_points(jax_bf16, fold, lon):
    """With bf16 operands and the spectral-IO emit, the folded and FFT
    paths round where the JAX package's do: the forward emits only its
    spectral output (the longitude stage is not rounded to the IO dtype),
    and the inverse emits nothing and returns float32. The stages compose
    to the transform, as the rank pipeline calls them. (The forward FFT's
    float32 output is rounded for the Legendre product: see
    REL_BF16_AFTER_FFT.)"""
    r = np.random.default_rng(6)
    dims, grid = (16, 32, 12, 13), "legendre-gauss"
    x, s = _rand(r, 2, 16, 32, 4), _rand(r, 2, 12, 13, 4, 2)
    kw = dict(grid=grid, matmul_dtype="bfloat16", lon_method=lon, fold_symmetry=fold)
    jf = jsht.RealSHT(*dims, **kw)
    ji = jsht.InverseRealSHT(*dims, **kw)
    pf, pi = RealSHT(*dims, **kw), InverseRealSHT(*dims, **kw)
    want_f = jf(jnp.asarray(x), stacked=True, out_dtype=jnp.bfloat16)
    want_i = ji(jnp.asarray(s).astype(jnp.bfloat16), out_dtype=jnp.bfloat16)
    assert want_f.dtype == jnp.bfloat16 and want_i.dtype == jnp.float32
    got_f = pf(torch.from_numpy(x), out_dtype=BF16)
    got_i = pi(torch.from_numpy(s).to(BF16), out_dtype=BF16)
    assert got_f.dtype == BF16 and got_i.dtype == torch.float32
    tol_f = REL_BF16_AFTER_FFT if lon == "fft" else REL_BF16_OPERANDS
    assert _rel(_np(got_f), _np(want_f.astype(jnp.float32))) <= tol_f
    assert _rel(_np(got_i), _np(want_i)) <= REL_BF16_OPERANDS
    assert torch.equal(pf.latitude(pf.longitude(torch.from_numpy(x), BF16), BF16), got_f)
    assert torch.equal(pi.longitude(pi.latitude(torch.from_numpy(s).to(BF16), BF16), BF16),
                       got_i)
    f32 = RealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)(torch.from_numpy(x))
    assert _rel(_np(f32), _np(want_f.astype(jnp.float32))) > F32_MISSES_BF16


@pytest.mark.parametrize("lmax,mmax", [(16, 17), (11, 9), (1, 17)])
def test_planar_fft_matches_jax(lmax, mmax):
    """RealFFT2 / InverseRealFFT2 (norm "ortho"; ceil(lmax/2) non-negative
    and floor(lmax/2) negative meridional frequencies kept)."""
    r = np.random.default_rng(7)
    x, s = _rand(r, 2, 16, 32, 3), _rand(r, 2, lmax, mmax, 3, 2)
    want_f = _np(JRealFFT2.create(16, 32, lmax, mmax)(jnp.asarray(x)))
    want_i = _np(JInverseRealFFT2.create(16, 32, lmax, mmax)(_c(s)))
    got_f = RealFFT2(16, 32, lmax, mmax)(torch.from_numpy(x))
    got_i = InverseRealFFT2(16, 32, lmax, mmax)(torch.from_numpy(s))
    assert got_f.shape == want_f.shape and got_i.shape == want_i.shape
    assert _rel(_np(got_f), want_f) <= REL and _rel(_np(got_i), want_i) <= REL


@pytest.mark.parametrize("exact", [False, True])
def test_spatial_layer_norm_matches_jax(exact):
    r = np.random.default_rng(8)
    x = _rand(r, 2, 6, 8, 3) + 3.0
    jm = JSpatialLayerNorm((6, 8), exact=exact)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {k: jnp.asarray(_rand(r, 6, 8, 1)) for k in ("scale", "bias")}}
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = SpatialLayerNorm((6, 8), exact=exact)
    m.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in v["params"].items()})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= REL
    with torch.no_grad():
        assert m(torch.from_numpy(x).to(BF16)).dtype == BF16


# ------------------------------------------------------------------ the SFNO

def _kw(**kw):
    base = dict(img_shape=(16, 32), in_chans=7, out_chans=5, embed_dim=16, num_layers=2,
                with_time_emb=True, dropout_mlp=0.1, drop_path_rate=0.1, min_time=1,
                max_time=5)
    base.update(kw)
    return base


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (_rand(r, 2, 16, 32, 5), _rand(r, 2, 16, 32, 2), np.asarray([1.0, 3.5], np.float32))


def _boost(tree):
    """The JAX initializers draw spectral weights at std 1/(ci*co), which
    leaves the filter a negligible share of the output; scale the dense
    weights and factors up so the spectral path shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _boost(v)
        elif k == "weight":
            out[k] = v * 64.0
        elif k.split("_")[0] in ("cp", "tucker", "tt"):
            out[k] = v * 4.0
        else:
            out[k] = v
    return out


def _jax(kw, seed=0):
    x, cond, t = _inputs(seed)
    model = JSFNO(JSFNOConfig(**kw))
    args = (jnp.asarray(x),)
    kwargs = dict(time=jnp.asarray(t), static_condition=jnp.asarray(cond))
    variables = model.init(jax.random.PRNGKey(seed), *args, **kwargs)
    variables = {**variables, "params": _boost(variables["params"])}
    return variables, np.asarray(model.apply(variables, *args, **kwargs))


def _port(kw, variables, seed=0):
    x, cond, t = _inputs(seed)
    model = SFNO(SFNOConfig(**kw))
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        return model(torch.from_numpy(x), time=torch.from_numpy(t),
                     static_condition=torch.from_numpy(cond)).numpy(), model


# the rank pipeline needs both transforms on one grid: the middle block of
# three (the data grid is equiangular)
OPTIONS = {
    "tucker pipeline": dict(factorization="tucker", rank=0.25, num_layers=3),
    "tucker spectral": dict(factorization="tucker", rank=0.25, rank_pipeline=False),
    "tucker pipeline scale 2": dict(factorization="tucker", rank=0.25, scale_factor=2,
                                    num_layers=3),
    "tt": dict(factorization="tt", rank=0.5, num_layers=3),
    "tt pipeline off": dict(factorization="tt", rank=0.25, rank_pipeline=False),
    "separable dhconv K1 asked": dict(separable=True, use_pallas=True),
    "diagonal": dict(operator_type="diagonal"),
    "diagonal separable": dict(operator_type="diagonal", separable=True),
    "merged dhconv": dict(merged_dhconv=True),
    "layer norm": dict(normalization_layer="layer_norm"),
    "layer norm exact scale 2": dict(normalization_layer="layer_norm", exact_norm=True,
                                     scale_factor=2, num_layers=3),
    "fft transform K1 scale 2": dict(spectral_transform="fft", use_pallas=True, scale_factor=2),
    "lon fft K1": dict(lon_method="fft", use_pallas=True),
    "fold": dict(sht_fold_symmetry=True),
    "fold K1 scale 2": dict(sht_fold_symmetry=True, use_pallas=True, scale_factor=2),
    "fold odd lmax": dict(sht_fold_symmetry=True, hard_thresholding_fraction=0.7),
    "scale 2": dict(scale_factor=2),
    "legendre-gauss data": dict(data_grid="legendre-gauss"),
    "no mlp": dict(use_mlp=False),
    "no norm": dict(normalization_layer="none"),
    "relu": dict(activation_function="relu"),
}
NONLINEAR = {f"non-linear {op} {act}": dict(filter_type="non-linear", operator_type=op,
                                            complex_activation=act, spectral_layers=2)
             for op, act in (("diagonal", "real"), ("diagonal", "cartesian"),
                             ("l-dependant", "complex"), ("l-dependant", "real"),
                             ("dhconv", "complex"))}


@pytest.mark.parametrize("name", list(OPTIONS) + list(NONLINEAR))
def test_sfno_option_matches_jax(name):
    kw = _kw(**{**OPTIONS, **NONLINEAR}[name])
    variables, want = _jax(kw)
    got, model = _port(kw, variables)
    assert got.shape == want.shape == (2, 16, 32, 5)
    assert _rel(got, want) <= REL
    if name.startswith("tucker"):
        assert [b.filter.rank_pipeline for b in model.blocks] == \
            [False, "pipeline" in name, False][:len(model.blocks)]
    if name == "tt":  # only CP and Tucker take the rank pipeline
        assert not any(b.filter.rank_pipeline for b in model.blocks)
    if name == "merged dhconv":
        assert all(b.filter.merged for b in model.blocks)
    if name == "separable dhconv K1 asked":  # K1 is for the dense dhconv only
        assert all(b.filter._k1_image is None for b in model.blocks)


def test_option_gates_follow_jax():
    """The JAX package's gates, condition for condition: K1 takes only a
    dense dhconv filter that is not separable (and then the merged product
    is not taken); the rank pipeline only CP and Tucker dhconv filters that
    are not separable, between SHTs on one grid, with 2R <= the width; K4
    only CP's pipeline on the unfolded matmul SHT."""
    def filters(fused_rank=False, **kw):
        return [b.filter for b in SFNO(SFNOConfig(**_kw(num_layers=3, **kw)),
                                       fused_rank=fused_rank).blocks]

    assert not any(f.merged for f in filters(merged_dhconv=True, use_pallas=True))
    assert all(f._k1_image is not None for f in filters(merged_dhconv=True, use_pallas=True))
    for kw in (dict(operator_type="diagonal"), dict(separable=True),
               dict(factorization="cp", rank=0.25)):
        assert all(f._k1_image is None for f in filters(use_pallas=True, **kw))
    pipe = dict(factorization="tucker", rank=0.25)
    assert [f.rank_pipeline for f in filters(**pipe)] == [False, True, False]
    for kw in (dict(separable=True), dict(spectral_transform="fft"), dict(rank=0.75),
               dict(rank_pipeline=False)):
        assert not any(f.rank_pipeline for f in filters(**{**pipe, **kw}))
    cp = dict(factorization="cp", rank=0.25)
    assert [f.fused_rank for f in filters(True, **cp)] == [False, True, False]
    for kw in (dict(factorization="tucker"), dict(sht_fold_symmetry=True),
               dict(lon_method="fft")):
        assert not any(f.fused_rank for f in filters(True, **{**cp, **kw}))


@pytest.mark.parametrize("name", ["tucker pipeline", "tucker spectral", "tt", "fold"])
def test_sfno_option_bf16_holds_jax_rounding_points(jax_bf16, name):
    """bf16 transforms and contractions with the bf16 spectral-IO emit
    (float32 compute, so only the spectral rounding points differ from
    float32): the port against the JAX package's bf16 path, and the port
    in float32 missing it."""
    kw = _kw(**OPTIONS[name], sht_matmul_dtype="bfloat16", spectral_io_dtype="bfloat16")
    variables, want = _jax(kw, seed=1)
    got, _ = _port(kw, variables, seed=1)
    assert _rel(got, want) <= REL_BF16_SFNO
    f32 = dict(kw, sht_matmul_dtype="float32", spectral_io_dtype="")
    assert _rel(_port(f32, variables, seed=1)[0], want) > F32_MISSES_BF16


@pytest.mark.parametrize("name", ["tucker pipeline", "tt", "diagonal separable",
                                  "layer norm exact scale 2", "fold",
                                  "non-linear l-dependant complex"])
def test_sfno_option_under_scan_layers(name):
    """Each option under ``scan_layers`` (3 layers): the middle block's
    parameters saved stacked under ``blocks_mid/block`` load by
    unstacking, and the forward matches."""
    kw = _kw(**{**OPTIONS, **NONLINEAR}[name])
    kw.update(scan_layers=True, num_layers=max(3, kw["num_layers"]))
    variables, want = _jax(kw, seed=2)
    assert "blocks_mid" in variables["params"]
    got, model = _port(kw, variables, seed=2)
    assert _rel(got, want) <= REL


def test_new_initializers_follow_jax_scales():
    """Random weights from ``init_weights`` at the JAX initializers' scales:
    the dense spectral weight of every shape at 1/(ci*co) (a separable
    weight too, not 1/(ci*l)), Tucker and TT factors at (1/(ci*co))**(1/3),
    attention weights at 1/sqrt(embed*hidden) with zero biases, the layer
    norm's scale one and bias zero."""
    C = 32
    gen = torch.Generator().manual_seed(0)

    def built(**kw):
        m = SFNO(SFNOConfig(**_kw(embed_dim=C, **kw)))
        m.init_weights(gen)
        return m

    def std(p):
        return float(p.detach().std())

    sep = built(separable=True, normalization_layer="layer_norm")
    assert sep.block_0.filter.weight.shape == (C, 16, 2)
    assert abs(std(sep.block_0.filter.weight) / (1 / C ** 2) - 1) < 0.1
    assert torch.equal(sep.block_0.norm0.scale, torch.ones(16, 32, 1))
    assert torch.equal(sep.block_1.norm1.bias, torch.zeros(16, 32, 1))
    diag = built(operator_type="diagonal")
    assert abs(std(diag.block_0.filter.weight) / (1 / C ** 2) - 1) < 0.02
    for fact in ("tucker", "tt"):
        m = built(factorization=fact, rank=0.5)
        for name, p in m.block_0.filter.named_parameters():
            if name.startswith(fact):
                assert abs(std(p) / (1 / C ** 2) ** (1 / 3) - 1) < 0.2, name
    att = built(filter_type="non-linear", operator_type="l-dependant")
    f = att.block_0.filter
    assert f.w0_re.shape == (16, C, 2 * C) and f.wout_im.shape == (16, 2 * C, C)
    assert abs(std(f.w1_im) / (1 / (C * 2 * C) ** 0.5) - 1) < 0.02
    assert not f.b2_re.any() and not f.b0_im.any()


def test_config_accepts_the_jax_option_space():
    """Every option value that the JAX package runs builds here (the tile
    rows of its Pallas MLP too, any positive int), and the defaults mirror
    JAX's."""
    assert {f.name: f.default for f in dataclasses.fields(SFNOConfig)} == \
        {f.name: f.default for f in dataclasses.fields(JSFNOConfig)}
    for kw in (*OPTIONS.values(), *NONLINEAR.values(), dict(checkpointing=3),
               dict(filter_type="non-linear", operator_type="dhconv", factorization="tucker",
                    separable=True), dict(complex_activation="modulus"),
               dict(fused_mlp_tile_rows=512)):
        SFNO(SFNOConfig(**_kw(**kw)))


def test_fused_mlp_tile_rows_changes_no_result():
    """The CUDA kernels tile by their own rule, so ``fused_mlp_tile_rows``
    (the JAX package's Pallas row tile) leaves a forward through the fused
    tail (K3's path; its plain version on the CPU, dropout off) bit for bit
    the same at 256, 1024 and 4096; a tile of 0 rows raises."""
    x, cond, t = (torch.from_numpy(a) for a in _inputs())
    outs = []
    for rows in (256, 1024, 4096):
        model = SFNO(SFNOConfig(**_kw(fused_tail=True, fused_mlp_tile_rows=rows)))
        assert all(b.use_tail for b in model.blocks)
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(model(x, time=t, condition=cond))
    assert all(torch.equal(o, outs[1]) for o in outs)
    with pytest.raises(ValueError, match="fused_mlp_tile_rows"):
        SFNOConfig(fused_mlp_tile_rows=0)


def test_unknown_lon_method_raises_at_transform_build():
    """The transforms check ``lon_method`` themselves (they are built
    without a config too), so a config that names an unknown method raises
    when its model builds; the JAX package reads such a name as "fft"
    (ROADMAP Queue 3)."""
    for cls in (RealSHT, InverseRealSHT):
        with pytest.raises(ValueError, match="lon_method"):
            cls(16, 32, lon_method="foo")
    cfg = SFNOConfig(**_kw(lon_method="foo"))
    with pytest.raises(ValueError, match="lon_method"):
        SFNO(cfg)
