"""Parity of the port's float16 path with the JAX package, on the CPU.

``compute_dtype``, ``sht_matmul_dtype`` and ``spectral_io_dtype`` may be
"float16" in both packages. The same numpy inputs and weights go through
the JAX package and the port at debug size (embed 16, 16 x 32 grids); the
JAX kernels K2/K3 run in Pallas interpret mode, K4's prototype too.

On the CPU the JAX package resolves a 16-bit matmul dtype to float32
(``_effective_matmul_dtype`` in ``ops/sht.py`` and ``ops/contractions.py``).
The ``jax_f16`` fixture lifts that fallback for one test (monkeypatch; the
JAX package's files stay as they are) and hands the JAX modules' einsums
their float16 operands as float32 values: a product of two float16 values
(11-bit mantissas) is exact in float32, so that is the float16 dot with
float32 sums that an accelerator runs. The JAX package then rounds on the
CPU where it rounds on the card.

Tolerances, each relative to the largest magnitude of the reference:

* a single stage with the same rounded operands: float32 summation order,
  ``REL_F16_OPERANDS`` (1e-6);
* K2/K3's plain versions against the interpreted kernels: the hidden
  tensor is rounded to float16 on both sides and a tie may round either
  way, one float16 step (2^-11 of a value) carried through the second
  product: ``REL_F16_KERNEL`` (2e-3, a fifth of bf16's 1e-2 in
  ``tests/test_torch_port_tail.py``);
* whole networks: a float32 sum that lands on the other side of a float16
  rounding boundary moves that operand by one float16 step, and the SFNO
  carries such flips through its layers: ``REL_F16_SFNO``.

Each test states which one it holds, and most also show that the float32
computation misses the JAX float16 result by more, so the comparison sees
the rounding points.
"""

import importlib.util
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spherical_dyffusion_tpu.ops.contractions as jcontractions
import spherical_dyffusion_tpu.ops.sht as jsht
from spherical_dyffusion_tpu.data import SyntheticTimeSeries as JSynthetic
from spherical_dyffusion_tpu.evaluation.aggregators import InferenceAggregator as JAggregator
from spherical_dyffusion_tpu.inference import DataWriter as JDataWriter
from spherical_dyffusion_tpu.inference import DataWriterConfig as JDataWriterConfig
from spherical_dyffusion_tpu.inference.loop import InferenceConfig as JInferenceConfig
from spherical_dyffusion_tpu.inference.loop import run_inference as jrun_inference
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.ops.fused_mlp import fused_block_tail as jax_fused_block_tail
from spherical_dyffusion_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
from spherical_dyffusion_tpu_torch.inference.writers import DataWriter, DataWriterConfig
from spherical_dyffusion_tpu_torch.models.sfno import K4_PAIRS, SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    fused_block_tail,
    fused_mlp,
    weight_image,
    weight_image_plain,
)
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
from spherical_dyffusion_tpu_torch.ops.matmul import as_dtype, einsum
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
from spherical_dyffusion_tpu_torch.training.trainer import TrainerConfig
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F16 = torch.float16
REL_F16_OPERANDS = 1e-6
REL_F16_KERNEL = 2e-3
# the forward FFT's float32 output differs between the frameworks in its
# last bits, so a value near a float16 rounding boundary rounds the other way
# (one float16 step, 2^-11 of it) and moves its terms of the next product
REL_F16_AFTER_FFT = 2e-4
# a port stage or network in float32 misses the JAX float16 result by more
# than this (float16 keeps 11 bits: a relative step of 4.9e-4 per operand)
F32_MISSES_F16 = 1e-5
# measured at embed 16 x 3: 4.6e-4 to 1.2e-3 of the largest output over the
# five SFNO cases
REL_F16_SFNO = 3e-3


def _rel(got, want):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def _rand(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    t = np.asarray(t)
    if np.iscomplexobj(t):
        return np.stack([t.real, t.imag], -1).astype(np.float32)
    return t.astype(np.float32)


class _Float32Dots:
    """``jax.numpy`` whose einsums asked for a float32 result take float16
    (and bf16) operands as float32 values: exact products, float32 sums."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype in (jnp.float16, jnp.bfloat16) else o
                   for o in ops]
        return jnp.einsum(eq, *ops, preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def jax_f16(monkeypatch):
    """The JAX package computes its float16 matmul dtype on the CPU as on an
    accelerator: float16 operands, float32 products and sums."""
    for mod in (jsht, jcontractions):
        monkeypatch.setattr(mod, "_effective_matmul_dtype", lambda requested: requested)
        monkeypatch.setattr(mod, "jnp", _Float32Dots())


# ------------------------------------------------------------ the product

@pytest.mark.parametrize("eq,sa,sb", [
    ("...hwc,wmr->...hmcr", (2, 3, 8, 5), (8, 7, 2)),
    ("...hmcr,hlm->...lmcr", (2, 5, 7, 4, 2), (5, 6, 7)),
    ("...lmcr,hlm->...hmcr", (6, 7, 4, 2), (5, 6, 7)),
    ("bhmcr,mhl->blmcr", (2, 5, 7, 4, 2), (7, 5, 6)),
])
def test_einsum_float16_is_jaxs_float16_dot(eq, sa, sb):
    """``einsum(..., torch.float16)``: both operands rounded to float16, the
    products summed in float32, as ``jnp.einsum`` of float16 operands with
    ``preferred_element_type=float32``; float32 summation order apart
    (``REL_F16_OPERANDS``), and more than ``F32_MISSES_F16`` from the float32
    product."""
    r = np.random.default_rng(1)
    a, b = _rand(r, *sa), _rand(r, *sb)
    want = jnp.einsum(eq, jnp.asarray(a, jnp.float16), jnp.asarray(b, jnp.float16),
                      preferred_element_type=jnp.float32)
    got = einsum(eq, torch.from_numpy(a), torch.from_numpy(b), F16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= REL_F16_OPERANDS
    assert _rel(torch.einsum(eq, torch.from_numpy(a), torch.from_numpy(b)), want) > F32_MISSES_F16
    assert as_dtype("float16") == F16


def test_product16_backward_in_float16(monkeypatch):
    """``ops/matmul.py:Product16`` on float16 operands: its gradients are
    autograd of the CPU form ``torch.bmm(a.float(), b.float())``, bit for
    bit, rounded to float16 (``torch.bmm`` with ``out_dtype`` patched, as the
    CPU has no such call)."""
    from spherical_dyffusion_tpu_torch.ops.matmul import Product16

    real = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: real(
        a.float(), b.float()) if out_dtype is not None else real(a, b))
    r = np.random.default_rng(2)
    a0, b0 = torch.from_numpy(_rand(r, 3, 7, 5)), torch.from_numpy(_rand(r, 3, 5, 4))
    g = torch.from_numpy(_rand(r, 3, 7, 4))
    grads = []
    for form in (lambda a, b: Product16.apply(a, b), lambda a, b: real(a.float(), b.float())):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        a16, b16 = a.to(F16), b.to(F16)
        a16.retain_grad()
        y = form(a16, b16)
        assert y.dtype == torch.float32
        grads.append(torch.autograd.grad(y, (a16, b16), g))
    for x, y in zip(*grads):
        assert x.dtype == F16 and torch.equal(x, y)


# ------------------------------------------------------------ the SHT stages

@pytest.mark.parametrize("io", [None, "float16"])
@pytest.mark.parametrize("inverse", [False, True])
def test_sht_float16_holds_jax_rounding_points(jax_f16, inverse, io):
    """RealSHT / InverseRealSHT with matmul dtype float16, with and without
    the float16 spectral-IO emit, against the JAX package's float16 path;
    the stages compose to the transform."""
    r = np.random.default_rng(3 + inverse)
    grid, shape = "legendre-gauss", (16, 32, 12, 13)
    jdt = None if io is None else jnp.float16
    tdt = None if io is None else F16
    if inverse:
        x = _rand(r, 2, 12, 13, 6, 2)
        j = jsht.InverseRealSHT.create(*shape, grid=grid, matmul_dtype="float16")
        want = j(jnp.asarray(x), out_dtype=jdt)
        port = InverseRealSHT(*shape, grid=grid, matmul_dtype="float16")
        f32 = InverseRealSHT(*shape, grid=grid)(torch.from_numpy(x))
        stages = port.longitude(port.latitude(torch.from_numpy(x), tdt), tdt)
    else:
        x = _rand(r, 2, 16, 32, 6)
        j = jsht.RealSHT.create(*shape, grid=grid, matmul_dtype="float16")
        want = j(jnp.asarray(x), stacked=True, out_dtype=jdt)
        port = RealSHT(*shape, grid=grid, matmul_dtype="float16")
        f32 = RealSHT(*shape, grid=grid)(torch.from_numpy(x))
        stages = port.latitude(port.longitude(torch.from_numpy(x), tdt), tdt)
    got = port(torch.from_numpy(x), out_dtype=tdt)
    assert got.dtype == (torch.float32 if io is None else F16)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    assert _rel(got, want) <= REL_F16_OPERANDS
    assert torch.equal(stages, got)
    assert _rel(f32, want) > F32_MISSES_F16


@pytest.mark.parametrize("fold,lon", [(True, "matmul"), (False, "fft"), (True, "fft")])
def test_sht_options_float16_hold_jax_rounding_points(jax_f16, fold, lon):
    """The folded Legendre stage and the FFT longitude stage in float16, as
    ``tests/test_torch_port_options.py`` holds them in bf16: the forward
    emits its spectral output only, the inverse returns float32; the stages
    compose to the transform."""
    r = np.random.default_rng(6)
    dims, grid = (16, 32, 12, 13), "legendre-gauss"
    x, s = _rand(r, 2, 16, 32, 4), _rand(r, 2, 12, 13, 4, 2)
    kw = dict(grid=grid, matmul_dtype="float16", lon_method=lon, fold_symmetry=fold)
    jf, ji = jsht.RealSHT(*dims, **kw), jsht.InverseRealSHT(*dims, **kw)
    pf, pi = RealSHT(*dims, **kw), InverseRealSHT(*dims, **kw)
    want_f = jf(jnp.asarray(x), stacked=True, out_dtype=jnp.float16)
    want_i = ji(jnp.asarray(s).astype(jnp.float16), out_dtype=jnp.float16)
    assert want_f.dtype == jnp.float16 and want_i.dtype == jnp.float32
    got_f = pf(torch.from_numpy(x), out_dtype=F16)
    got_i = pi(torch.from_numpy(s).to(F16), out_dtype=F16)
    assert got_f.dtype == F16 and got_i.dtype == torch.float32
    tol_f = REL_F16_AFTER_FFT if lon == "fft" else REL_F16_OPERANDS
    assert _rel(got_f, want_f) <= tol_f
    assert _rel(got_i, want_i) <= REL_F16_OPERANDS
    assert torch.equal(pf.latitude(pf.longitude(torch.from_numpy(x), F16), F16), got_f)
    assert torch.equal(pi.longitude(pi.latitude(torch.from_numpy(s).to(F16), F16), F16), got_i)
    f32 = RealSHT(*dims, grid=grid, lon_method=lon, fold_symmetry=fold)(torch.from_numpy(x))
    assert _rel(f32, want_f) > F32_MISSES_F16


@pytest.mark.parametrize("io", [None, "float16"])
def test_contract_dhconv_float16_holds_jax_rounding_points(jax_f16, io):
    """The dense contraction with float16 operands (and the emit) against
    the JAX package's stacked four-GEMM form."""
    r = np.random.default_rng(7)
    L, M, ci, co = 6, 5, 4, 3
    x, w = _rand(r, 2, L, M, ci, 2), _rand(r, ci, co, L, 2)
    jdt, tdt = (None, None) if io is None else (jnp.float16, F16)
    want = jcontractions.contract_dhconv_stacked(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.float16, out_dtype=jdt)
    got = contract_dhconv(torch.from_numpy(x), torch.from_numpy(w), F16, tdt)
    assert got.dtype == (torch.float32 if io is None else F16)
    assert _rel(got, want) <= REL_F16_OPERANDS


# ------------------------------------------------------ K2/K3 plain versions

def _mlp_operands(seed, B=2, H=8, W=16, C=12, Hd=24):
    r = np.random.default_rng(seed)
    return dict(x=_rand(r, B, H, W, C, scale=0.5), a=_rand(r, B, 1, 1, C, scale=0.1) + 1.0,
                c=_rand(r, B, 1, 1, C, scale=0.1), w1=_rand(r, C, Hd, scale=0.2),
                b1=_rand(r, Hd, scale=0.1), w2=_rand(r, Hd, C, scale=0.2),
                b2=_rand(r, C, scale=0.1), res=_rand(r, B, H, W, C))


def _j(o, k):
    return jnp.asarray(o[k])


def _t(o, k):
    return torch.from_numpy(o[k])


@pytest.mark.parametrize("res_dtype", [None, "float32", "float16"])
@pytest.mark.parametrize("exact_gelu", [False, True])
def test_fused_mlp_plain_matches_jax_kernel_float16(res_dtype, exact_gelu):
    """K2's plain version on float16 x against the JAX Pallas kernel in
    interpret mode (tiles of 64 rows over 256), dropout off: the output in
    promote(x, residual) on both sides, within ``REL_F16_KERNEL``; the same
    weights on float32 x miss the float16 result by more than
    ``F32_MISSES_F16``."""
    o = _mlp_operands(11)
    x = o["x"].reshape(-1, 12)
    res = None if res_dtype is None else o["res"].reshape(-1, 12)
    jres = None if res is None else jnp.asarray(res).astype(res_dtype)
    tres = None if res is None else torch.from_numpy(res).to(getattr(torch, res_dtype))
    want = jax_fused_mlp(jnp.asarray(x).astype(jnp.float16), _j(o, "w1"), _j(o, "b1"),
                         _j(o, "w2"), _j(o, "b2"), residual=jres, exact_gelu=exact_gelu,
                         tile_rows=64, interpret=True)
    got = fused_mlp(torch.from_numpy(x).to(F16), _t(o, "w1"), _t(o, "b1"), _t(o, "w2"),
                    _t(o, "b2"), residual=tres, exact_gelu=exact_gelu)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert got.dtype == (torch.float32 if res_dtype == "float32" else F16)
    assert _rel(got, want) <= REL_F16_KERNEL
    f32 = fused_mlp(torch.from_numpy(x), _t(o, "w1"), _t(o, "b1"), _t(o, "w2"), _t(o, "b2"),
                    residual=None if res is None else torch.from_numpy(res),
                    exact_gelu=exact_gelu)
    assert _rel(f32, want) > F32_MISSES_F16


@pytest.mark.parametrize("with_residual", [True, False])
def test_fused_block_tail_plain_matches_jax_kernel_float16(with_residual):
    """K3's plain version on float16 x (the folded input rounded to float16
    before the first product) against the JAX kernel interpreted, B = 2,
    128 rows a sample against tiles of 64: ``REL_F16_KERNEL``."""
    o = _mlp_operands(12)
    res = o["res"] if with_residual else None
    want = jax_fused_block_tail(
        jnp.asarray(o["x"]).astype(jnp.float16), _j(o, "a"), _j(o, "c"), _j(o, "w1"),
        _j(o, "b1"), _j(o, "w2"), _j(o, "b2"), residual=None if res is None else jnp.asarray(res),
        tile_rows=64, interpret=True)
    got = fused_block_tail(
        _t(o, "x").to(F16), _t(o, "a"), _t(o, "c"), _t(o, "w1"), _t(o, "b1"), _t(o, "w2"),
        _t(o, "b2"), residual=None if res is None else torch.from_numpy(res))
    assert got.shape == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel(got, want) <= REL_F16_KERNEL


def test_weight_image_float16_is_the_permutation():
    """The float16 kernels' weight image on the CPU: the plain permutation
    rounded to float16 (the bf16 default unchanged)."""
    r = np.random.default_rng(13)
    w1, w2 = torch.from_numpy(_rand(r, 48, 80)), torch.from_numpy(_rand(r, 80, 32))
    img = weight_image(w1, w2, F16)
    assert img.dtype == F16
    assert torch.equal(img, weight_image_plain(w1, w2).to(F16))
    assert weight_image(w1, w2).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        weight_image(w1, w2, torch.float32)


# ------------------------------------------------------- K4's plain version

def _load_prototype():
    spec = importlib.util.spec_from_file_location(
        "proto_fused_rank", REPO / "scripts" / "proto_fused_rank.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# K4 rounds t and y to float16 where the model path emits them; the
# prototype keeps both in float32 and rounds only its operands (s among
# them): t's rounding moves s, and y's is one float16 step of the output
REL_F16_PROTOTYPE = 2e-3


def test_fused_rank_plain_matches_jax_prototype_float16():
    """fused_rank_plain in float16 against the Pallas prototype's
    fused_kernel at ``dot_dtype`` float16 (interpret mode, through
    make_fused) and its XLA chain ``xla_spectral``, at Mp 4, Hp 16, Lp 16,
    R 4, the port's layout as in ``tests/test_torch_port_rank.py``:
    ``REL_F16_PROTOTYPE``; the float32 plain version misses by more than
    ``F32_MISSES_F16``."""
    proto = _load_prototype()
    Mp, Hp, Lp, R = 4, 16, 16, 4
    r = np.random.default_rng(14)
    A_t, S_t = _rand(r, Mp, Hp, Lp, scale=0.3), _rand(r, Mp, Hp, Lp, scale=0.3)
    xf_p = _rand(r, Mp, Hp, 4 * R)
    cc = _rand(r, Lp, 2 * R, scale=0.5)
    args = [jnp.asarray(a) for a in (A_t, S_t, xf_p, cc)]
    want = np.asarray(proto.make_fused(Mp, Hp, Lp, R, 2, jnp.float16, True)(*args))
    xla = np.asarray(proto.xla_spectral(args[2], args[0], args[1], args[3], R, jnp.float16))

    def to_port(a):  # (m, h, [r][c]) -> (1, h, m, c, r)
        return np.ascontiguousarray(a.reshape(Mp, Hp, 2, 2 * R).transpose(1, 0, 3, 2)[None])

    C = torch.from_numpy(np.stack([cc[:, :R], cc[:, R:]], -1))
    xf = torch.from_numpy(to_port(xf_p))
    got = fused_rank_plain(xf.to(F16), torch.from_numpy(A_t).to(F16),
                           torch.from_numpy(S_t).to(F16), C)
    assert got.shape == (1, Hp, Mp, 2 * R, 2) and got.dtype == F16
    assert _rel(got, to_port(want)) <= REL_F16_PROTOTYPE
    assert _rel(got, to_port(xla)) <= REL_F16_PROTOTYPE
    f32 = fused_rank_plain(xf, torch.from_numpy(A_t), torch.from_numpy(S_t), C)
    assert _rel(f32, to_port(want)) > F32_MISSES_F16


def test_fused_rank_plain_is_jaxs_rank_pipeline_middle_float16(jax_f16):
    """K4's plain version against the JAX package's own three stages at
    ``sht_matmul_dtype`` = ``spectral_io_dtype`` = float16 (the SHT's
    latitude stage with the emit, the CP scale, the inverse SHT's latitude
    stage with the emit), B = 2, on the legendre-gauss grid in the
    transforms' kernel layout: the same products in another lowering, so a
    float16 intermediate may round a tie the other way (``REL_F16_KERNEL``).
    The wrapper computes the plain version on the CPU and counts no
    launch."""
    H, W, L, M, R = 12, 24, 10, 9, 3
    fwd = RealSHT(H, W, L, M, grid="legendre-gauss", matmul_dtype=F16, kernel_layout=True)
    inv = InverseRealSHT(H, W, L, M, grid="legendre-gauss", matmul_dtype=F16,
                         kernel_layout=True)
    jf = jsht.RealSHT.create(H, W, L, M, grid="legendre-gauss", matmul_dtype="float16")
    ji = jsht.InverseRealSHT.create(H, W, L, M, grid="legendre-gauss", matmul_dtype="float16")
    r = np.random.default_rng(15)
    grid = _rand(r, 2, H, W, 2 * R)
    C = _rand(r, L, R, 2)
    xf = fwd.longitude(torch.from_numpy(grid), out_dtype=F16).contiguous()
    jxf = jnp.asarray(_np(xf)).astype(jnp.float16)
    jt = _jax_stage("...hmcr,hlm->...lmcr", jxf, jf.matrix)
    js = jcontractions.cp_spectral_scale_stacked(jt, jnp.asarray(C))
    want = _jax_stage("...lmcr,hlm->...hmcr", js, ji.matrix)
    got = fused_rank_plain(xf, fwd.analysis_mhl, inv.synthesis_mhl, torch.from_numpy(C))
    assert got.dtype == F16 and got.shape == xf.shape
    assert _rel(got, want) <= REL_F16_KERNEL
    before = fused_rank.launches
    assert torch.equal(fused_rank(xf, fwd.analysis_mhl, inv.synthesis_mhl,
                                  torch.from_numpy(C)), got)
    assert fused_rank.launches == before


def _jax_stage(eq, x, matrix):
    """A Legendre stage of the JAX transforms (``ops/sht.py``) at matmul and
    spectral-IO dtype float16: both operands rounded to float16, float32
    sums (the float16 values multiplied as float32, exact), the output
    emitted in float16."""
    def f16(a):
        return a.astype(jnp.float16).astype(jnp.float32)

    return jnp.einsum(eq, f16(x), f16(matrix),
                      preferred_element_type=jnp.float32).astype(jnp.float16)


# ------------------------------------------------------------ the SFNO

def _sfno_kw(**kw):
    base = dict(img_shape=(16, 32), in_chans=7, out_chans=5, embed_dim=16, num_layers=3,
                operator_type="dhconv", with_time_emb=True, dropout_mlp=0.1,
                drop_path_rate=0.1, min_time=1, max_time=5, compute_dtype="float16")
    base.update(kw)
    return base


def _sfno_inputs(seed):
    r = np.random.default_rng(seed)
    return _rand(r, 2, 16, 32, 5), _rand(r, 2, 16, 32, 2), np.asarray([1.0, 3.5], np.float32)


def _jax_sfno(kw, seed):
    """The JAX SFNO's variables (a jitted init) and its forward."""
    x, cond, t = _sfno_inputs(seed)
    model = JSFNO(JSFNOConfig(**kw))
    args = (jnp.asarray(x),)
    kwargs = dict(time=jnp.asarray(t), static_condition=jnp.asarray(cond))
    variables = jax.jit(lambda k: model.init(k, *args, **kwargs))(jax.random.PRNGKey(seed))
    return variables, np.asarray(model.apply(variables, *args, **kwargs), np.float32)


def _port_sfno(kw, variables, seed, fused_rank=False):
    x, cond, t = _sfno_inputs(seed)
    model = SFNO(SFNOConfig(**kw), fused_rank=fused_rank)
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        y = model(torch.from_numpy(x), time=torch.from_numpy(t),
                  static_condition=torch.from_numpy(cond))
    return _np(y), model


SFNO_CASES = {
    # Dense layers in float16; the transforms and the contraction in float32
    "compute": dict(),
    # and the transforms' and contraction's operands in float16
    "compute and matmul": dict(sht_matmul_dtype="float16"),
    # and every spectral stage emitted in float16 (the stacked path)
    "spectral io": dict(sht_matmul_dtype="float16", spectral_io_dtype="float16"),
    # the CP rank pipeline in the middle block, through K4's plain version
    "cp K4": dict(factorization="cp", rank=0.25, hard_thresholding_fraction=0.8,
                  sht_matmul_dtype="float16", spectral_io_dtype="float16"),
    # K1 and K3 (JAX: its Pallas kernels interpreted)
    "fused tail K1": dict(use_pallas=True, fused_tail=True, sht_matmul_dtype="float16",
                          time_scale_shift_before_filter=False),
}


@pytest.mark.parametrize("name", list(SFNO_CASES))
def test_sfno_float16_matches_jax(jax_f16, name):
    """SFNO forwards at ``compute_dtype="float16"`` (embed 16 x 3 layers, 16
    x 32, dropout configured but off) against the JAX package's with the
    same weights: ``REL_F16_SFNO`` of the largest output; the port's
    network with float32 compute misses the JAX float16 forward by more
    than ``F32_MISSES_F16``. Every block returns float32 (the float32 time
    scale-shift promotes the residual stream), as in JAX."""
    kw = _sfno_kw(**SFNO_CASES[name])
    variables, want = _jax_sfno(kw, seed=5)
    got, model = _port_sfno(kw, variables, seed=5, fused_rank=name == "cp K4")
    assert got.shape == want.shape == (2, 16, 32, 5)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= REL_F16_SFNO
    if name == "cp K4":
        assert [b.filter.fused_rank for b in model.blocks] == [False, True, False]
    f32 = dict(kw, compute_dtype="float32", sht_matmul_dtype="float32", spectral_io_dtype="")
    assert _rel(_port_sfno(f32, variables, seed=5)[0], want) > F32_MISSES_F16


def test_float16_config_and_k4_pairs():
    """``SFNOConfig`` takes float16 for the compute, matmul and spectral-IO
    dtypes; K4 has instances for (float32, none), (bf16, bf16) and (float16,
    float16) and raises on a mix, as for bf16
    (``tests/test_torch_port_rank.py``)."""
    assert K4_PAIRS == ((torch.float32, None), (torch.bfloat16, torch.bfloat16), (F16, F16))
    cp = dict(factorization="cp", rank=0.25, hard_thresholding_fraction=0.8)
    SFNO(SFNOConfig(**_sfno_kw(**cp, sht_matmul_dtype="float16", spectral_io_dtype="float16")),
         fused_rank=True)
    for md, io in (("float16", ""), ("float16", "bfloat16"), ("bfloat16", "float16"),
                   ("float32", "float16")):
        with pytest.raises(NotImplementedError, match="fused_rank"):
            SFNO(SFNOConfig(**_sfno_kw(**cp, sht_matmul_dtype=md, spectral_io_dtype=io)),
                 fused_rank=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        SFNOConfig(compute_dtype="float64")
    with pytest.raises(NotImplementedError, match="sht_matmul_dtype"):
        SFNOConfig(sht_matmul_dtype="float64")


def test_main_path_float16_builds():
    """``main_path.build(dtype="float16")`` sets float16 compute and matmul
    dtypes in both networks; ``FAST_WINDOW_F16`` adds float16 spectral IO
    and K4's float16 route in the middle blocks."""
    st = main_path.build(embed=16, layers=3, dtype="float16", img_shape=(16, 32), n_state=5,
                         horizon=3, device="cpu", **main_path.FAST_WINDOW_F16)
    for net in (st.exp.model, st.exp.interpolator.model):
        cfg = net.cfg
        assert (cfg.compute_dtype, cfg.sht_matmul_dtype, cfg.spectral_io_dtype) == (
            "float16", "float16", "float16")
        assert [b.filter.fused_rank for b in net.blocks] == [False, True, False]
    assert main_path.FAST_WINDOW_F16 == dict(main_path.FAST_WINDOW, spectral_io="float16")


# ------------------------------------------------------ the fused-tail window

def test_fused_tail_window_float16_matches_jax(jax_f16):
    """The fused-tail window (K1 and K3, horizon 6, 12 steps, peeled, 3
    layers, dropout off) at ``dtype="float16"`` (compute and the transforms'
    operands) against the JAX stepper with K3 interpreted, the same weights:
    within ``F16_WINDOW_VS_JAX`` of the largest prediction; and the port's
    fused tail against its plain path in float16 within
    ``F16_TAIL_VS_PLAIN`` times the plain path's own float16 error (against
    float32), as ``chip_smoke.py`` holds the full-size windows."""
    from test_torch_port_tail import GRID, N_STATE, TAIL, _jax_stepper, _port_window

    horizon, n_steps = 6, 12
    jstep, params = _jax_stepper(horizon, "float16")
    inp = main_path.window_inputs(n_steps, GRID, N_STATE, seed=horizon, device="cpu")
    _, jpreds = jstep.run_window(
        jnp.asarray(inp["x0"].numpy()), jnp.asarray(inp["forcing"].numpy()),
        jnp.asarray(inp["sst"].numpy()), jnp.asarray(inp["mask"].numpy()),
        jax.random.PRNGKey(0), n_steps)
    tail, _ = _port_window(params, horizon, n_steps, inp, "float16", **TAIL)
    assert tail.shape == (1, n_steps) + GRID + (N_STATE,)
    assert np.isfinite(tail).all()
    assert _rel(tail, jpreds) <= F16_WINDOW_VS_JAX
    plain = {dt: _port_window(params, horizon, n_steps, inp, dt, use_pallas=False,
                              fused_mlp=False)[0] for dt in ("float16", "float32")}
    gap = np.abs(tail - plain["float16"]).max()
    noise = np.abs(plain["float16"] - plain["float32"]).max()
    assert 0 < gap <= F16_TAIL_VS_PLAIN * noise, (gap, noise)


# a 12-step window compounds the SFNO's float16 flips over 24 network calls
F16_WINDOW_VS_JAX = 1e-2
F16_TAIL_VS_PLAIN = 2.0


# ------------------------------------------ float16 predictions and the writer

@pytest.fixture(scope="module")
def models():
    from test_torch_port_inference import models as fixture

    return fixture.__wrapped__()


def test_params_and_preds_dtype_float16_match_jax(models, tmp_path):
    """``params_dtype`` and ``preds_dtype`` "float16", as JAX's stepper takes
    them: every floating weight holds a float16 value (stored in float32);
    the emitted predictions are float16, summed in float32 by the
    aggregator, whose logs agree with JAX's within 1e-5 (both sides reduce
    the same float16 values); the writer's file holds them as float32, equal
    to JAX's file. The hand-off state stays float32."""
    from test_torch_port_inference import (
        FORCING,
        GRID,
        MASK,
        N_STATE,
        NAMES,
        _assert_logs_close,
        _jax_stepper,
        _port_stepper,
    )

    opts = dict(params_dtype="float16", preds_dtype="float16")
    cfg = dict(n_forward_steps=6, forward_steps_in_memory=3, n_repeats=2)
    jst, tst = _jax_stepper(models, **opts), _port_stepper(models, **opts)
    for net in (tst.exp.model, tst.exp.interpolator.model):
        for t in (*net.parameters(), *net.buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32
                assert torch.equal(t, t.to(F16).float())
    logs, files = {}, {}
    for side, st in (("jax", jst), ("port", tst)):
        out = tmp_path / side
        src = (JSynthetic if side == "jax" else SyntheticTimeSeries)(
            NAMES + FORCING + [MASK], n_timesteps=6, spatial_shape=GRID)
        writer = (JDataWriter(JDataWriterConfig(save_prediction_files=True), str(out), NAMES,
                              src.horizontal.lat, src.horizontal.lon, 1)
                  if side == "jax" else
                  DataWriter(DataWriterConfig(save_prediction_files=True), str(out), NAMES,
                             src.horizontal.lat, src.horizontal.lon, 1))
        agg = (JAggregator if side == "jax" else InferenceAggregator)(
            NAMES, src.horizontal.area_weights())
        run = jrun_inference if side == "jax" else run_inference
        icfg = (JInferenceConfig if side == "jax" else InferenceConfig)(**cfg)
        run(st, src, icfg, aggregator=agg, writer=writer, mask_name=MASK, verbose=False)
        writer.close()
        logs[side] = agg.get_logs()
        with h5py.File(out / "autoregressive_predictions.nc", "r") as f:
            files[side] = {n: (f[n].dtype, f[n][()]) for n in NAMES}
    _assert_logs_close(logs["port"], logs["jax"], 1e-5)
    for n in NAMES:
        (gd, got), (wd, want) = files["port"][n], files["jax"][n]
        assert gd == wd == np.float32 and got.shape == want.shape == (1, 6) + GRID
        assert np.array_equal(got, got.astype(np.float16).astype(np.float32))
        assert _rel(got, want) <= 1e-3
    inp = main_path.window_inputs(3, GRID, N_STATE, seed=3, device="cpu")
    args = (inp["x0"], inp["forcing"], inp["sst"], inp["mask"])
    x16, p16 = tst.run_window(*args, torch.Generator().manual_seed(0), 3)
    assert p16.dtype == F16 and x16.dtype == torch.float32


def test_float16_targets_and_adam_moment_stay_refused():
    """float16 reaches the networks and the emitted predictions only:
    ``targets_dtype="float16"`` raises (the JAX loop reads every name other
    than "float32" as bf16; the port's check is a recorded departure) and so
    does ``adam_mu_dtype="float16"`` (the port stores Adam's first moment in
    float32 or bf16)."""
    with pytest.raises(ValueError, match="targets_dtype"):
        InferenceConfig(targets_dtype="float16")
    with pytest.raises(NotImplementedError, match="adam_mu_dtype"):
        TrainerConfig(adam_mu_dtype="float16")


# ------------------------------------------------- one float16 training step

@pytest.mark.parametrize("kind", ["interp", "forecast"])
def test_float16_compute_train_step_matches_jax(pin_t, jax_f16, kind):
    """``compute_dtype`` and ``sht_matmul_dtype`` float16 with K1 asked for
    (its forward, dx and dW stay float32 on both sides), one step's loss and
    gradients against JAX's ``value_and_grad`` of the same step, as the bf16
    step is held in ``tests/test_torch_port_train_modes.py``: the loss within
    ``F16_LOSS_REL``, every gradient float32 and within ``F16_GRAD_REL`` of
    the network's largest gradient entry; the port's float32 step of the
    same weights moves some gradient by more than ``F32_VS_F16`` of it, so
    the float16 path is the one compared."""
    from test_torch_port_train_modes import _build, _jax_loss_and_grads, _port_loss_and_grads

    pin_t((1, 2))
    f16 = dict(compute_dtype="float16", sht_matmul_dtype="float16", use_pallas=True)
    jside, tside = _build(n_timesteps=6, batch_size=2, **f16)
    jdm = jside["dm"]
    b = next(iter(jdm.train_batches(seed=0)))
    dyn = np.array(jdm.normalizer.normalize(jnp.asarray(b["dynamics"])))
    cond = np.array(b["dynamical_condition"])
    jl, jg = _jax_loss_and_grads(jside, kind, dyn, cond)
    tl, tg = _port_loss_and_grads(tside[kind], dyn, cond)
    assert np.isfinite(tl) and abs(tl - jl) <= F16_LOSS_REL * abs(jl)
    top = max(float(np.abs(v).max()) for v in jg.values())
    assert set(tg) == set(jg)
    for n, g in tg.items():
        assert g.dtype == torch.float32
        err = float(np.abs(g.numpy() - jg[n]).max())
        assert err <= F16_GRAD_REL * top, f"{n}: {err:.3g} vs {F16_GRAD_REL} x {top:.3g}"
    _, g32 = _port_loss_and_grads(_build(n_timesteps=6, batch_size=2, use_pallas=True)[1][kind],
                                  dyn, cond)
    assert max(float((g32[n] - g).abs().max()) for n, g in tg.items()) > F32_VS_F16 * top


# each float16 rounding point is the same in both packages, but a float32
# sum that lands on the other side of a float16 boundary moves that value by
# one float16 step, forward and backward; measured at this size: the
# gradients within 1.8e-3 (interpolator) and 4.0e-3
# (forecaster, whose loss runs the frozen interpolator too) of the largest
# entry, under the bound that the bf16 step is held to
F16_LOSS_REL = 1e-5
F16_GRAD_REL = 1e-2
F32_VS_F16 = 1e-5


@pytest.fixture
def pin_t(monkeypatch):
    from test_torch_port_train_modes import pin_t as fixture

    return fixture.__wrapped__(monkeypatch)


# ------------------------------------------------------- ACE in float16

def test_ace_window_float16_matches_jax(jax_f16):
    """ACE's single-step stepper (``main_path.build_ace``'s configuration at
    16 x 32, embed 8 x 2 layers) at ``dtype="float16"`` (compute and the
    transforms' operands) through K1 and K3 (JAX's interpreted), a window
    of ``ACE_F16_STEPS`` steps with the dry-air corrector and the
    prescribed ocean, against JAX's ACE stepper in float16 with the same
    weights: each generated field (normalized, the steps after the initial
    state) within ``F16_WINDOW_VS_JAX`` of its largest value, as the
    float16 DYffusion window is held (measured: 1.7e-3 at most); the port's
    float32 window misses JAX's float16 one by more than
    ``F32_MISSES_F16`` of some field's largest value. At this size, where
    the untrained network's outputs are about 0.02, a float32 sum that
    lands on the other side of a float16 boundary moves them about as far
    as float32 compute does (measured 3.0e-3 at most), so the rule bounds
    the float16 window and does not tell the two apart."""
    from test_torch_port_ace import _stepper_pair, _window

    jstep, stepper, all_names = _stepper_pair(True, "float16")
    data = _window(all_names, ACE_F16_STEPS, seed=3)
    want = jstep.run_on_batch(data, ACE_F16_STEPS)
    got = stepper.run_on_batch(data, ACE_F16_STEPS)
    names = list(stepper.cfg.out_names)
    jgen = {n: _np(want.gen_data_norm[n])[:, 1:] for n in names}
    for n in names:
        g = _np(got.gen_data_norm[n])[:, 1:]
        assert np.isfinite(g).all()
        assert _rel(g, jgen[n]) <= F16_WINDOW_VS_JAX, n
    f32 = main_path.build_ace(embed=8, layers=2, dtype="float32", img_shape=(16, 32),
                              levels=3, n_other=2, kernels=True, device="cpu")
    f32.module.load_state_dict(stepper.module.state_dict())
    out32 = f32.run_on_batch(data, ACE_F16_STEPS)
    assert max(_rel(_np(out32.gen_data_norm[n])[:, 1:], jgen[n]) for n in names) > F32_MISSES_F16


ACE_F16_STEPS = 3


def test_simultaneous_float16_train_step_matches_jax(jax_f16):
    """The simultaneous forecaster (horizon 2, ``horizon_at_once`` 1: two
    autoregressive steps) with ``compute_dtype`` and ``sht_matmul_dtype``
    float16 and K1 asked for (float32 on both sides), one step's loss and
    gradients against JAX's ``value_and_grad`` of the same loss, with the
    rule of ``test_float16_compute_train_step_matches_jax`` (which holds the
    interpolation and forecasting experiments, not this one): the loss
    within ``F16_LOSS_REL``, every gradient float32 and within
    ``F16_GRAD_REL`` of the network's largest gradient entry; the port's
    float32 step moves some gradient by more than ``F32_VS_F16`` of it."""
    from test_torch_port_ace_cli import _batch, _cfg, _pair

    from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict as to_sd

    def losses_and_grads(cfg):
        jexp, v, exp, jdm, _ = _pair(cfg)
        dyn, cond = _batch(jdm)
        consts = {k: x for k, x in v.items() if k != "params"}

        def jloss(p):
            return jexp.train_loss({**consts, "params": p}, jnp.asarray(dyn),
                                   jax.random.PRNGKey(0),
                                   dynamical_condition=jnp.asarray(cond))[0]

        jl, jg = jax.value_and_grad(jloss)(v["params"])
        loss, _ = exp.train_loss(torch.tensor(dyn), torch.Generator().manual_seed(0),
                                 dynamical_condition=torch.tensor(cond))
        names = [n for n, _ in exp.model.named_parameters()]
        grads = torch.autograd.grad(loss, list(exp.model.parameters()))
        return (float(jl), {k: x.numpy() for k, x in to_sd({"params": jg}).items()},
                float(loss.detach()), dict(zip(names, grads)))

    cfg = _cfg(horizon=2, hao=1)
    cfg["model"].update(compute_dtype="float16", sht_matmul_dtype="float16")
    jl, jg, tl, tg = losses_and_grads(cfg)
    assert np.isfinite(tl) and abs(tl - jl) <= F16_LOSS_REL * abs(jl)
    top = max(float(np.abs(v).max()) for v in jg.values())
    assert set(tg) == set(jg)
    for n, g in tg.items():
        assert g.dtype == torch.float32
        err = float(np.abs(g.numpy() - jg[n]).max())
        assert err <= F16_GRAD_REL * top, f"{n}: {err:.3g} vs {F16_GRAD_REL} x {top:.3g}"
    _, _, _, g32 = losses_and_grads(_cfg(horizon=2, hao=1))
    assert max(float((g32[n] - g).abs().max()) for n, g in tg.items()) > F32_VS_F16 * top
