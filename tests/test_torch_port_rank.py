"""Parity of the port's CP rank pipeline, bf16 transforms and dropout edges
with the JAX package, on the CPU.

The same numpy inputs and weights go through the JAX package and the port.
float32 results agree to a few float32 ulps of their largest magnitude.

bf16 operands (``sht_matmul_dtype``/``spectral_io_dtype`` = bfloat16): on
the CPU the JAX package resolves a bf16 matmul dtype to float32
(``_effective_matmul_dtype`` in ``ops/sht.py`` and ``ops/contractions.py``),
because older XLA-CPU builds had no bf16 x bf16 -> float32 dot. The XLA of
this JAX does have it, so the ``jax_bf16`` fixture lifts that fallback for
one test (monkeypatch; the JAX package's files stay as they are), and the
JAX package then rounds on the CPU where it rounds on the TPU. The port's
bf16 stages are held to those rounding points within float32
summation-order error, and a port stage in float32 is shown to miss them by
far more.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import spherical_dyffusion_tpu.ops.contractions as jcontractions
import spherical_dyffusion_tpu.ops.sht as jsht
from spherical_dyffusion_tpu.data.normalization import StandardNormalizer as JNormalizer
from spherical_dyffusion_tpu.data.packer import Packer as JPacker
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JConfig
from spherical_dyffusion_tpu.inference.prescriber import PrescriberConfig as JPrescriberConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.models.modules import QuantizedDropout as JQuantizedDropout
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import (
    InterpolationExperiment as JInterpolation,
)
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.models.modules import MLP2d, QuantizedDropout
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.contractions import (
    contract_dhconv,
    contract_dhconv_cp,
    cp_spatial_expand,
    cp_spatial_project,
    cp_spectral_scale_stacked,
)
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
from spherical_dyffusion_tpu_torch.ops.matmul import einsum
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
# float32 results: a few float32 ulps of the largest magnitude
REL = 1e-5
# bf16 operands, float32 sums in another order: the rounded operands are
# equal on both sides, so only the order of the float32 sums differs
REL_BF16_OPERANDS = 1e-6
# a port stage in float32 against the JAX stage in bf16 must miss by more
# than this (bf16 keeps 8 bits: a relative step of 4e-3 per operand)
F32_MISSES_BF16 = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rand(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_values(a):
    """a rounded to bf16, as float32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package computes its bf16 matmul dtype on the CPU as on the
    TPU: bf16 operands, float32 products and sums."""
    monkeypatch.setattr(jsht, "_effective_matmul_dtype", lambda requested: requested)
    monkeypatch.setattr(jcontractions, "_effective_matmul_dtype", lambda requested: requested)


# ------------------------------------------------------ F1: bf16 transforms

@pytest.mark.parametrize("io", [None, "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
def test_sht_bf16_holds_jax_rounding_points(jax_bf16, inverse, io):
    """RealSHT / InverseRealSHT with matmul dtype bf16, with and without the
    spectral-IO emit, against the JAX package's bf16 path (round x and the
    DFT matrix, float32 sums, emit, round for the Legendre product, float32
    sums, emit); the stages compose to the transform."""
    r = np.random.default_rng(1 + inverse)
    grid, shape = "legendre-gauss", (16, 32, 12, 13)
    jdt = None if io is None else jnp.bfloat16
    tdt = None if io is None else BF16
    if inverse:
        x = _rand(r, 2, 12, 13, 6, 2)
        j = jsht.InverseRealSHT.create(*shape, grid=grid, matmul_dtype="bfloat16")
        want = _np(j(jnp.asarray(x), out_dtype=jdt).astype(jnp.float32))
        port = InverseRealSHT(*shape, grid=grid, matmul_dtype="bfloat16")
        f32 = InverseRealSHT(*shape, grid=grid)(torch.from_numpy(x))
        stages = port.longitude(port.latitude(torch.from_numpy(x), tdt), tdt)
    else:
        x = _rand(r, 2, 16, 32, 6)
        j = jsht.RealSHT.create(*shape, grid=grid, matmul_dtype="bfloat16")
        want = _np(j(jnp.asarray(x), stacked=True, out_dtype=jdt).astype(jnp.float32))
        port = RealSHT(*shape, grid=grid, matmul_dtype="bfloat16")
        f32 = RealSHT(*shape, grid=grid)(torch.from_numpy(x))
        stages = port.latitude(port.longitude(torch.from_numpy(x), tdt), tdt)
    got = port(torch.from_numpy(x), out_dtype=tdt)
    assert got.dtype == (torch.float32 if io is None else BF16)
    assert _rel(_np(got), want) <= REL_BF16_OPERANDS
    assert torch.equal(stages, got)
    assert _rel(_np(f32), want) > F32_MISSES_BF16


@pytest.mark.parametrize("io", [None, "bfloat16"])
def test_contract_dhconv_bf16_holds_jax_rounding_points(jax_bf16, io):
    """The dense contraction with bf16 operands against the JAX package's
    stacked four-GEMM form (with the emit) and, without the emit, against
    its float32 complex form fed the bf16-rounded operands."""
    r = np.random.default_rng(3)
    x, w = _rand(r, 2, 6, 7, 5, 2), _rand(r, 5, 4, 6, 2, scale=0.3)
    jdt, tdt = (None, None) if io is None else (jnp.bfloat16, BF16)
    got = contract_dhconv(torch.from_numpy(x), torch.from_numpy(w), BF16, tdt)
    want = jcontractions.contract_dhconv_stacked4(jnp.asarray(x), jnp.asarray(w),
                                                  matmul_dtype=jnp.bfloat16, out_dtype=jdt)
    assert _rel(_np(got), _np(want.astype(jnp.float32))) <= REL_BF16_OPERANDS
    f32 = contract_dhconv(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(_np(f32), _np(want.astype(jnp.float32))) > F32_MISSES_BF16
    if io is None:
        xc = jnp.asarray(_bf16_values(x[..., 0])) + 1j * jnp.asarray(_bf16_values(x[..., 1]))
        wc = jcontractions.contract_dhconv(xc, jnp.asarray(_bf16_values(w)))
        assert _rel(_np(got), np.stack([np.real(wc), np.imag(wc)], -1)) <= REL_BF16_OPERANDS


# ------------------------------------------------------- the CP functions

def _cp_operands(seed, ci=8, co=6, R=3, L=5, M=4, H=5, W=7):
    r = np.random.default_rng(seed)
    return dict(A=_rand(r, ci, R, 2), B=_rand(r, co, R, 2), C=_rand(r, L, R, 2),
                xs=_rand(r, 2, L, M, ci, 2), grid=_rand(r, 2, H, W, ci),
                zs=_rand(r, 2, L, M, 2 * R, 2), g=_rand(r, 2, H, W, 2 * R))


def test_cp_functions_match_jax_float32():
    """contract_dhconv_cp and the three rank-pipeline stages in float32."""
    o = _cp_operands(4)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    xc = jnp.asarray(o["xs"][..., 0]) + 1j * jnp.asarray(o["xs"][..., 1])
    yc = jcontractions.contract_dhconv_cp(xc, {k: jnp.asarray(o[k]) for k in "ABC"})
    got = contract_dhconv_cp(t["xs"], {k: t[k] for k in "ABC"})
    assert got.shape == (2, 5, 4, 6, 2)
    assert _rel(_np(got), np.stack([np.real(yc), np.imag(yc)], -1)) <= REL
    pairs = [
        (cp_spatial_project(t["grid"], t["A"]),
         jcontractions.cp_spatial_project(jnp.asarray(o["grid"]), jnp.asarray(o["A"]))),
        (cp_spectral_scale_stacked(t["zs"], t["C"]),
         jcontractions.cp_spectral_scale_stacked(jnp.asarray(o["zs"]), jnp.asarray(o["C"]))),
        (cp_spatial_expand(t["g"], t["B"]),
         jcontractions.cp_spatial_expand(jnp.asarray(o["g"]), jnp.asarray(o["B"]))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(_np(got), _np(want)) <= REL


@pytest.mark.parametrize("io", [None, "bfloat16"])
def test_cp_stages_bf16_hold_jax_rounding_points(jax_bf16, io):
    """The rank-pipeline stages with bf16 operands and the spectral-IO emit
    against the JAX package's bf16 path; the scale, which JAX computes from
    the emitted bf16 spectrum, in float32 on both sides; contract_dhconv_cp
    (which rounds the scaled rank spectrum for its second product) too."""
    o = _cp_operands(5)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    jdt, tdt = (None, None) if io is None else (jnp.bfloat16, BF16)
    bf = jnp.bfloat16
    for got, want, f32 in [
        (cp_spatial_project(t["grid"], t["A"], BF16, tdt),
         jcontractions.cp_spatial_project(jnp.asarray(o["grid"]), jnp.asarray(o["A"]), bf, jdt),
         cp_spatial_project(t["grid"], t["A"])),
        (cp_spatial_expand(t["g"], t["B"], BF16, tdt),
         jcontractions.cp_spatial_expand(jnp.asarray(o["g"]), jnp.asarray(o["B"]), bf, jdt),
         cp_spatial_expand(t["g"], t["B"])),
    ]:
        assert got.dtype == (torch.float32 if io is None else BF16)
        assert _rel(_np(got), _np(want.astype(jnp.float32))) <= REL_BF16_OPERANDS
        assert _rel(_np(f32), _np(want.astype(jnp.float32))) > F32_MISSES_BF16
    zs = t["zs"].to(BF16)
    got = cp_spectral_scale_stacked(zs, t["C"])
    want = jcontractions.cp_spectral_scale_stacked(jnp.asarray(_np(zs)), jnp.asarray(o["C"]))
    assert got.dtype == torch.float32 and _rel(_np(got), _np(want)) <= REL_BF16_OPERANDS
    xc = jnp.asarray(o["xs"][..., 0]) + 1j * jnp.asarray(o["xs"][..., 1])
    yc = jcontractions.contract_dhconv_cp(xc, {k: jnp.asarray(o[k]) for k in "ABC"},
                                          matmul_dtype=bf)
    got = contract_dhconv_cp(t["xs"], {k: t[k] for k in "ABC"}, BF16)
    assert _rel(_np(got), np.stack([np.real(yc), np.imag(yc)], -1)) <= REL_BF16_OPERANDS


def test_einsum_lowering_matches_torch_einsum():
    """The hand lowering of ops/matmul.py (the card's bf16 route) on the
    equations the port uses, ellipsis on either operand, against
    torch.einsum of the same bf16-rounded operands."""
    r = np.random.default_rng(6)
    cases = [("...hwc,wmr->...hmcr", (2, 3, 4, 5), (4, 7, 2)),
             ("...hmcr,hlm->...lmcr", (2, 5, 7, 4, 2), (5, 6, 7)),
             ("...lmcr,hlm->...hmcr", (6, 7, 4, 2), (5, 6, 7)),
             ("...lmi,iol->...lmo", (3, 6, 7, 4), (4, 5, 6)),
             ("bhmcr,mhl->blmcr", (2, 5, 7, 4, 2), (7, 5, 6)),
             ("...hwr,ro->...hwo", (5, 7, 4), (4, 3))]
    for eq, sa, sb in cases:
        a, b = torch.from_numpy(_rand(r, *sa)), torch.from_numpy(_rand(r, *sb))
        want = torch.einsum(eq, a.to(BF16).float(), b.to(BF16).float())
        got = einsum(eq, a, b, BF16)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- K4's plain version

def _load_prototype():
    spec = importlib.util.spec_from_file_location(
        "proto_fused_rank", REPO / "scripts" / "proto_fused_rank.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fused_rank_plain_matches_jax_prototype():
    """fused_rank_plain against the Pallas prototype's fused_kernel
    (interpret mode, through make_fused) and its XLA chain xla_spectral, in
    float32, at Mp 4, Hp 16, Lp 16, R 4. The prototype's (m, h, 4R) columns
    [Sr_re | Si_re | Sr_im | Si_im] are the port's (h, m, 2R, (re, im))
    with the last two axes swapped; its cc (l, 2R) is [Cr | Ci]. 1e-5 of
    the largest output."""
    proto = _load_prototype()
    Mp, Hp, Lp, R = 4, 16, 16, 4
    r = np.random.default_rng(7)
    A_t, S_t = _rand(r, Mp, Hp, Lp, scale=0.3), _rand(r, Mp, Hp, Lp, scale=0.3)
    xf_p = _rand(r, Mp, Hp, 4 * R)
    cc = _rand(r, Lp, 2 * R, scale=0.5)
    fused = proto.make_fused(Mp, Hp, Lp, R, 2, jnp.float32, True)
    want = np.asarray(fused(jnp.asarray(A_t), jnp.asarray(S_t), jnp.asarray(xf_p),
                            jnp.asarray(cc)))
    xla = np.asarray(proto.xla_spectral(jnp.asarray(xf_p), jnp.asarray(A_t), jnp.asarray(S_t),
                                        jnp.asarray(cc), R, jnp.float32))

    def to_port(a):  # (m, h, [r][c]) -> (1, h, m, c, r)
        return a.reshape(Mp, Hp, 2, 2 * R).transpose(1, 0, 3, 2)[None]

    C = np.stack([cc[:, :R], cc[:, R:]], -1)
    got = fused_rank_plain(torch.from_numpy(np.ascontiguousarray(to_port(xf_p))),
                           torch.from_numpy(A_t), torch.from_numpy(S_t), torch.from_numpy(C))
    assert got.shape == (1, Hp, Mp, 2 * R, 2) and got.dtype == torch.float32
    assert _rel(_np(got), to_port(want)) <= REL
    assert _rel(_np(got), to_port(xla)) <= REL


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_fused_rank_plain_is_the_rank_pipeline_middle(dtype):
    """K4's plain version against the model's three separate stages (the
    SHT's latitude stage with the emit, the CP scale, the inverse SHT's
    latitude stage), B = 2, in float32 and with bf16 matmul dtype and
    spectral IO; the matrices in the transforms' kernel layout. The wrapper
    computes the plain version on the CPU and counts no launch. float32:
    1e-5 of the largest output; bf16: the same products in another
    lowering, so a bf16 intermediate may round a tie the other way, which
    moves an output by about one bf16 ulp of a product: 1e-2 of the largest
    output."""
    H, W, L, M, R = 12, 24, 10, 9, 3
    io = None if dtype == torch.float32 else BF16
    fwd = RealSHT(H, W, L, M, grid="legendre-gauss", matmul_dtype=dtype, kernel_layout=True)
    inv = InverseRealSHT(H, W, L, M, grid="legendre-gauss", matmul_dtype=dtype,
                         kernel_layout=True)
    assert fwd.analysis_mhl.shape == inv.synthesis_mhl.shape == (M, H, L)
    assert fwd.analysis_mhl.dtype == dtype
    r = np.random.default_rng(8)
    xf = fwd.longitude(torch.from_numpy(_rand(r, 2, H, W, 2 * R)), out_dtype=io).contiguous()
    C = torch.from_numpy(_rand(r, L, R, 2))
    want = inv.latitude(cp_spectral_scale_stacked(fwd.latitude(xf, io), C), io)
    got = fused_rank_plain(xf, fwd.analysis_mhl, inv.synthesis_mhl, C)
    assert got.dtype == dtype and got.shape == xf.shape
    assert _rel(_np(got), _np(want)) <= (REL if io is None else 1e-2)
    before = fused_rank.launches
    assert torch.equal(fused_rank(xf, fwd.analysis_mhl, inv.synthesis_mhl, C), got)
    assert fused_rank.launches == before


# ------------------------------------------------------------- the CP SFNO

def _cp_kwargs(**kw):
    base = dict(img_shape=(16, 32), in_chans=7, out_chans=5, embed_dim=16, num_layers=3,
                operator_type="dhconv", with_time_emb=True, dropout_mlp=0.1,
                drop_path_rate=0.1, min_time=1, max_time=5, factorization="cp", rank=0.25,
                hard_thresholding_fraction=0.8)
    base.update(kw)
    return base


def _sfno_inputs(seed, B=2, C=5, CF=2, shape=(16, 32), times=(1.0, 3.5)):
    r = np.random.default_rng(seed)
    return (_rand(r, B, *shape, C), _rand(r, B, *shape, CF),
            np.asarray(times[:B], np.float32))


@pytest.mark.parametrize("scan_layers,fused_rank_on", [(True, True), (True, False),
                                                       (False, True)])
def test_cp_sfno_matches_jax(scan_layers, fused_rank_on):
    """SFNO(factorization="cp", rank=0.25, thresholding 0.8) at embed 16 x 3
    layers, float32: the middle block takes the rank pipeline (R = 4,
    2R <= 16) and the two grid-changing end blocks the spectral-space CP
    contraction, as in the JAX package; the flax CP names load by renaming,
    from the stacked (blocks_mid/block) and the unrolled layout; the K4
    route (its plain version here) gives the same output. 1e-5 of the
    largest output."""
    kw = _cp_kwargs(scan_layers=scan_layers)
    x, cond, t = _sfno_inputs(9)
    jmodel = JSFNO(JSFNOConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x), time=jnp.asarray(t),
                            static_condition=jnp.asarray(cond))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), time=jnp.asarray(t),
                                   static_condition=jnp.asarray(cond)))
    assert ("blocks_mid" in variables["params"]) == scan_layers
    model = SFNO(SFNOConfig(**kw), fused_rank=fused_rank_on)
    sd = flax_to_state_dict(variables)
    assert sd["block_1.filter.cp_C"].shape == (12, 4, 2)
    model.load_state_dict(sd)
    assert [b.filter.rank_pipeline for b in model.blocks] == [False, True, False]
    assert [b.filter.fused_rank for b in model.blocks] == [False, fused_rank_on, False]
    with torch.no_grad():
        got = model(torch.from_numpy(x), time=torch.from_numpy(t),
                    static_condition=torch.from_numpy(cond)).numpy()
    assert _rel(got, want) <= REL


def test_cp_sfno_init_and_k4_dtype_rule():
    """Random CP weights follow the JAX initializer's scale; K4 takes
    the float32 mode or bf16 matmul with bf16 spectral IO, and raises for
    a mix it does not round like the model path."""
    model = SFNO(SFNOConfig(**_cp_kwargs(embed_dim=32)))
    model.init_weights(torch.Generator().manual_seed(0))
    std = float(model.block_1.filter.cp_A.detach().std())
    assert abs(std - (1 / 32 ** 2) ** (1 / 3)) < 0.02
    SFNO(SFNOConfig(**_cp_kwargs(sht_matmul_dtype="bfloat16", spectral_io_dtype="bfloat16")),
         fused_rank=True)
    with pytest.raises(NotImplementedError, match="fused_rank"):
        SFNO(SFNOConfig(**_cp_kwargs(sht_matmul_dtype="bfloat16")), fused_rank=True)


SKILL_FAST08 = REPO / "results" / "skill_fast08" / "forecaster.msgpack"


def test_trained_cp_forecaster_matches_jax():
    """The trained forecaster of results/skill_fast08 (64 x 128, embed 64 x
    4 layers, CP rank 0.25, thresholding 0.8, float32; the config of
    scripts/skill_proof.py's stage 2) loads through utils/convert.py and
    its forward agrees with the JAX package's: 1e-5 of the largest
    output."""
    if not SKILL_FAST08.exists():
        pytest.skip(f"{SKILL_FAST08.relative_to(REPO)} is not in this checkout")
    variables = serialization.msgpack_restore(SKILL_FAST08.read_bytes())
    kw = dict(img_shape=(64, 128), in_chans=4, out_chans=2, embed_dim=64, num_layers=4,
              with_time_emb=True, min_time=0, max_time=5, hard_thresholding_fraction=0.8,
              factorization="cp", rank=0.25)
    x, cond, t = _sfno_inputs(10, B=2, C=2, CF=2, shape=(64, 128), times=(0.0, 4.0))
    jmodel = JSFNO(JSFNOConfig(**kw))
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), time=jnp.asarray(t),
                                                     condition=jnp.asarray(cond)))(variables))
    model = SFNO(SFNOConfig(**kw), fused_rank=True)
    model.load_state_dict(flax_to_state_dict(variables))
    assert [b.filter.rank_pipeline for b in model.blocks] == [False, True, True, False]
    with torch.no_grad():
        got = model(torch.from_numpy(x), time=torch.from_numpy(t),
                    condition=torch.from_numpy(cond)).numpy()
    assert _rel(got, want) <= REL


# ------------------------------------------------------------ the fast window

GRID = (16, 32)
N_STATE = 5


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_fast_window_matches_jax():
    """The fast window (main_path.FAST_WINDOW: CP rank 0.25, thresholding
    0.8, scan and peel, K4 route) at debug size (embed 16 x 3 layers, 16 x
    32, horizon 6, 12 steps), dropout off, float32 with spectral IO off on
    both sides, against the JAX stepper built as bench.py:build() builds
    it: 1e-5 of the largest prediction."""
    horizon, n_steps = 6, 12
    fast = dict(main_path.FAST_WINDOW, spectral_io="")
    names = main_path.state_names(N_STATE)
    forcing = list(main_path.FORCING_NAMES)
    norm = JNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names}, names)
    fnorm = JNormalizer.from_dicts({n: 0.0 for n in forcing}, {n: 1.0 for n in forcing},
                                   forcing)
    packer = JPacker(names)
    cfg_kw = {k: fast[k] for k in ("use_pallas", "fused_mlp", "fused_tail", "scan_layers",
                                   "factorization", "rank", "thresh", "spectral_io")}
    icfg, fcfg = main_path.sfno_configs(16, 3, "float32", GRID, horizon, N_STATE, **cfg_kw)
    assert fcfg.factorization == "cp" and fcfg.modes == (12, 13)
    imodel, fmodel = JSFNO(JSFNOConfig(**_fields(icfg))), JSFNO(JSFNOConfig(**_fields(fcfg)))
    x = jnp.zeros((1,) + GRID + (N_STATE,))
    cond = jnp.zeros((1,) + GRID + (len(forcing),))
    ip = jax.jit(lambda k: imodel.init(k, jnp.concatenate([x, x], -1), time=jnp.ones((1,)),
                                       static_condition=cond))(jax.random.PRNGKey(0))
    fp = jax.jit(lambda k: fmodel.init(k, x, time=jnp.zeros((1,)), static_condition=cond))(
        jax.random.PRNGKey(1))
    interp = JInterpolation(imodel, JExperimentConfig(horizon=horizon, window=1,
                                                      enable_inference_dropout=True),
                            packer, packer, norm)
    dcfg = JConfig(timesteps=horizon, forward_conditioning="none", time_encoding="dynamics",
                   peel_sampler=True, enable_interpolator_dropout=False)
    exp = JForecasting(fmodel, interp, ip, dcfg, JExperimentConfig(horizon=horizon), packer,
                       packer, norm, forcing_names=forcing, forcing_normalizer=fnorm)
    prescriber = JPrescriberConfig("surface_temperature", main_path.MASK_NAME, 1).build(names)
    jstep = JStepper(exp, fp, prescriber=prescriber)
    inp = main_path.window_inputs(n_steps, GRID, N_STATE, seed=11, device="cpu")
    _, want = jstep.run_window(
        jnp.asarray(inp["x0"].numpy()), jnp.asarray(inp["forcing"].numpy()),
        jnp.asarray(inp["sst"].numpy()), jnp.asarray(inp["mask"].numpy()),
        jax.random.PRNGKey(0), n_steps)
    stepper = main_path.build(embed=16, layers=3, dtype="float32", img_shape=GRID,
                              horizon=horizon, n_state=N_STATE, device="cpu",
                              flax_params={"interpolator": ip, "forecaster": fp},
                              enable_interpolator_dropout=False, **fast)
    for net in (stepper.exp.model, stepper.exp.interpolator.model):
        assert [b.filter.fused_rank for b in net.blocks] == [False, True, False]
    _, got = stepper.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                                torch.Generator().manual_seed(0), n_steps)
    assert got.shape == (1, n_steps) + GRID + (N_STATE,)
    assert _rel(_np(got), np.asarray(want)) <= REL


# ------------------------------------------------------- F2: dropout edges

def _four_sigma(p, n):
    return 4 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("width,rate", [(6, 0.3), (8, 0.999), (10, 0.999)])
def test_dropout_edges_fall_back_to_exact_rate(width, rate):
    """Where the last axis is not a multiple of 4, or the rate rounds to
    keep-nothing, QuantizedDropout drops at the exact rate, as the JAX
    package's module does: kept values are x / (1 - rate), not x * 256 / t,
    the keep rate is 1 - rate within 4 sigma (and so is the JAX module's),
    and the mask comes from the caller's generator."""
    n = 400_000
    x = torch.ones(n // width, width)
    qd = QuantizedDropout(rate)
    y = qd(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    keep = 1.0 - rate
    kept = y[y != 0]
    assert kept.numel() > 0
    torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / keep), rtol=1e-6, atol=0)
    assert abs(kept.numel() / x.numel() - keep) <= _four_sigma(keep, x.numel())
    again = qd(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    other = qd(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, again) and not torch.equal(y, other)
    jy = JQuantizedDropout(rate).apply({}, jnp.ones(x.shape), deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(0)})
    jkept = float((np.asarray(jy) != 0).mean())
    assert abs(jkept - keep) <= _four_sigma(keep, x.numel())
    q = QuantizedDropout(0.3)(torch.ones(16, 8), deterministic=False,
                              generator=torch.Generator().manual_seed(0))
    assert torch.allclose(q[q != 0], torch.tensor(256 / 179))  # width 8: quantized


def test_keep_nothing_rate_leaves_the_fused_mlp():
    """MLP2d(fused=True) at rate 0.999 builds, runs the fused form while
    deterministic and the unfused form (exact-rate dropout) while dropout
    is live, as the JAX package's MLP2d does; the kernels' wrappers keep
    refusing a keep-nothing rate. The fused forms run under no_grad: the
    kernels have no backward and refuse autograd."""
    mlp = MLP2d(8, 16, 8, drop_rate=0.999, fused=True)
    for p in mlp.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        det = mlp(x, deterministic=True)
    unfused = MLP2d(8, 16, 8, drop_rate=0.999)
    unfused.load_state_dict(mlp.state_dict())
    torch.testing.assert_close(det, unfused(x, deterministic=True), rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(2)
    live = mlp(x, deterministic=False, generator=g)
    assert live.shape == x.shape and torch.isfinite(live).all()
    from spherical_dyffusion_tpu_torch.ops.fused_mlp import fused_mlp

    with torch.no_grad(), pytest.raises(ValueError, match="keep-nothing"):
        fused_mlp(x, mlp.Dense_0.kernel, mlp.Dense_0.bias, mlp.Dense_1.kernel,
                  mlp.Dense_1.bias, seed=1, drop_rate=0.999)
