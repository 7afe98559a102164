"""What the tensor-core forms of K1 and K4 rest on, checked on the CPU.

K1 (``ops/pallas_contractions.py``) runs the complex dhconv as one real GEMM
over K = 2 CI on the TF32 tensor cores, each operand split into TF32 hi and
lo parts (3xTF32), against a weight image made once per model. K4
(``ops/fused_rank.py``) skips the zero triangle of the Legendre matrices
from ``l_first``, which the transforms record. The kernels run only on the
card (``tests/test_torch_port_gpu.py``); here the image, the split, the skip
and the image cache are held against the plain versions and the JAX package
(``dhconv_pallas`` in interpret mode), with the same inputs made with numpy
from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.ops.pallas_contractions import dhconv_pallas
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
    IMAGE_CI,
    IMAGE_CO,
    WeightImageCache,
    dhconv_weight_image,
    dhconv_weight_image_plain,
    split_tf32,
)
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT, legendre_l_first

# ------------------------------------------------------------- K1, 3xTF32


def test_split_tf32_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits (the 13 low bits clear), rounded to nearest
    with ties away from zero; hi + lo is within 2^-22 of a."""
    one = 1.0
    ulp = 2.0 ** -10  # of TF32 at 1
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    hi, lo = split_tf32(a)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, 0.0])
    assert torch.equal(hi, want)
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(r)
    assert float(((hi.double() + lo.double() - r.double()).abs() / r.double().abs()).max()) \
        <= 2.0 ** -22


def test_3xtf32_meets_float32_accuracy_where_one_tf32_pass_misses():
    """At K = 512 (the main path's 2 CI), hi.hi + hi.lo + lo.hi with float32
    sums (a product of two TF32 values is exact in float32, as on the tensor
    cores) is within 1e-5 of the largest output of the float64 product, the
    tolerance K1's card checks use; one TF32 pass (hi.hi) is not."""
    r = np.random.default_rng(1)
    a = r.standard_normal((181, 512)).astype(np.float32)
    b = (r.standard_normal((512, 256)) / 512).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    ah, al = split_tf32(torch.from_numpy(a))
    bh, bl = split_tf32(torch.from_numpy(b))
    three = (ah @ bh + ah @ bl + al @ bh).double().numpy()
    one = (ah @ bh).double().numpy()
    err3 = np.abs(three - exact).max() / scale
    err1 = np.abs(one - exact).max() / scale
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1


def _unswizzle(image, CI, CO, L):
    """The image back to (L, CO, CI, 2) hi and lo, and the padded part."""
    nct, nch = image.shape[1], image.shape[2]
    n = torch.arange(IMAGE_CO)[:, None]
    chunk = torch.arange(8)[None, :] ^ (n % 8)  # storage chunk of logical chunk c
    idx = (chunk[:, :, None] * 4 + torch.arange(4)).reshape(IMAGE_CO, -1)
    t = torch.gather(image, -1, idx.expand(image.shape))  # logical order
    # (L, nct, nch, part, co, (ci, r)) -> (part, L, nct * 128, nch * 16, 2)
    t = t.reshape(L, nct, nch, 2, IMAGE_CO, IMAGE_CI, 2).permute(3, 0, 1, 4, 2, 5, 6)
    t = t.reshape(2, L, nct * IMAGE_CO, nch * IMAGE_CI, 2)
    return t[0, :, :CO, :CI], t[1, :, :CO, :CI], t


def _k1_as_the_kernel(x, image, CI, CO, L):
    """y from the image as the kernel computes it: per l, the real GEMM over
    K = 2 CI of A' = (xr, -xi) (real outputs) and A'' = (xi, xr) (imaginary
    outputs) with the (wr, wi) columns, each operand split in hi and lo, the
    three passes hi.hi + hi.lo + lo.hi summed in float64."""
    whi, wlo, _ = _unswizzle(image, CI, CO, L)
    xr, xi = x[..., 0], x[..., 1]
    outs = []
    for a in (torch.stack([xr, -xi], -1), torch.stack([xi, xr], -1)):
        ah, al = split_tf32(a)
        ah = ah.flatten(-2).double()
        al = al.flatten(-2).double()
        bh, bl = whi.flatten(-2).double(), wlo.flatten(-2).double()  # (L, CO, 2 CI)
        mm = lambda p, q: torch.einsum("...lmk,lok->...lmo", p, q)  # noqa: E731
        outs.append(mm(ah, bh) + mm(ah, bl) + mm(al, bh))
    return torch.stack(outs, -1)


@pytest.mark.parametrize("lead,L,M,CI,CO", [((2,), 3, 7, 20, 136), ((1, 2), 2, 5, 16, 8),
                                             ((2,), 4, 9, 33, 40)])
def test_k1_weight_image_contracts_like_dhconv(lead, L, M, CI, CO):
    """The plain image (ci and co padded to 16 and 128, zeros there),
    contracted as the kernel does, equals contract_dhconv within 1e-6 of
    the largest output in float32, and the JAX package's dhconv_pallas
    (interpret mode) too; its hi + lo parts are the weight within 2^-22."""
    r = np.random.default_rng(2)
    x = r.standard_normal(lead + (L, M, CI, 2)).astype(np.float32)
    w = (r.standard_normal((CI, CO, L, 2)) / CI).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    image = dhconv_weight_image(wt)  # the plain version on the CPU
    assert image.shape == (L, -(-CO // 128), -(-CI // 16), 2, 128, 32)
    assert image.dtype == torch.float32
    whi, wlo, padded = _unswizzle(image, CI, CO, L)
    w_lco = wt.permute(2, 1, 0, 3).double()
    assert float(((whi.double() + wlo.double() - w_lco).abs()).max()) \
        <= 2.0 ** -22 * float(w_lco.abs().max())
    inside = torch.zeros(padded.shape[1:], dtype=torch.bool)
    inside[:, :CO, :CI] = True
    assert bool((padded[:, ~inside] == 0).all())
    got = _k1_as_the_kernel(xt, image, CI, CO, L)
    want = contract_dhconv(xt, wt)
    scale = float(want.abs().max())
    assert float((got - want.double()).abs().max()) <= 1e-6 * scale
    xc = jnp.asarray(x[..., 0] + 1j * x[..., 1], jnp.complex64)
    ref = np.asarray(dhconv_pallas(xc, jnp.asarray(w), interpret=True))
    ref = np.stack([ref.real, ref.imag], -1)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale


def test_k1_weight_image_is_a_permutation_of_the_split():
    """Every hi and lo value of the weight appears in the image exactly
    once, the rest is zero padding."""
    r = np.random.default_rng(3)
    CI, CO, L = 20, 136, 3
    w = torch.from_numpy(r.standard_normal((CI, CO, L, 2)).astype(np.float32))
    image = dhconv_weight_image_plain(w)
    hi, lo = split_tf32(w)
    nz = image[image != 0]
    want = torch.cat([hi.flatten(), lo.flatten()])
    assert nz.numel() == int((want != 0).sum())
    assert torch.equal(torch.sort(nz).values, torch.sort(want[want != 0]).values)


def _k1_sfno(**kw):
    cfg = SFNOConfig(img_shape=(8, 16), in_chans=3, out_chans=2, embed_dim=8, num_layers=2,
                     use_pallas=True, **kw)
    return SFNO(cfg)


def test_k1_image_cache_rebuilt_after_in_place_load_state_dict():
    """The image a filter keeps is reused while its weight is unchanged and
    made again after load_state_dict copies new values in place (the weight
    keeps its storage; its version counter moves)."""
    model = _k1_sfno()
    model.init_weights(torch.Generator().manual_seed(4))
    conv = model.blocks[0].filter
    assert isinstance(conv._k1_image, WeightImageCache)
    img = conv._k1_image(conv.weight)
    assert conv._k1_image(conv.weight) is img
    ptr = conv.weight.data_ptr()
    other = _k1_sfno()
    other.init_weights(torch.Generator().manual_seed(5))
    model.load_state_dict(other.state_dict())
    assert conv.weight.data_ptr() == ptr
    new = conv._k1_image(conv.weight)
    assert new is not img
    assert torch.equal(new, dhconv_weight_image_plain(other.blocks[0].filter.weight))
    assert not torch.equal(new, img)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert torch.equal(conv._k1_image(conv.weight),
                       dhconv_weight_image_plain(conv.weight))
    assert "_k1_image" not in str(list(model.state_dict()))


# ------------------------------------------------------------- K4, the triangle


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,L", [("legendre-gauss", 144), ("equiangular", 181)])
def test_l_first_is_m_on_the_180_latitude_grids(grid, L, dtype):
    """On the fast window's 180-latitude legendre-gauss grid (l = m = 144)
    and on the equiangular prototype grid (l = m = 181), in float32 and
    bf16, each transform records l_first = min(m, L): A[m] and S[m] are
    exactly zero below it and not zero at it."""
    kw = dict(grid=grid, matmul_dtype=dtype, kernel_layout=True)
    fwd = RealSHT(180, 360, L, L, **kw)
    inv = InverseRealSHT(180, 360, L, L, **kw)
    want = torch.clamp(torch.arange(L, dtype=torch.int32), max=L)
    for mat, lf in ((fwd.analysis_mhl, fwd.analysis_l_first),
                    (inv.synthesis_mhl, inv.synthesis_l_first)):
        assert lf.dtype == torch.int32 and torch.equal(lf, want)
        below = torch.arange(L)[None, :] < lf[:, None]  # (m, l)
        assert bool((mat.permute(0, 2, 1)[below] == 0).all())
        at = mat[torch.arange(L), :, lf.long()]  # (m, h): column l_first of A[m]
        assert bool((at != 0).any(dim=1).all())


def test_l_first_of_matrices_without_the_triangle():
    """Random matrices give l_first = 0; a zero prefix in one m counts only
    where both matrices have it; an all-zero m gives L."""
    r = np.random.default_rng(6)
    A = torch.from_numpy(r.standard_normal((5, 7, 9)).astype(np.float32))
    S = torch.from_numpy(r.standard_normal((5, 7, 9)).astype(np.float32))
    assert torch.equal(legendre_l_first(A, S), torch.zeros(5, dtype=torch.int32))
    A[2, :, :5] = 0
    S[2, :, :3] = 0
    A[4] = 0
    S[4] = 0
    assert legendre_l_first(A, S).tolist() == [0, 0, 3, 0, 9]
    assert legendre_l_first(A).tolist() == [0, 0, 5, 0, 9]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rank_skips_only_zeros(dtype):
    """K4's skip, done in torch: per m, the analysis rows and the synthesis
    depth restricted to l >= l_first rounded down to 16 give the dense plain
    version's result (rows below are zero, at the same rounding points), on
    a 24-latitude legendre-gauss grid with l = m = 20, at R 3, B 2."""
    kw = dict(grid="legendre-gauss", matmul_dtype=dtype, kernel_layout=True)
    fwd, inv = RealSHT(24, 48, 20, 20, **kw), InverseRealSHT(24, 48, 20, 20, **kw)
    A, S = fwd.analysis_mhl, inv.synthesis_mhl
    lf = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
    r = np.random.default_rng(7)
    xf = torch.from_numpy(r.standard_normal((2, 24, 20, 6, 2)).astype(np.float32)).to(dtype)
    C = torch.from_numpy(r.standard_normal((20, 3, 2)).astype(np.float32))
    want = fused_rank_plain(xf, A, S, C)
    assert torch.equal(fused_rank(xf, A, S, C, lf), want)  # the CPU wrapper: plain
    got = torch.empty_like(want)
    for m in range(20):
        lb = int(lf[m]) // 16 * 16
        got[:, :, m:m + 1] = fused_rank_plain(xf[:, :, m:m + 1], A[m:m + 1, :, lb:],
                                              S[m:m + 1, :, lb:], C[lb:])
    scale = float(want.float().abs().max())
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
    assert int(lf.max()) == 19 and int(lf[19]) // 16 * 16 == 16  # a skip happened
