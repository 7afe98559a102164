"""Card-only tests of the port's CUDA kernels against their plain versions.

Marked ``gpu``; the ``cuda`` fixture decides whether a card is present and
skips without one. This file imports no JAX, so it also runs on a machine
that has only PyTorch; there the repository's conftest (which imports JAX)
is left out:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_port_gpu.py

Kernel and plain version sum in different orders, so float32 results agree
to a few ulps of the summed magnitude; where a hidden value is rounded to
bf16 the two may round a tie differently, which moves the output by about
one bf16 ulp of the hidden value times a weight.
"""

import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    fused_block_tail,
    fused_block_tail_plain,
    fused_mlp,
    fused_mlp_plain,
    weight_image,
    weight_image_plain,
)
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
    dhconv,
    dhconv_plain,
    dhconv_weight_grad,
    dhconv_weight_grad_plain,
    dhconv_weight_image,
    dhconv_weight_image_plain,
)
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT, legendre_l_first

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# kernel against plain version, relative to the largest output, by the type
# of the rounded intermediates: float32 sums in another order; a bf16 or
# float16 intermediate may round a tie either way, one step of 2^-8 or 2^-11
# of its value, carried through a product
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("lead,L,M,CI,CO", [((1,), 6, 181, 256, 256), ((2, 1), 5, 70, 40, 72),
                                             ((3,), 4, 9, 16, 16)])
def test_dhconv_kernel_matches_plain(cuda, lead, L, M, CI, CO):
    """Full and partial m/co tiles, ci not a multiple of the 16-wide chunk."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(lead + (L, M, CI, 2), device=cuda, generator=g)
    w = torch.randn((CI, CO, L, 2), device=cuda, generator=g) / CI
    before = dhconv.launches
    y = dhconv(x, w)
    torch.cuda.synchronize()
    assert dhconv.launches == before + 1
    assert y.shape == lead + (L, M, CO, 2)
    assert _rel_err(y, dhconv_plain(x, w)) < 1e-5


@pytest.mark.parametrize("CI,CO,L", [(256, 256, 6), (40, 72, 5), (16, 16, 4), (33, 130, 3)])
def test_dhconv_weight_image_kernel_matches_plain(cuda, CI, CO, L):
    """The image kernel writes the plain image bit for bit: the same
    permutation, padding and TF32 split."""
    g = torch.Generator(device=cuda).manual_seed(17)
    w = torch.randn((CI, CO, L, 2), device=cuda, generator=g) / CI
    before = dhconv_weight_image.launches
    img = dhconv_weight_image(w)
    torch.cuda.synchronize()
    assert dhconv_weight_image.launches == before + 1
    assert torch.equal(img, dhconv_weight_image_plain(w))


@pytest.mark.parametrize("lead,L,M,CI,CO", [((2,), 6, 181, 256, 256), ((2, 1), 5, 70, 40, 72),
                                             ((3,), 4, 9, 16, 16), ((1,), 3, 65, 33, 130)])
def test_dhconv_kernel_with_cached_image_matches_plain(cuda, lead, L, M, CI, CO):
    """K1 through an image made once: batch 2 at the main path's widths,
    and ragged shapes (partial row and column tiles, ci not a multiple of
    the 16-wide chunk, odd CI and CO); two calls, no image made by them.
    1e-5 of the largest output: 3xTF32 drops about 2^-22 of each product."""
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn(lead + (L, M, CI, 2), device=cuda, generator=g)
    w = torch.randn((CI, CO, L, 2), device=cuda, generator=g) / CI
    img = dhconv_weight_image(w)
    images, before = dhconv_weight_image.launches, dhconv.launches
    y = dhconv(x, w, img)
    y2 = dhconv(x, w, img)
    torch.cuda.synchronize()
    assert (dhconv.launches - before, dhconv_weight_image.launches - images) == (2, 0)
    assert torch.equal(y, y2)
    assert _rel_err(y, dhconv_plain(x, w)) < 1e-5
    with pytest.raises(ValueError, match="weight image"):
        dhconv(x, w, img[:, :, :, :1])


def test_k1_image_rebuilt_after_weight_update_on_card(cuda):
    """The SFNO's filters make their images once, reuse them, and make
    them again after load_state_dict copies new weights in place; the
    output then matches the plain path with the new weights."""
    kw = dict(img_shape=(32, 64), in_chans=7, out_chans=5, embed_dim=32, num_layers=3,
              with_time_emb=True)
    fast = SFNO(SFNOConfig(**kw, use_pallas=True)).to(cuda)
    plain = SFNO(SFNOConfig(**kw)).to(cuda)
    fast.init_weights(torch.Generator(device=cuda).manual_seed(19))
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(1, 32, 64, 5, device=cuda, generator=g)
    cond = torch.randn(1, 32, 64, 2, device=cuda, generator=g)
    t = torch.tensor([1.0], device=cuda)
    before = dhconv_weight_image.launches
    with torch.no_grad():
        fast(x, time=t, static_condition=cond)
        fast(x, time=t, static_condition=cond)
    assert dhconv_weight_image.launches - before == 3
    plain.init_weights(torch.Generator(device=cuda).manual_seed(21))
    fast.load_state_dict(plain.state_dict())
    with torch.no_grad():
        y = fast(x, time=t, static_condition=cond)
        want = plain(x, time=t, static_condition=cond)
    assert dhconv_weight_image.launches - before == 6
    assert _rel_err(y, want) < 1e-5


@pytest.mark.parametrize("x_dtype,res_dtype", [
    (torch.float32, None), (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float32), (torch.float16, None), (torch.float16, torch.float16)])
@pytest.mark.parametrize("exact_gelu", [False, True])
def test_fused_mlp_kernel_matches_plain(cuda, x_dtype, res_dtype, exact_gelu):
    """N = 130 rows leaves a partial last 64-row tile."""
    g = torch.Generator(device=cuda).manual_seed(1)
    N, C, Hd = 130, 256, 512
    x = torch.randn(N, C, device=cuda, generator=g).to(x_dtype)
    w1 = torch.randn(C, Hd, device=cuda, generator=g) / 16
    w2 = torch.randn(Hd, C, device=cuda, generator=g) / 22
    b1 = torch.randn(Hd, device=cuda, generator=g) * 0.1
    b2 = torch.randn(C, device=cuda, generator=g) * 0.1
    res = torch.randn(N, C, device=cuda, generator=g).to(res_dtype) if res_dtype else None
    before = fused_mlp.launches
    y = fused_mlp(x, w1, b1, w2, b2, residual=res, exact_gelu=exact_gelu)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    want = fused_mlp_plain(x, w1, b1, w2, b2, residual=res, exact_gelu=exact_gelu)
    assert y.dtype == want.dtype
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: TOL[torch.float16]}
    assert _rel_err(y, want) < tol[x_dtype]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_mlp_kernel_dropout_bits_match_plain(cuda, x_dtype):
    """Same seed, same Philox bits: the kernel drops exactly the elements
    the plain version drops."""
    g = torch.Generator(device=cuda).manual_seed(2)
    N, C, Hd = 200, 64, 128
    x = torch.randn(N, C, device=cuda, generator=g).to(x_dtype)
    w1 = torch.randn(C, Hd, device=cuda, generator=g) / 8
    w2 = torch.randn(Hd, C, device=cuda, generator=g) / 11
    b1, b2 = torch.zeros(Hd, device=cuda), torch.zeros(C, device=cuda)
    y = fused_mlp(x, w1, b1, w2, b2, seed=987654321987, drop_rate=0.1)
    want = fused_mlp_plain(x, w1, b1, w2, b2, seed=987654321987, drop_rate=0.1)
    assert torch.equal(y == 0, want == 0)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: TOL[torch.float16]}
    assert _rel_err(y, want) < tol[x_dtype]


def test_sfno_forward_kernels_match_plain(cuda):
    """The whole network on the card: kernel routes on vs off, float32."""
    kw = dict(img_shape=(32, 64), in_chans=7, out_chans=5, embed_dim=32, num_layers=3,
              with_time_emb=True, dropout_mlp=0.1, drop_path_rate=0.1)
    fast = SFNO(SFNOConfig(**kw, use_pallas=True, fused_mlp=True)).to(cuda)
    plain = SFNO(SFNOConfig(**kw)).to(cuda)
    fast.init_weights(torch.Generator(device=cuda).manual_seed(3))
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 32, 64, 5, device=cuda, generator=g)
    cond = torch.randn(2, 32, 64, 2, device=cuda, generator=g)
    t = torch.tensor([1.0, 2.0], device=cuda)
    k1, k2 = dhconv.launches, fused_mlp.launches
    with torch.no_grad():
        y = fast(x, time=t, static_condition=cond)
        want = plain(x, time=t, static_condition=cond)
    assert (dhconv.launches - k1, fused_mlp.launches - k2) == (3, 3)
    assert np.isfinite(y.cpu().numpy()).all()
    assert _rel_err(y, want) < 1e-5


def _tail_operands(cuda, seed, B, N, C=256, Hd=512, x_dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return dict(x=torch.randn(B, N, C, device=cuda, generator=g).to(x_dtype),
                a=1.0 + 0.1 * torch.randn(B, 1, C, device=cuda, generator=g),
                c=0.1 * torch.randn(B, 1, C, device=cuda, generator=g),
                w1=torch.randn(C, Hd, device=cuda, generator=g) / 16,
                b1=torch.randn(Hd, device=cuda, generator=g) * 0.1,
                w2=torch.randn(Hd, C, device=cuda, generator=g) / 22,
                b2=torch.randn(C, device=cuda, generator=g) * 0.1,
                res=torch.randn(B, N, C, device=cuda, generator=g))


@pytest.mark.parametrize("x_dtype,res_dtype", [
    (torch.float32, None), (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
    (torch.float16, None), (torch.float16, torch.float16)])
@pytest.mark.parametrize("exact_gelu", [False, True])
def test_fused_block_tail_kernel_matches_plain(cuda, x_dtype, res_dtype, exact_gelu):
    """K3 on two samples of 77 rows: the second 64-row tile holds rows of
    both samples, each with its own A and C."""
    o = _tail_operands(cuda, 5, B=2, N=77, x_dtype=x_dtype)
    res = o["res"].to(res_dtype) if res_dtype else None
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    before = fused_block_tail.launches
    y = fused_block_tail(*args, residual=res, exact_gelu=exact_gelu)
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    want = fused_block_tail_plain(*args, residual=res, exact_gelu=exact_gelu)
    assert y.dtype == want.dtype and y.shape == want.shape == (2, 77, 256)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: TOL[torch.float16]}
    assert _rel_err(y, want) < tol[x_dtype]


def test_fused_block_tail_kernel_dropout_and_unit_affine(cuda):
    """Dropout on, no residual: the kernel drops the plain version's
    elements (rows b * N + n); with A = 1, C = 0 it equals K2 bit for bit."""
    o = _tail_operands(cuda, 6, B=2, N=150)
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    kw = dict(seed=987654321987, drop_rate=0.1)
    y = fused_block_tail(*args, **kw)
    want = fused_block_tail_plain(*args, **kw)
    assert torch.equal(y == 0, want == 0) and bool((y == 0).any())
    assert _rel_err(y, want) < 2e-2
    x, w = o["x"], args[3:]
    unit = fused_block_tail(x, torch.ones_like(o["a"]), torch.zeros_like(o["c"]), *w,
                            residual=o["res"], **kw)
    k2 = fused_mlp(x.reshape(-1, 256), *w, residual=o["res"].reshape(-1, 256), **kw)
    assert torch.equal(unit.reshape(-1, 256), k2)


@pytest.mark.parametrize("B", [1, 2])
def test_fused_block_tail_bf16_tensor_core_batches(cuda, B):
    """The bf16 tensor-core kernel at the main path's widths (C 256, Hd 512):
    B = 1 with the float32 residual (the forecaster's call), B = 2 without
    (the interpolator's); 700 rows a sample, so at B = 2 the 64-row tile of
    rows 640-703 holds rows of both samples. 1e-2 of the largest output: the
    hidden tensor is rounded to bf16 on both sides and a tie may round
    either way."""
    o = _tail_operands(cuda, 13, B=B, N=700)
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    res = o["res"] if B == 1 else None
    before = fused_block_tail.launches
    y = fused_block_tail(*args, residual=res)
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    want = fused_block_tail_plain(*args, residual=res)
    assert y.dtype == want.dtype == (torch.float32 if B == 1 else torch.bfloat16)
    assert y.shape == want.shape == (B, 700, 256)
    assert _rel_err(y, want) < 1e-2


@pytest.mark.parametrize("B", [1, 2])
def test_fused_block_tail_fp16_tensor_core_batches(cuda, B):
    """The float16 instance of the tensor-core kernel at the main path's
    widths, as the bf16 test above: B = 1 with the float32 residual, B = 2
    without (float16 out); 2e-3 of the largest output (``TOL``)."""
    o = _tail_operands(cuda, 29, B=B, N=700, x_dtype=torch.float16)
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    res = o["res"] if B == 1 else None
    before = fused_block_tail.launches
    y = fused_block_tail(*args, residual=res)
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    want = fused_block_tail_plain(*args, residual=res)
    assert y.dtype == want.dtype == (torch.float32 if B == 1 else torch.float16)
    assert y.shape == want.shape == (B, 700, 256)
    assert _rel_err(y, want) < TOL[torch.float16]


def test_fused_fp16_tensor_core_dropout_masks_match_plain(cuda):
    """Dropout 0.1 in the float16 instances: K3 over two samples of 700
    rows and K2 over 1000 of them drop exactly the plain versions' elements,
    and K3 with A = 1, C = 0 equals K2 bit for bit."""
    o = _tail_operands(cuda, 30, B=2, N=700, x_dtype=torch.float16)
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    w = args[3:]
    kw = dict(seed=2**40 + 54321, drop_rate=0.1)
    y = fused_block_tail(*args, **kw)
    want = fused_block_tail_plain(*args, **kw)
    assert torch.equal(y == 0, want == 0) and bool((y == 0).any())
    assert _rel_err(y, want) < TOL[torch.float16]
    x2 = o["x"].reshape(-1, 256)[:1000]
    y2 = fused_mlp(x2, *w, **kw)
    assert torch.equal(y2 == 0, fused_mlp_plain(x2, *w, **kw) == 0)
    unit = fused_block_tail(o["x"], torch.ones_like(o["a"]), torch.zeros_like(o["c"]), *w, **kw)
    assert torch.equal(unit.reshape(-1, 256)[:1000], y2)


def test_fused_kernels_refuse_mixed_16_bit_residuals(cuda):
    """A 16-bit x takes a residual in float32 or its own type; a bf16 x with
    a float16 residual, a float16 x with a bf16 one and a float32 x with a
    float16 one raise before a launch."""
    o = _tail_operands(cuda, 31, B=1, N=64, x_dtype=torch.float32)
    w = [o[k] for k in ("w1", "b1", "w2", "b2")]
    x, res = o["x"].reshape(64, 256), o["res"].reshape(64, 256)
    before = fused_mlp.launches
    for xd, rd in ((torch.bfloat16, torch.float16), (torch.float16, torch.bfloat16),
                   (torch.float32, torch.float16)):
        with pytest.raises(TypeError, match="residual"):
            fused_mlp(x.to(xd), *w, residual=res.to(rd))
    assert fused_mlp.launches == before


def test_fused_bf16_tensor_core_dropout_masks_match_plain(cuda):
    """Dropout 0.1 in the bf16 tensor-core kernels, no residual: K2 over
    1000 rows and K3 over two samples of 700 rows (a tile straddles them)
    drop exactly the plain versions' elements, and K3 with A = 1, C = 0
    equals K2 bit for bit."""
    o = _tail_operands(cuda, 14, B=2, N=700)
    args = [o[k] for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    w = args[3:]
    kw = dict(seed=2**40 + 12345, drop_rate=0.1)
    y = fused_block_tail(*args, **kw)
    want = fused_block_tail_plain(*args, **kw)
    assert torch.equal(y == 0, want == 0) and bool((y == 0).any())
    assert _rel_err(y, want) < 1e-2
    x2 = o["x"].reshape(-1, 256)[:1000]
    y2 = fused_mlp(x2, *w, **kw)
    want2 = fused_mlp_plain(x2, *w, **kw)
    assert torch.equal(y2 == 0, want2 == 0) and bool((y2 == 0).any())
    unit = fused_block_tail(o["x"], torch.ones_like(o["a"]), torch.zeros_like(o["c"]), *w, **kw)
    assert torch.equal(unit.reshape(-1, 256)[:1000], y2)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_kernels_at_block_origins_drop_the_whole_grids_elements(cuda, x_dtype):
    """Dropout 0.1, no residual, on blocks of a (2, 36, 72) grid: an h=2, w=2
    block (its 36-wide rows split a thread's 16-row groups), an h=2 block,
    and an odd one. K2 and K3 at the block's origin drop exactly the
    elements that the whole grid's launch drops there, and agree with their
    plain versions at the origin."""
    from spherical_dyffusion_tpu_torch.parallel.mesh import Block

    H, W, C = 36, 72, 256
    o = _tail_operands(cuda, 16, B=2, N=H * W, x_dtype=x_dtype)
    x = o["x"].reshape(2, H, W, C)
    a, c = o["a"][:, None], o["c"][:, None]
    w = [o[k] for k in ("w1", "b1", "w2", "b2")]
    kw = dict(seed=2**41 + 7, drop_rate=0.1)
    tol = TOL[x_dtype]
    whole = {"K2": fused_mlp(x, *w, **kw), "K3": fused_block_tail(x, a, c, *w, **kw)}
    for blk in (Block(18, 36, (18, 36), (H, W)), Block(0, 0, (18, 72), (H, W)),
                Block(5, 9, (7, 11), (H, W))):
        xb = x[:, blk.rows(), blk.cols()].contiguous()
        got = {"K2": fused_mlp(xb, *w, block=blk, **kw),
               "K3": fused_block_tail(xb, a, c, *w, block=blk, **kw)}
        plain = {"K2": fused_mlp_plain(xb, *w, block=blk, **kw),
                 "K3": fused_block_tail_plain(xb, a, c, *w, block=blk, **kw)}
        for k in got:
            want = whole[k][:, blk.rows(), blk.cols()]
            assert torch.equal(got[k] == 0, want == 0), (k, blk)
            assert torch.equal(got[k] == 0, plain[k] == 0), (k, blk)
            assert _rel_err(got[k], plain[k]) < tol


def test_fused_bf16_tensor_core_refuses_widths(cuda):
    """The bf16 kernel takes C, Hd and C2 multiples of 16 with C and C2 at
    most 256; any other bf16 call raises before a launch (float32 calls of
    the same widths go to the float32 kernel)."""
    g = torch.Generator(device=cuda).manual_seed(15)

    def ops(C, Hd, C2):
        return (torch.randn(130, C, device=cuda, generator=g).bfloat16(),
                torch.randn(C, Hd, device=cuda, generator=g) / 16,
                torch.zeros(Hd, device=cuda), torch.randn(Hd, C2, device=cuda, generator=g) / 16,
                torch.zeros(C2, device=cuda))

    before = fused_mlp.launches
    for widths in [(72, 512, 256), (320, 512, 256), (256, 40, 256), (256, 512, 72)]:
        with pytest.raises(ValueError, match="multiples of 16"):
            fused_mlp(*ops(*widths))
    assert fused_mlp.launches == before
    x, w1, b1, w2, b2 = ops(72, 40, 72)
    y = fused_mlp(x.float(), w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert _rel_err(y, fused_mlp_plain(x.float(), w1, b1, w2, b2)) < 1e-5


@pytest.mark.parametrize("C,Hd,C2,dtype", [(256, 512, 256, torch.float32),
                                           (256, 512, 256, torch.bfloat16),
                                           (48, 80, 32, torch.float32)])
def test_weight_image_kernel_matches_plain(cuda, C, Hd, C2, dtype):
    """The repack kernel writes exactly the plain permutation, rounded to
    bf16, at the main path's widths and at padded ones."""
    g = torch.Generator(device=cuda).manual_seed(16)
    w1 = torch.randn(C, Hd, device=cuda, generator=g).to(dtype)
    w2 = torch.randn(Hd, C2, device=cuda, generator=g).to(dtype)
    before = weight_image.launches
    img = weight_image(w1, w2)
    torch.cuda.synchronize()
    assert weight_image.launches == before + 1
    assert torch.equal(img, weight_image_plain(w1, w2).to(torch.bfloat16))


@pytest.mark.parametrize("C,Hd,C2,dtype", [(256, 512, 256, torch.float32),
                                           (256, 512, 256, torch.float16),
                                           (48, 80, 32, torch.bfloat16)])
def test_weight_image_kernel_fp16_matches_plain(cuda, C, Hd, C2, dtype):
    """The float16 image (the float16 kernels' weights) is the plain
    permutation rounded to float16, from float32, float16 and bf16
    weights."""
    g = torch.Generator(device=cuda).manual_seed(32)
    w1 = torch.randn(C, Hd, device=cuda, generator=g).to(dtype)
    w2 = torch.randn(Hd, C2, device=cuda, generator=g).to(dtype)
    img = weight_image(w1, w2, torch.float16)
    assert img.dtype == torch.float16
    assert torch.equal(img, weight_image_plain(w1, w2).to(torch.float16))


def test_sfno_fused_tail_kernels_match_plain(cuda):
    """The fused-tail network on the card (K1 and K3, batch 2, time
    scale-shift after the filter) against the plain path, float32."""
    kw = dict(img_shape=(32, 64), in_chans=7, out_chans=5, embed_dim=32, num_layers=3,
              with_time_emb=True, dropout_mlp=0.1, drop_path_rate=0.1, scan_layers=True,
              time_scale_shift_before_filter=False)
    fast = SFNO(SFNOConfig(**kw, use_pallas=True, fused_mlp=True, fused_tail=True)).to(cuda)
    plain = SFNO(SFNOConfig(**kw)).to(cuda)
    fast.init_weights(torch.Generator(device=cuda).manual_seed(7))
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 32, 64, 5, device=cuda, generator=g)
    cond = torch.randn(2, 32, 64, 2, device=cuda, generator=g)
    t = torch.tensor([1.0, 2.0], device=cuda)
    k1, k2, k3 = dhconv.launches, fused_mlp.launches, fused_block_tail.launches
    with torch.no_grad():
        y = fast(x, time=t, static_condition=cond)
        want = plain(x, time=t, static_condition=cond)
    assert (dhconv.launches - k1, fused_mlp.launches - k2,
            fused_block_tail.launches - k3) == (3, 0, 3)
    assert np.isfinite(y.cpu().numpy()).all()
    assert _rel_err(y, want) < 1e-5


def _rank_operands(cuda, seed, B, H, L, M, R, dtype, real_matrices=False):
    """xf (B, H, M, 2R, 2), A_t and S_t (M, H, L) in dtype, C (L, R, 2)
    float32; the Legendre matrices of a 180 x 360 legendre-gauss grid where
    real_matrices is set (the fast window's), else random ones."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xf = torch.randn(B, H, M, 2 * R, 2, device=cuda, generator=g).to(dtype)
    C = torch.randn(L, R, 2, device=cuda, generator=g) * 0.5
    if real_matrices:
        kw = dict(grid="legendre-gauss", matmul_dtype=dtype, kernel_layout=True)
        A_t = RealSHT(H, 2 * H, L, M, **kw).analysis_mhl.to(cuda)
        S_t = InverseRealSHT(H, 2 * H, L, M, **kw).synthesis_mhl.to(cuda)
    else:
        A_t = (torch.randn(M, H, L, device=cuda, generator=g) * 0.2).to(dtype)
        S_t = (torch.randn(M, H, L, device=cuda, generator=g) * 0.2).to(dtype)
    return xf, A_t, S_t, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,L,M,R,real", [(1, 37, 29, 29, 5, False), (2, 37, 29, 29, 5, False),
                                            (1, 180, 144, 144, 64, True),
                                            (2, 180, 144, 144, 64, True)])
def test_fused_rank_kernel_matches_plain(cuda, dtype, B, H, L, M, R, real):
    """K4 at a ragged shape (a partial rank tile, h and l not multiples of
    16) and at the fast window's shape, B = 1 and 2. float32: sums in
    another order, 1e-5 of the largest output; bf16 (float16): t and s are
    rounded to bf16 (float16) on both sides and a tie may round either way,
    1e-2 (2e-3)."""
    xf, A_t, S_t, C = _rank_operands(cuda, 9, B, H, L, M, R, dtype, real)
    before = fused_rank.launches
    y = fused_rank(xf, A_t, S_t, C)
    torch.cuda.synchronize()
    assert fused_rank.launches == before + 1
    want = fused_rank_plain(xf, A_t, S_t, C)
    assert y.dtype == want.dtype == dtype and y.shape == want.shape == xf.shape
    assert _rel_err(y, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,grid,L", [(1, "legendre-gauss", 144), (2, "legendre-gauss", 144),
                                      (1, "equiangular", 181)])
def test_fused_rank_kernel_skips_the_triangle(cuda, dtype, B, grid, L):
    """K4 with the Legendre matrices of a 180-latitude grid and the l_first
    the transforms record (l_first = m): the fast window's legendre-gauss
    l = m = 144 at B = 1 and 2, and the prototype's equiangular l = m = 181
    (L not a multiple of 8: the 2-byte load path); against the dense plain
    version, float32 1e-5, bf16 1e-2 and float16 2e-3 of the largest output."""
    g = torch.Generator(device=cuda).manual_seed(22)
    kw = dict(grid=grid, matmul_dtype=dtype, kernel_layout=True)
    fwd, inv = RealSHT(180, 360, L, L, **kw).to(cuda), InverseRealSHT(180, 360, L, L, **kw).to(cuda)
    A_t, S_t = fwd.analysis_mhl, inv.synthesis_mhl
    l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
    assert torch.equal(l_first.cpu(), torch.arange(L, dtype=torch.int32))
    xf = torch.randn(B, 180, L, 128, 2, device=cuda, generator=g).to(dtype)
    C = torch.randn(L, 64, 2, device=cuda, generator=g) * 0.5
    before = fused_rank.launches
    y = fused_rank(xf, A_t, S_t, C, l_first)
    torch.cuda.synchronize()
    assert fused_rank.launches == before + 1
    want = fused_rank_plain(xf, A_t, S_t, C)
    assert y.dtype == want.dtype == dtype
    assert _rel_err(y, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_rank_kernel_random_matrices_skip_nothing(cuda, dtype):
    """Random matrices have no zero triangle: l_first is 0 for every m, and
    the kernel with it equals the kernel called without l_first (which
    skips nothing) and the plain version (R 8: the 16-byte load path at a
    partial rank tile)."""
    xf, A_t, S_t, C = _rank_operands(cuda, 23, 2, 180, 144, 144, 8, dtype)
    l_first = legendre_l_first(A_t, S_t)
    assert int(l_first.abs().max()) == 0
    y = fused_rank(xf, A_t, S_t, C, l_first)
    assert torch.equal(y, fused_rank(xf, A_t, S_t, C))
    assert _rel_err(y, fused_rank_plain(xf, A_t, S_t, C)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,L,R,grid", [(1, 721, 144, 64, "equiangular"),
                                          (2, 400, 29, 5, None)])
def test_fused_rank_kernel_tall_grids(cuda, dtype, B, H, L, R, grid):
    """Grids taller than 192 latitudes, which the bf16 kernel walks in
    chunks of h: the 0.25-degree equiangular grid (721 latitudes, a partial
    last chunk) with its Legendre matrices and l_first at l = m = 144, and
    random matrices at a ragged shape (h 400, l = m = 29, R 5: the 2-byte
    load path); against the plain version, float32 1e-5, bf16 1e-2, float16 2e-3."""
    if grid is None:
        xf, A_t, S_t, C = _rank_operands(cuda, 26, B, H, L, L, R, dtype)
        l_first = legendre_l_first(A_t, S_t)
    else:
        g = torch.Generator(device=cuda).manual_seed(27)
        kw = dict(grid=grid, matmul_dtype=dtype, kernel_layout=True)
        fwd = RealSHT(H, 2 * H, L, L, **kw).to(cuda)
        inv = InverseRealSHT(H, 2 * H, L, L, **kw).to(cuda)
        A_t, S_t = fwd.analysis_mhl, inv.synthesis_mhl
        l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
        assert torch.equal(l_first.cpu(), torch.arange(L, dtype=torch.int32))
        xf = torch.randn(B, H, L, 2 * R, 2, device=cuda, generator=g).to(dtype)
        C = torch.randn(L, R, 2, device=cuda, generator=g) * 0.5
    before = fused_rank.launches
    y = fused_rank(xf, A_t, S_t, C, l_first)
    torch.cuda.synchronize()
    assert fused_rank.launches == before + 1
    want = fused_rank_plain(xf, A_t, S_t, C)
    assert y.dtype == want.dtype == dtype and y.shape == xf.shape
    assert _rel_err(y, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,h0,rows", [(180, 0, 90), (180, 90, 90), (180, 37, 53),
                                       (721, 300, 400)])
def test_fused_rank_kernel_synthesis_rows(cuda, dtype, H, h0, rows):
    """K4 with the whole analysis and only a block's synthesis rows (the
    route of a grid split over latitudes): the two halves of the fast
    window's 180 latitudes, a ragged block, and 400 rows of the 0.25-degree
    grid (chunks of h in both products); against the whole grid's plain
    result restricted to those rows, float32 1e-5, bf16 1e-2, float16 2e-3."""
    L, R = 144, 64
    g = torch.Generator(device=cuda).manual_seed(28)
    kw = dict(grid="legendre-gauss" if H == 180 else "equiangular", matmul_dtype=dtype,
              kernel_layout=True)
    fwd = RealSHT(H, 2 * H, L, L, **kw).to(cuda)
    inv = InverseRealSHT(H, 2 * H, L, L, **kw).to(cuda)
    A_t, S_t = fwd.analysis_mhl, inv.synthesis_mhl
    l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
    xf = torch.randn(1, H, L, 2 * R, 2, device=cuda, generator=g).to(dtype)
    C = torch.randn(L, R, 2, device=cuda, generator=g) * 0.5
    before = fused_rank.launches
    y = fused_rank(xf, A_t, S_t[:, h0:h0 + rows].contiguous(), C, l_first)
    torch.cuda.synchronize()
    assert fused_rank.launches == before + 1
    want = fused_rank_plain(xf, A_t, S_t, C)[:, h0:h0 + rows]
    assert y.dtype == dtype and y.shape == want.shape == (1, rows, L, 2 * R, 2)
    assert _rel_err(y, want) < TOL[dtype]


def test_fused_rank_wrapper_checks_l_first(cuda):
    """l_first of the wrong dtype, shape or device raises before any
    launch."""
    xf, A_t, S_t, C = _rank_operands(cuda, 24, 1, 37, 29, 29, 5, torch.bfloat16)
    lf = torch.zeros(29, dtype=torch.int32, device=cuda)
    before = fused_rank.launches
    for bad in (lf.long(), lf[:-1], lf.cpu()):
        with pytest.raises(ValueError, match="l_first"):
            fused_rank(xf, A_t, S_t, C, bad)
    assert fused_rank.launches == before


def test_fused_rank_wrapper_raises(cuda):
    """Wrong dtypes, a non-contiguous operand, shapes that do not match and
    l beyond the kernel's 192 raise before any launch."""
    xf, A_t, S_t, C = _rank_operands(cuda, 10, 1, 37, 29, 29, 5, torch.bfloat16)
    bad = [
        (TypeError, (xf, A_t.float(), S_t, C)),
        (TypeError, (xf, A_t, S_t, C.bfloat16())),
        (ValueError, (xf.transpose(1, 2), A_t, S_t, C)),
        (ValueError, (xf, A_t[:-1], S_t[:-1], C)),
        (ValueError, (xf, A_t, S_t, C[:, :-1])),
        (ValueError, (xf[..., 0], A_t, S_t, C)),
    ]
    big = torch.zeros(29, 37, 200, device=cuda, dtype=torch.bfloat16)
    bad.append((ValueError, (xf, big, big, torch.zeros(200, 5, 2, device=cuda))))
    before = fused_rank.launches
    for err, args in bad:
        with pytest.raises(err):
            fused_rank(*args)
    assert fused_rank.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sfno_fused_rank_matches_plain(cuda, dtype):
    """The CP network (rank 0.25, thresholding 0.8, 3 layers) on the card
    with K4 against the same weights without it: one launch for the middle
    block. float32: 1e-5 of the largest output; bf16 (matmul dtype and
    spectral IO): 2e-2, a bf16 intermediate may round a tie either way;
    float16 alike, 2e-2 too: the compute dtype's Dense layers run cuBLAS in
    both networks, and a tie that a K4 output rounds the other way moves
    every later layer's operands."""
    kw = dict(img_shape=(32, 64), in_chans=7, out_chans=5, embed_dim=32, num_layers=3,
              with_time_emb=True, factorization="cp", rank=0.25,
              hard_thresholding_fraction=0.8, scan_layers=True, compute_dtype=dtype,
              sht_matmul_dtype=dtype, spectral_io_dtype="" if dtype == "float32" else dtype)
    fast = SFNO(SFNOConfig(**kw), fused_rank=True).to(cuda)
    plain = SFNO(SFNOConfig(**kw)).to(cuda)
    fast.init_weights(torch.Generator(device=cuda).manual_seed(11))
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 32, 64, 5, device=cuda, generator=g)
    cond = torch.randn(2, 32, 64, 2, device=cuda, generator=g)
    t = torch.tensor([1.0, 2.0], device=cuda)
    before = fused_rank.launches
    with torch.no_grad():
        y = fast(x, time=t, static_condition=cond)
        want = plain(x, time=t, static_condition=cond)
    assert fused_rank.launches - before == 1
    assert np.isfinite(y.cpu().numpy()).all()
    assert _rel_err(y, want) < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("preds_dtype", [None, "bfloat16", "float16"])
def test_run_inference_on_card_is_chained_run_window(cuda, preds_dtype):
    """run_inference on the card at a small size (the fused-tail path with
    K1 and K3, embed 32 x 2 layers, 16 x 32, 5 channels, horizon 3, bf16,
    dropout off), two 3-step windows with the aggregator on: its final state
    and predictions equal two run_window calls chained by hand on inputs read
    from the source here, bit for bit; its tables on the card equal those of
    the same aggregator fed the CPU copies of the predictions and targets,
    within 1e-5 of each table's largest value."""
    grid, n_state = (16, 32), 5
    st = main_path.build(embed=32, layers=2, img_shape=grid, n_state=n_state, horizon=3,
                         use_pallas=True, fused_tail=True, peel=True, scan_layers=True,
                         device="cuda", seed=0, enable_interpolator_dropout=False,
                         preds_dtype=preds_dtype)
    names = list(st.exp.in_packer.names)
    forcing, mask = list(main_path.FORCING_NAMES), main_path.MASK_NAME
    src = SyntheticTimeSeries(names + forcing + [mask], n_timesteps=12, spatial_shape=grid)
    outs = []
    run = st.run_window

    def record(*args, **kwargs):
        out = run(*args, **kwargs)
        outs.append(out)
        return out

    st.run_window = record
    agg = InferenceAggregator(names, src.horizontal.area_weights())
    k1, k3 = dhconv.launches, fused_block_tail.launches
    run_inference(st, src, InferenceConfig(n_forward_steps=6, forward_steps_in_memory=3),
                  aggregator=agg, mask_name=mask, verbose=False)
    assert dhconv.launches > k1 and fused_block_tail.launches > k3
    st.run_window = run
    # the main path's normalizers are the identity: the raw fields are the inputs
    raw = {k: torch.from_numpy(v).to(cuda) for k, v in src.read_window(0, 7, list(src.names)).items()}
    x = torch.stack([raw[n][0] for n in names], -1)[None]
    f = torch.stack([raw[n] for n in forcing], -1)[None]
    preds = []
    for w in range(2):
        sl = slice(3 * w, 3 * w + 4)
        x, p = st.run_window(x, f[:, sl], raw["surface_temperature"][None, sl], raw[mask][None, sl],
                             torch.Generator().manual_seed(0), 3, apply_inputs_noise=(w == 0))
        preds.append(p)
    assert torch.equal(outs[-1][0], x)
    got_preds = torch.cat([o[1] for o in outs], dim=1)
    assert got_preds.dtype == (getattr(torch, preds_dtype) if preds_dtype else torch.float32)
    assert torch.equal(got_preds, torch.cat(preds, dim=1))
    cpu = InferenceAggregator(names, src.horizontal.area_weights())
    tgt = torch.stack([raw[n] for n in names], -1)
    for w in range(2):
        cpu.record_batch(preds[w].cpu(), tgt[3 * w + 1:3 * w + 4].cpu(), start_step=3 * w)
    want = cpu.reduced.series()
    got = agg.reduced.series()
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(v).all()
        assert np.abs(got[k] - v).max() <= 1e-5 * max(np.abs(v).max(), 1.0), k


@pytest.mark.parametrize("n_repeats,writer", [(1, False), (2, False), (2, True)])
def test_run_inference_never_waits_for_the_card(cuda, n_repeats, writer, tmp_path):
    """The rollout loop issues no synchronizing CUDA call before its end
    sync: run_inference (the fused-tail path at embed 32 x 2 layers, 16 x
    32, horizon 3, three 3-step windows, aggregator on with a snapshot in
    the second window) runs under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises on a pageable upload or a device-to-host copy. With
    ``n_repeats=1`` every window misses the upload cache (a source that
    does not repeat); with 2 the aligned source hits it after the first.
    With the prediction writer and the aggregator's video on, each window
    crosses to the host through one pinned copy whose event the next
    window's drain waits on (an event wait, which the mode does not count):
    the file holds the rollout's predictions."""
    from spherical_dyffusion_tpu_torch.data import hdf5
    from spherical_dyffusion_tpu_torch.inference.writers import DataWriter, DataWriterConfig

    grid = (16, 32)
    st = main_path.build(embed=32, layers=2, img_shape=grid, n_state=5, horizon=3,
                         use_pallas=True, fused_tail=True, peel=True, scan_layers=True,
                         device="cuda", seed=0)
    names = list(st.exp.in_packer.names)
    n_t = 10 if n_repeats == 1 else 6
    src = SyntheticTimeSeries(names + list(main_path.FORCING_NAMES) + [main_path.MASK_NAME],
                              n_timesteps=n_t, spatial_shape=grid)
    cfg = InferenceConfig(n_forward_steps=9, forward_steps_in_memory=3, n_repeats=n_repeats)
    # the first call builds K1's weight images and warms the allocators
    run_inference(st, src, cfg, aggregator=InferenceAggregator(names,
                  src.horizontal.area_weights()), mask_name=main_path.MASK_NAME, verbose=False)
    agg = InferenceAggregator(names, src.horizontal.area_weights(), snapshot_steps=[4],
                              log_video=writer)
    out = (DataWriter(DataWriterConfig(save_prediction_files=True), str(tmp_path), names,
                      src.horizontal.lat, src.horizontal.lon) if writer else None)
    preds = []
    run = st.run_window

    def record(*args, **kwargs):
        x, p = run(*args, **kwargs)
        preds.append(p)
        return x, p

    st.run_window = record
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        summary = run_inference(st, src, cfg, aggregator=agg, writer=out,
                                mask_name=main_path.MASK_NAME, verbose=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        st.run_window = run
    assert summary["n_forward_steps"] == 9
    assert set(agg.snapshots.snapshots) == {4}
    assert all(np.isfinite(v) for v in agg.get_logs().values())
    if writer:
        out.close()
        norm = st.exp.normalizer.subset(names)
        want = (torch.cat(preds, 1) * norm.stds.to(cuda) + norm.means.to(cuda)).cpu().numpy()
        with hdf5.File(str(tmp_path / "autoregressive_predictions.nc")) as f:
            got = np.stack([f[n][()] for n in names], -1)
        assert np.array_equal(got, want)
        assert np.array_equal(agg.video.get_videos()["gen_mean"], want[0])


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("CI,CO,L", [(256, 256, 6), (40, 72, 5), (33, 130, 3)])
def test_dhconv_conj_transposed_image_kernel_matches_plain(cuda, CI, CO, L):
    """The backward's image, conj(w)^T written from w by the image kernel,
    equals its plain version bit for bit (ragged widths both ways)."""
    g = torch.Generator(device=cuda).manual_seed(30)
    w = torch.randn((CI, CO, L, 2), device=cuda, generator=g) / CI
    before = dhconv_weight_image.launches
    img = dhconv_weight_image(w, conj_t=True)
    torch.cuda.synchronize()
    assert dhconv_weight_image.launches == before + 1
    assert torch.equal(img, dhconv_weight_image_plain(w, conj_t=True))


@pytest.mark.parametrize("lead,L,M,CI,CO", [((1,), 6, 181, 256, 256), ((2, 1), 5, 70, 40, 72),
                                             ((3,), 3, 65, 33, 130)])
def test_dhconv_backward_on_the_card_matches_autograd_of_plain(cuda, lead, L, M, CI, CO):
    """dhconv under grad carries a grad_fn; its backward launches K1 once
    for dx (over the conjugate-transposed image, made once) and dW's kernel
    once, and matches autograd of the plain version: dx and dW within 1e-5
    of their largest entry (3xTF32 drops about 2^-22 of each product)."""
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn(lead + (L, M, CI, 2), device=cuda, generator=g, requires_grad=True)
    w = (torch.randn((CI, CO, L, 2), device=cuda, generator=g) / CI).requires_grad_()
    gy = torch.randn(lead + (L, M, CO, 2), device=cuda, generator=g)
    k1, images = dhconv.launches, dhconv_weight_image.launches
    dws = dhconv_weight_grad.launches
    y = dhconv(x, w)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    torch.cuda.synchronize()
    assert (dhconv.launches - k1, dhconv_weight_image.launches - images) == (2, 2)
    assert dhconv_weight_grad.launches == dws + 1
    want_dx, want_dw = torch.autograd.grad(dhconv_plain(x, w), (x, w), gy)
    assert _rel_err(dx, want_dx) < 1e-5
    assert _rel_err(dw, want_dw) < 1e-5
    # a permuted upstream gradient is made contiguous before the launch
    gp = gy.transpose(-2, -3).contiguous().transpose(-2, -3)
    dx2, = torch.autograd.grad(dhconv(x, w), x, gp)
    assert _rel_err(dx2, want_dx) < 1e-5


def test_dhconv_weight_grad_keeps_float32_under_tf32(cuda):
    """dW keeps float32 accuracy when the caller has switched TF32 on for
    matmuls (one TF32 pass would miss by about 1e-4 of the largest entry):
    the kernel (3xTF32) within 1e-5 of its largest entry against the plain
    version in float64, and the caller's setting is left as it was."""
    g = torch.Generator(device=cuda).manual_seed(41)
    x = torch.randn((1, 4, 181, 64, 2), device=cuda, generator=g)
    gy = torch.randn((1, 4, 181, 48, 2), device=cuda, generator=g)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    launches = dhconv_weight_grad.launches
    try:
        flags.allow_tf32 = True
        dw = dhconv_weight_grad(x, gy)
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = before
    assert dhconv_weight_grad.launches == launches + 1
    want = dhconv_weight_grad_plain(x.double(), gy.double())
    assert _rel_err(dw, want) < 1e-5


@pytest.mark.parametrize("lead,L,M,CI,CO", [((1,), 4, 181, 64, 48), ((2,), 5, 181, 128, 48),
                                             ((1,), 6, 181, 256, 256), ((2,), 3, 70, 256, 256),
                                             ((2, 1), 7, 33, 40, 130), ((3,), 1, 5, 8, 3)])
def test_dhconv_weight_grad_kernel_matches_plain(cuda, lead, L, M, CI, CO):
    """dW's kernel against the plain version in float64 within 1e-5 of the
    largest entry: CO 48 and 130 (partial co tiles), CI 40, 64 and 128 (a
    partial ci tile, the "w" shards), batch 1 and 2, L not a multiple of the
    cluster of four (odd L too) and M across the 16-wide chunks; one launch
    each, and a permuted upstream gradient made contiguous first."""
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn(lead + (L, M, CI, 2), device=cuda, generator=g)
    gy = torch.randn(lead + (L, M, CO, 2), device=cuda, generator=g)
    before = dhconv_weight_grad.launches
    dw = dhconv_weight_grad(x, gy)
    torch.cuda.synchronize()
    assert dhconv_weight_grad.launches == before + 1
    assert dw.shape == (CI, CO, L, 2) and dw.dtype == torch.float32
    want = dhconv_weight_grad_plain(x.double(), gy.double())
    assert _rel_err(dw, want) < 1e-5
    gp = gy.transpose(-2, -3).contiguous().transpose(-2, -3)
    assert not gp.is_contiguous()
    assert _rel_err(dhconv_weight_grad(x, gp), want) < 1e-5
    assert dhconv_weight_grad.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_dhconv_weight_grad_refuses_other_dtypes_on_the_card(cuda, dtype):
    """A CUDA input that is not float32 raises and launches nothing: no
    fallback to a library product."""
    x = torch.zeros((1, 2, 5, 8, 2), device=cuda, dtype=dtype)
    gy = torch.zeros((1, 2, 5, 4, 2), device=cuda, dtype=dtype)
    before = dhconv_weight_grad.launches
    with pytest.raises(TypeError, match="float32"):
        dhconv_weight_grad(x, gy)
    with pytest.raises(TypeError, match="float32"):
        dhconv_weight_grad(x.float(), gy)
    assert dhconv_weight_grad.launches == before


def _adam_allowance(gk, gp, lr):
    """Per parameter, how far AdamW's updates over the steps may move apart
    when the gradients differ from ``gp`` (per step, the plain path's) by
    ``gk``'s difference: lr times the sum over steps of min(2.5, 3 E /
    (sqrt(v_hat) + eps)), E the largest difference over the steps, v_hat
    Adam's bias-corrected second moment of ``gp`` (2 E / ... to first
    order; clipping only raises the effective eps). Where a gradient entry
    is rounding, as for a bias that an instance norm removes, the update
    follows the rounding's sign."""
    out = []
    for i in range(len(gp[0])):
        e = torch.stack([(sk[i] - sp[i]).abs() for sk, sp in zip(gk, gp)]).amax(0)
        v, sens = torch.zeros_like(e), torch.zeros_like(e)
        for t, sp in enumerate(gp, 1):
            v = 0.999 * v + 0.001 * sp[i] ** 2
            sens += (3 * e / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)).clamp(max=2.5)
        out.append(lr * sens)
    return out


def _loss_grads(tr, batch, seed):
    """The loss, its gradients, and the trained network's output with that
    output's cotangent (the graph kept for one more product)."""
    outs, cots = [], []

    def keep(module, args, out):
        outs.append(out)
        out.register_hook(cots.append)

    hook = tr.exp.model.register_forward_hook(keep)
    dyn, cond, _ = tr.upload(batch)
    loss, _ = tr.exp.train_loss(tr.normalizer.normalize(dyn), torch.Generator().manual_seed(seed),
                                dynamical_condition=cond)
    hook.remove()
    grads = torch.autograd.grad(loss, tr._params, retain_graph=True)
    assert len(outs) == len(cots) == 1
    return float(loss.detach()), grads, outs[0], cots[0]


def test_training_step_through_kernels_matches_plain_path(cuda):
    """Three trainer steps of each experiment at constant lr 4e-4 through K1
    (forward and dx) and through the plain path, same weights and batches,
    dropout off, the same generators (so the same t): at every step the
    loss within 1e-5 relative and every gradient within 1e-4 of its largest
    entry, or of 1e-4 of the network's largest gradient entry where a
    tensor's gradient cancels below that (a bias followed by an instance
    norm, which removes it: what is left is rounding). Where the L1 loss's
    sign flips at an output entry (a prediction meets its target within
    rounding; at most 1e-5 of the entries, or one), the plain gradient is
    taken at the kernels' output cotangent. The parameters after the three
    updates are within 1e-6 plus AdamW's response to the measured gradient
    difference (``_adam_allowance``). By the third step the filter weights
    have moved far from their small initial values."""
    steps = 3
    kw = dict(embed=32, layers=2, img_shape=(32, 64), horizon=3, n_state=5, dropout=False,
              n_samples=steps, scheduler="constant", device="cuda")
    fast = main_path.build_training(use_pallas=True, **kw)
    plain = main_path.build_training(use_pallas=False, **kw)
    for name in ("interpolator", "forecaster"):
        ftr, ptr = fast[name], plain[name]
        ptr.exp.model.load_state_dict(ftr.exp.model.state_dict())
        p0 = [p.detach().clone() for p in ptr.exp.model.parameters() if p.requires_grad]
        states = (ftr.init_state(), ptr.init_state())
        gk, gp = [], []
        for k, batch in zip(range(steps), ptr.dm.train_batches(seed=0)):
            lp, gp_k, op, cp = _loss_grads(ptr, batch, 5 + k)
            lk, gk_k, _, ck = _loss_grads(ftr, batch, 5 + k)
            assert abs(lk - lp) <= 1e-5 * abs(lp)
            delta = ck - cp
            flips = int((delta != 0).sum())
            assert flips <= max(1, 1e-5 * delta.numel())
            want = gp_k
            if flips:
                want = [a + b for a, b in zip(gp_k, torch.autograd.grad(op, ptr._params, delta))]
            top = max(float(b.abs().max()) for b in want)
            for a, b in zip(gk_k, want):
                assert torch.isfinite(a).all()
                scale = max(float(b.abs().max()), 1e-4 * top)
                assert float((a - b).abs().max()) <= 1e-4 * scale
            gk.append(gk_k)
            gp.append(gp_k)
            for tr, state in zip((ftr, ptr), states):
                dyn, cond, _ = tr.upload(batch)
                tr.train_step(state, dyn, cond, torch.Generator().manual_seed(5 + k))
        lr = ftr.schedule(0)
        assert abs(lr - 4e-4) < 1e-12
        pk = [p.detach() for p in ftr._params]
        pp = [p.detach() for p in ptr._params]
        # the updates were real: an entry moves by about lr a step
        assert max(float((b - q).abs().max()) for b, q in zip(pp, p0)) > lr
        for a, b, c in zip(pk, pp, _adam_allowance(gk, gp, lr)):
            assert bool(((a - b).abs() <= 1e-6 + c).all())


# ------------------------------------------- the command lines on the card

def _cli_common(d):
    return [f"ckpt_dir={d}", f"++log_dir={d / 'logs'}", "trainer.epochs=1",
            "datamodule.n_timesteps=12", "model.embed_dim=32", "model.num_layers=2",
            "++model.use_pallas=true", "verbose=false"]


@pytest.fixture
def cli_runs(cuda, tmp_path):
    """The train command line on the card at embed 32 x 2 with K1 on: the
    interpolator, then the forecaster."""
    from spherical_dyffusion_tpu_torch.train import run_model

    dhconv.launches = 0
    ip = run_model(None, ["experiment=debug_interpolation"] + _cli_common(tmp_path))
    fc = run_model(None, ["experiment=debug_dyffusion",
                          f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"]
                   + _cli_common(tmp_path))
    assert dhconv.launches > 0
    return ip, fc


def _logs_close(got, want, tol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(abs(w), 100.0 if "percent_diff" in k else 1.0)
        assert abs(got[k] - w) <= tol * scale, (k, got[k], w)


def test_cli_rollout_from_checkpoint_through_kernels_matches_plain(cuda, cli_runs, tmp_path):
    """The inference command line from the forecaster's checkpoint, float32,
    the interpolator's dropout off: K1 and K3 launched, and every log within
    1e-4 of the plain path's (use_pallas and fused_tail off in both nets)."""
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config

    def infer(kernels):
        model = {"use_pallas": kernels, "fused_tail": kernels}
        return main_from_config({
            "checkpoint_path": cli_runs[1]["ckpt_path"], "n_forward_steps": 12,
            "forward_steps_in_memory": 6, "experiment_dir": str(tmp_path / str(kernels)),
            "log_zonal_mean_images": False, "verbose": False,
            "overrides": {"model": model, "interpolator_model": model,
                          "diffusion": {"enable_interpolator_dropout": False}}})["logs"]

    dhconv.launches = fused_block_tail.launches = 0
    fast = infer(True)
    assert dhconv.launches > 0 and fused_block_tail.launches > 0
    dhconv.launches = fused_block_tail.launches = 0
    plain = infer(False)
    assert dhconv.launches == 0 and fused_block_tail.launches == 0
    _logs_close(fast, plain)


def test_reference_checkpoint_on_the_card_draws_exact_dropout_there(cuda, cli_runs, tmp_path,
                                                                   monkeypatch):
    """A reference Lightning checkpoint built from the trained networks
    (``sfno_flax_to_torch``) loads with exact dropout and equal weights; its
    live dropout draws every uniform on the card; with dropout off the
    kernels agree with the plain path (1e-4 of the largest prediction)."""
    from spherical_dyffusion_tpu_torch.interface import load_experiment_checkpoint
    from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax
    from spherical_dyffusion_tpu_torch.utils.torch_convert import sfno_flax_to_torch

    fc = cli_runs[1]["trainer"].exp
    nets = {"model.model.": fc.model.state_dict(),
            "model.interpolator.model.": fc.interpolator.model.state_dict()}
    sd = {}
    for prefix, net in nets.items():
        for k, v in sfno_flax_to_torch(state_dict_to_flax(net), mlp_dropout=True).items():
            sd[prefix + k] = torch.from_numpy(v)
    names = list(fc.in_packer.names)
    hp = {"model_config": {"_target_": "src.models.sfno.sfnonet.SphericalFourierNeuralOperatorNet",
                           "embed_dim": 32, "num_layers": 2, "dropout_mlp": 0.1},
          "datamodule_config": {"in_names": names + list(fc.forcing_names),
                                "forcing_names": list(fc.forcing_names), "out_names": names,
                                "horizon": 6, "window": 1},
          "diffusion_config": {"_target_": "src.diffusion.dyffusion.DYffusion",
                               "forward_conditioning": "none"}}
    path = str(tmp_path / "reference.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": hp}, path)

    def load(**model):
        return load_experiment_checkpoint(path, overrides={"model": model} if model else None,
                                          device="cuda")[0]

    exp = load(use_pallas=True)
    assert exp.model.cfg.exact_dropout and exp.interpolator.model.cfg.exact_dropout
    for net, want in ((exp.model, nets["model.model."]),
                      (exp.interpolator.model, nets["model.interpolator.model."])):
        assert all(torch.equal(net.state_dict()[k].cpu(), v.cpu()) for k, v in want.items())
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((1, 16, 32, 3), device=cuda, generator=g)
    f = torch.randn((1, 7, 16, 32, 1), device=cuda, generator=g)
    real = torch.rand
    draws = []

    def spy(*a, **k):
        draws.append((k.get("device"), a[0] if a else k.get("size")))
        return real(*a, **k)

    monkeypatch.setattr(torch, "rand", spy)
    _, live = DYffusionStepper(exp).run_window(x, f, None, None,
                                               torch.Generator().manual_seed(0), 6)
    monkeypatch.setattr(torch, "rand", real)
    big = [d for d in draws if int(np.prod(d[1])) > 64]
    assert big and all(torch.device(d[0]).type == "cuda" for d in big)
    assert torch.isfinite(live).all()

    def off(kernels):
        e = load_experiment_checkpoint(path, overrides={
            "model": {"use_pallas": kernels},
            "diffusion": {"enable_interpolator_dropout": False}}, device="cuda")[0]
        return DYffusionStepper(e).run_window(x, f, None, None, torch.Generator(), 6)[1]

    k, p = off(True), off(False)
    assert float((k - p).abs().max()) <= 1e-4 * float(p.abs().max())


# ----------------------------------------------------------- model options

def _small_window(path_kw, dtype="float32", dropout=False):
    """A 6-step window at embed 32 x 3 on 32 x 64 on the card: (stepper,
    preds)."""
    st = main_path.build(embed=32, layers=3, dtype=dtype, img_shape=(32, 64), n_state=5,
                         device="cuda", seed=0, enable_interpolator_dropout=dropout, **path_kw)
    inp = main_path.window_inputs(6, (32, 64), 5, seed=3, device="cuda")
    return st, lambda s: s.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                                      torch.Generator().manual_seed(0), 6)[1]


def _same_weights(dst, src):
    dst.exp.model.load_state_dict(src.exp.model.state_dict())
    dst.exp.interpolator.model.load_state_dict(src.exp.interpolator.model.state_dict())


def test_tucker_window_k3_matches_plain(cuda):
    """The Tucker window (main_path.TUCKER_WINDOW: the Tucker rank pipeline
    in the middle block, K3 in every block) against the plain path, float32,
    dropout off; K3 launched once per block of every SFNO forward."""
    kern, run = _small_window(main_path.TUCKER_WINDOW)
    plain, _ = _small_window(dict(main_path.TUCKER_WINDOW, fused_tail=False))
    _same_weights(plain, kern)
    assert [b.filter.rank_pipeline for b in kern.exp.model.blocks] == [False, True, False]
    k3 = fused_block_tail.launches
    got = run(kern)
    assert fused_block_tail.launches - k3 == 3 * 12  # 12 forwards in a peeled 6-step window
    assert _rel_err(got, run(plain)) < 1e-4


def test_folded_window_matches_unfolded(cuda):
    """The fused-tail window (K1 and K3) with sht_fold_symmetry against the
    unfolded one from the same weights, float32, dropout off."""
    kw = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True)
    fold, run = _small_window(dict(kw, sht_fold_symmetry=True))
    unfold, _ = _small_window(kw)
    _same_weights(unfold, fold)
    assert all(b.filter._transforms[0].folded for b in fold.exp.model.blocks)
    k1 = dhconv.launches
    got = run(fold)
    assert dhconv.launches - k1 == 3 * 12
    assert _rel_err(got, run(unfold)) < 1e-4


def test_remat_training_step_with_k1_matches_no_remat(cuda):
    """One training step of each experiment with remat (scan_layers,
    checkpointing=3) through K1 against the same step without remat, with
    dropout and DropPath live: losses and gradients within 1e-6 of each
    tensor's largest entry, the generator's state equal, and K1 run for the
    recompute (two forwards and one dx per block of the trained network)."""
    kw = dict(embed=32, layers=3, img_shape=(32, 64), n_state=5, scan_layers=True,
              n_samples=1, device="cuda")
    with_remat = main_path.build_training(checkpointing=3, **kw)
    without = main_path.build_training(checkpointing=0, **kw)
    for name in ("interpolator", "forecaster"):
        a, b = with_remat[name], without[name]
        b.exp.model.load_state_dict(a.exp.model.state_dict())
        if name == "forecaster":
            b.exp.interpolator.model.load_state_dict(a.exp.interpolator.model.state_dict())
        dyn, cond, _ = a.upload(next(iter(a.dm.train_batches(seed=0))))
        out = []
        for tr in (a, b):
            gen = torch.Generator().manual_seed(9)
            dhconv.launches = dhconv.dx_launches = 0
            loss, _ = tr.exp.train_loss(tr.normalizer.normalize(dyn), gen,
                                        dynamical_condition=cond)
            grads = torch.autograd.grad(loss, list(tr.exp.model.parameters()))
            out.append((float(loss), grads, gen.get_state(), dhconv.launches,
                        dhconv.dx_launches))
        (la, ga, sa, ka, da), (lb, gb, sb, kb, db) = out
        frozen = 3 if name == "forecaster" else 0
        assert (ka, da, kb, db) == (9 + frozen, 3, 6 + frozen, 3)
        assert abs(la - lb) <= 1e-6 * abs(lb) and torch.equal(sa, sb)
        for x, y in zip(ga, gb):
            assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())


# ---------------------------------------------------- training's other modes

def _host_to_device_bytes():
    """A dispatch mode summing the bytes of host tensors that aten ops read
    into results on the card (the copies, and tensor constructors whose
    result is on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(o, torch.Tensor) and o.is_cuda for o in tree_leaves(out)):
                fresh = func is torch.ops.aten.lift_fresh.default
                for a in tree_leaves((args, kwargs)):
                    if isinstance(a, torch.Tensor) and (fresh or a.device.type == "cpu"):
                        self.nbytes += a.numel() * a.element_size()
            return out

    return Count()


_MODES_KW = dict(embed=32, layers=2, img_shape=(32, 64), horizon=3, n_state=5, device="cuda")


def test_fused_epoch_copies_nothing_from_the_host_per_step(cuda):
    """A fused epoch of 4 steps with dropout and DropPath live copies the
    dataset and the permutation index from the host, and nothing else: the
    timesteps and the dropout draws are made on the card."""
    tr = main_path.build_training(n_samples=4, **_MODES_KW)["interpolator"]
    main_path.fused_epoch(n_steps=4, trainer=tr)  # K1's images, cuBLAS, the allocator
    with _host_to_device_bytes() as seen:
        got = main_path.fused_epoch(n_steps=4, trainer=tr)
    assert got["steps"] == 4 and all(np.isfinite(got["losses"]))
    assert seen.nbytes == got["upload_bytes"] + 4 * 8


def test_streaming_and_rollout_validation_never_wait_for_the_card(cuda, monkeypatch):
    """A streamed epoch (2 segments) runs under
    ``torch.cuda.set_sync_debug_mode("error")`` but for its one epoch-end
    read (``Trainer._read_epoch``, an ordinary copy, lifted out of the check
    and counted); so does the rollout inside ``fit``'s rollout validation
    (the aggregator's logs are read after it)."""
    from spherical_dyffusion_tpu_torch.training import trainer as trainer_mod
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

    trs = main_path.build_training(n_samples=8, **_MODES_KW)
    itr = trs["interpolator"]
    tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=4))
    tr.fit_in_memory(epochs=1, val_every=2, verbose=False, segment_samples=2)  # warm-up
    real_read, reads = Trainer._read_epoch, []

    def read_outside(*a):
        reads.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_read(*a)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(Trainer, "_read_epoch", staticmethod(read_outside))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = tr.fit_in_memory(epochs=1, val_every=2, verbose=False, segment_samples=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(hist["step_losses"]) == 4 and len(hist["segment_wait_s"][0]) == 2
    assert reads == [1]
    real = trainer_mod.run_inference

    def strict(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(trainer_mod, "run_inference", strict)
    ftr = trs["forecaster"]
    rv = Trainer(ftr.exp, ftr.dm, TrainerConfig(epochs=1, steps_per_epoch=2, rollout_val_every=1,
                                                rollout_val_steps=6))
    out = rv.fit(val_every=2, verbose=False)["rollout_val"][0]
    assert out and all(np.isfinite(v) for v in out.values())


def test_bf16_mu_step_matches_its_float64_rule(cuda):
    """Four ``AdamWLowMu`` steps on the card against optax's rule in float64
    with ``mu`` rounded to bf16 at the same point (``b1 * mu`` in bf16 with
    b1 rounded to bf16, the update from the float32 ``mu``, then the
    rounding): the parameters within 1e-6 of their scale plus the learning
    rate times one bf16 step per update; ``exp_avg`` bf16 and within one
    bf16 step of the rule's."""
    from spherical_dyffusion_tpu_torch.training.optim import AdamWLowMu

    g = torch.Generator(device=cuda).manual_seed(4)
    p = torch.nn.Parameter(torch.randn((64, 33), device=cuda, generator=g))
    x = p.detach().double()
    lr, wd, b1, b2, eps = 1e-2, 5e-3, 0.9, 0.999, 1e-8
    opt = AdamWLowMu([{"params": [p], "weight_decay": wd}], lr=lr)
    b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16))
    m_st = torch.zeros_like(x)
    v = torch.zeros_like(x)
    for k in range(1, 5):
        grad = torch.randn(p.shape, device=cuda, generator=g) * 10.0 ** -k
        p.grad = grad.clone()
        opt.step()
        gd = grad.double()
        m = (1 - b1) * gd + (b1_mu * m_st.to(torch.bfloat16).float()).to(torch.bfloat16).double()
        v = (1 - b2) * gd * gd + b2 * v
        x = x - lr * ((m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + eps) + wd * x)
        m_st = m.to(torch.bfloat16).double()
    mu = opt.state[p]["exp_avg"]
    assert mu.dtype == torch.bfloat16
    assert bool(((mu.double() - m_st).abs() <= 2.0 ** -7 * m_st.abs()).all())
    assert float((p.detach().double() - x).abs().max()) <= 1e-6 * float(x.abs().max()) \
        + 4 * lr * 2.0 ** -7


@pytest.mark.parametrize("eq,sa,sb", [
    ("...hwc,wmr->...hmcr", (2, 12, 64, 8), (64, 33, 2)),      # the DFT
    ("...hmcr,hlm->...lmcr", (2, 12, 33, 8, 2), (12, 12, 33)),  # Legendre analysis
])
def test_bf16_einsum_on_the_card_is_the_cpu_form(cuda, eq, sa, sb):
    """``ops/matmul.py:einsum`` in bf16 on the card (``Product16``: one
    ``torch.bmm`` with ``out_dtype``) against its CPU form (the bf16 values
    multiplied in float32) on the same operands: forward and both gradients
    within 1e-5 of the largest sum of |products| (float32 sums in another
    order), and more than 2e-4 of it apart from the float32 einsum, so the
    operands were rounded."""
    from spherical_dyffusion_tpu_torch.ops.matmul import einsum

    r = np.random.default_rng(11)
    a0 = torch.from_numpy(r.standard_normal(sa).astype(np.float32))
    b0 = torch.from_numpy(r.standard_normal(sb).astype(np.float32))
    y32 = torch.einsum(eq, a0, b0)
    g0 = torch.from_numpy(r.standard_normal(tuple(y32.shape)).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        a, b = (t.to(dev, copy=True).requires_grad_() for t in (a0, b0))
        y = einsum(eq, a, b, torch.bfloat16)
        assert y.dtype == torch.float32
        out.append([t.detach().cpu() for t in (y, *torch.autograd.grad(y, (a, b), g0.to(dev)))])
    (y_cpu, *g_cpu), (y_card, *g_card) = out
    scale = float(torch.einsum(eq, a0.abs(), b0.abs()).max())
    assert float((y_card - y_cpu).abs().max()) <= 1e-5 * scale
    assert float((y32 - y_cpu).abs().max()) > 2e-4 * scale
    for got, want in zip(g_card, g_cpu):  # each rounded to bf16: one step of 2^-8 apart
        assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("eq,sa,sb", [
    ("...hwc,wmr->...hmcr", (2, 12, 64, 8), (64, 33, 2)),      # the DFT
    ("...hmcr,hlm->...lmcr", (2, 12, 33, 8, 2), (12, 12, 33)),  # Legendre analysis
])
def test_fp16_einsum_on_the_card_is_the_cpu_form(cuda, eq, sa, sb):
    """``einsum`` in float16 on the card: ``torch.bmm`` takes float16
    operands with a float32 ``out_dtype``, and equals the CPU form (the
    float16 values multiplied in float32) within 1e-5 of the largest sum of
    |products|; more than 2e-5 of it apart from the float32 einsum (float16
    keeps 11 bits, a step of 2^-11 of an operand); gradients rounded to
    float16 on both sides, one step of 2^-11 apart."""
    from spherical_dyffusion_tpu_torch.ops.matmul import einsum

    r = np.random.default_rng(12)
    a0 = torch.from_numpy(r.standard_normal(sa).astype(np.float32))
    b0 = torch.from_numpy(r.standard_normal(sb).astype(np.float32))
    y32 = torch.einsum(eq, a0, b0)
    g0 = torch.from_numpy(r.standard_normal(tuple(y32.shape)).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        a, b = (t.to(dev, copy=True).requires_grad_() for t in (a0, b0))
        y = einsum(eq, a, b, torch.float16)
        assert y.dtype == torch.float32
        out.append([t.detach().cpu() for t in (y, *torch.autograd.grad(y, (a, b), g0.to(dev)))])
    (y_cpu, *g_cpu), (y_card, *g_card) = out
    scale = float(torch.einsum(eq, a0.abs(), b0.abs()).max())
    assert float((y_card - y_cpu).abs().max()) <= 1e-5 * scale
    assert float((y32 - y_cpu).abs().max()) > 2e-5 * scale
    for got, want in zip(g_card, g_cpu):
        assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())


def test_bf16_compute_training_steps_on_the_card(cuda):
    """Two bf16-compute steps of each experiment (the transforms' products
    on the tensor cores through ``Product16``, K1 float32): finite
    float32 gradients, K1 launched as in float32, losses within
    ``BF16_VS_F32_LOSS`` (5e-5) of the float32 steps' from the same weights
    and batches, and gradient norms apart from theirs by more than
    ``BF16_GRAD_NORM_FLOOR`` (1e-5), so the bf16 path is the one that ran
    (``chip_smoke.py`` phase 14 (c) holds both at 256 x 8)."""
    kw = dict(_MODES_KW, n_samples=2)
    bf = main_path.train_steps(n_steps=2, trainers=main_path.build_training(dtype="bfloat16",
                                                                           **kw))
    f32 = main_path.train_steps(n_steps=2, trainers=main_path.build_training(**kw))
    for name in ("interpolator", "forecaster"):
        assert bf[name]["k1_launches"] == f32[name]["k1_launches"]
        assert bf[name]["trainer"].exp.model.cfg.compute_dtype == "bfloat16"
        for a, b in zip(bf[name]["losses"], f32[name]["losses"]):
            assert np.isfinite(a) and abs(a - b) <= 5e-5 * abs(b)
        assert max(abs(a - b) / abs(b) for a, b in zip(bf[name]["grad_norms"],
                                                       f32[name]["grad_norms"])) > 1e-5
        assert all(torch.isfinite(p).all() for p in bf[name]["trainer"].exp.model.parameters())


# ----------------------------------------------------------------- ACE family


def test_ace_window_kernels_match_plain(cuda):
    """One ACE window at debug size (``main_path.build_ace``: embed 32 x 2
    layers, 16 x 32, 3 water levels, float32, the dry-air corrector and the
    prescribed ocean), K1 and K3 against the plain path from the same
    weights and data: the generated fields within 1e-4 of their largest
    value, K1 and K3 launched once per layer and step, the fields finite, and
    the generated surface temperature the target's where the mask rounds
    to 1."""
    from spherical_dyffusion_tpu_torch.ops.fused_mlp import fused_block_tail

    size = dict(embed=32, layers=2, img_shape=(16, 32), levels=3, n_other=2, dtype="float32",
                device="cuda")
    plain = main_path.build_ace(kernels=False, **size)
    fused = main_path.build_ace(kernels=True, **size)
    fused.module.load_state_dict(plain.module.state_dict())
    T = 4
    src = main_path.AceBenchSource(plain.cfg.all_names, T + 1, (16, 32))
    data = {n: v[None] for n, v in src.read_window(0, T + 1, src.names).items()}
    want = plain.run_on_batch(data, T)
    k1, k3 = dhconv.launches, fused_block_tail.launches
    got = fused.run_on_batch(data, T)
    torch.cuda.synchronize()
    assert (dhconv.launches - k1, fused_block_tail.launches - k3) == (2 * T, 2 * T)
    for n, v in want.gen_data.items():
        assert torch.isfinite(got.gen_data[n]).all()
        assert _rel_err(got.gen_data[n], v) <= 1e-4, n
    mask = torch.from_numpy(data[main_path.MASK_NAME][:, 1:] == 1).to(cuda)
    sst = got.gen_data["surface_temperature"][:, 1:]
    tgt = torch.from_numpy(data["surface_temperature"][:, 1:]).to(cuda)
    assert torch.equal(sst[mask], tgt[mask])


def test_simultaneous_step_k1_dx_matches_autograd_of_plain(cuda):
    """One simultaneous training loss at debug size (horizon 2,
    ``horizon_at_once`` 1: two autoregressive forwards, embed 32 x 2
    layers, 16 x 32, float32): its gradients through K1 (forward and dx on
    the card) against autograd of the plain path from the same weights and
    batch, 1e-4 of each tensor's largest entry (of 1e-4 of the network's
    largest where a tensor's cancels); K1 launched 2 x 2 times forward and
    2 x 2 times for dx."""
    size = dict(embed=32, layers=2, img_shape=(16, 32), n_state=5, n_samples=1,
                device="cuda")
    trs = [main_path.build_simultaneous(use_pallas=p, **size) for p in (True, False)]
    trs[1].exp.model.load_state_dict(trs[0].exp.model.state_dict())
    batch = next(iter(trs[0].dm.train_batches(seed=0)))
    grads = []
    for i, tr in enumerate(trs):
        dyn, cond, _ = tr.upload(batch)
        before = (dhconv.launches, dhconv.dx_launches)
        loss, _ = tr.exp.train_loss(tr.normalizer.normalize(dyn),
                                    torch.Generator().manual_seed(0), dynamical_condition=cond)
        grads.append(torch.autograd.grad(loss, list(tr.exp.model.parameters())))
        torch.cuda.synchronize()
        if i == 0:
            assert (dhconv.launches - before[0], dhconv.dx_launches - before[1]) == (8, 4)
    top = max(float(g.abs().max()) for g in grads[1])
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1e-4 * top)
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_unet_on_the_card_matches_the_cpu(cuda):
    """The UNet (no hand-written kernel: cuDNN's convolutions, TF32 off) at
    debug size with both outer resamplers: the card's output against the
    CPU's for the same weights, 1e-4 of the largest output; a training
    step's gradients finite."""
    from spherical_dyffusion_tpu_torch.models.unet import UNet, UNetConfig

    for mode in ("bilinear", "nearest"):
        cfg = UNetConfig(img_shape=(45, 90), in_chans=5, out_chans=3, dim=8,
                         dim_mults=(1, 2, 4), with_time_emb=True, outer_sample_mode=mode,
                         upsample_dims=(48, 96), block_dropout=0.0, block_dropout1=0.0,
                         attn_dropout=0.0)
        cpu = UNet(cfg)
        cpu.init_weights(torch.Generator().manual_seed(0))
        net = UNet(cfg).to(cuda)
        net.load_state_dict(cpu.state_dict())
        x = torch.randn((2, 45, 90, 5), generator=torch.Generator().manual_seed(1))
        t = torch.tensor([1.0, 3.0])
        with torch.no_grad():
            want = cpu(x, time=t)
            got = net(x.to(cuda), time=t.to(cuda))
        assert _rel_err(got.cpu(), want) < 1e-4
        loss = net(x.to(cuda), time=t.to(cuda)).square().mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_nccl_group_of_one_runs_the_distributed_transforms(cuda, tmp_path):
    """An NCCL group of one rank (``file://`` rendezvous): the distributed
    SHT, ISHT and dhconv (scatter on and off) equal the single-device
    transforms, each collective a call of NCCL's."""
    import torch.distributed as dist

    from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
    from spherical_dyffusion_tpu_torch.parallel.distributed_sht import (
        distributed_dhconv,
        distributed_isht,
        distributed_sht,
    )
    from spherical_dyffusion_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(data=1)
        assert all(g is dist.group.WORLD for g in mesh.groups.values())
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn((2, 32, 64, 16), device=cuda, generator=g)
        w = torch.randn((16, 16, 32, 2), device=cuda, generator=g) / 16
        sht, isht = RealSHT(32, 64).to(cuda), InverseRealSHT(32, 64).to(cuda)
        want = sht(x)
        assert _rel_err(distributed_sht(x, sht, mesh), want) < 1e-6
        assert _rel_err(distributed_isht(want, isht, mesh), isht(want)) < 1e-6
        conv = contract_dhconv(want, w)
        assert _rel_err(distributed_dhconv(want, w, mesh), conv) < 1e-6
        assert _rel_err(distributed_dhconv(want, w, mesh, scatter_output=False), conv) < 1e-6
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the skill studies


@pytest.mark.parametrize("B,L,M,C", [(16, 64, 65, 64), (8, 16, 17, 16)])
def test_k1_forward_dx_dw_at_the_skill_studies_shapes(cuda, B, L, M, C):
    """K1's forward, dx and dW at CI = CO = 64 (the full preset of
    ``scripts/skill_proof.py``: half of K1's 128-wide column tile) and 16
    (the mini preset: L = 16, four of dW's clusters of four l), against
    the plain version and autograd of it, 1e-5 of the largest entry; one
    forward, one dx and one dW launch."""
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn((B, L, M, C, 2), device=cuda, generator=g, requires_grad=True)
    w = (torch.randn((C, C, L, 2), device=cuda, generator=g) / C).requires_grad_()
    gy = torch.randn((B, L, M, C, 2), device=cuda, generator=g)
    k1, dx_n, dws = dhconv.launches, dhconv.dx_launches, dhconv_weight_grad.launches
    y = dhconv(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    torch.cuda.synchronize()
    assert (dhconv.launches - k1, dhconv.dx_launches - dx_n) == (2, 1)
    assert dhconv_weight_grad.launches == dws + 1
    want = dhconv_plain(x, w)
    want_dx, want_dw = torch.autograd.grad(want, (x, w), gy)
    assert _rel_err(y, want) < 1e-5
    assert _rel_err(dx, want_dx) < 1e-5
    assert _rel_err(dw, want_dw) < 1e-5


def test_skill_interpolator_fit_through_k1_matches_the_plain_path(cuda):
    """20 steps of ``Trainer.fit_in_memory`` of ``skill_proof``'s mini
    interpolator (MLP dropout live, AdamW, warmup, EMA) through K1's
    forward, dx and dW against the same fit with ``use_pallas=False`` (the
    plain einsum, TF32 off) from the same weights, data and seed: the loss
    at every step within 1e-4 relative. The weights change at every step,
    so K1's weight images are made again each step (the trained network's
    forward and conjugate-transposed image of each of its blocks); an image
    served stale across an update would show here as a loss gap that grows
    step by step, and in the images counted."""
    import dataclasses

    from spherical_dyffusion_tpu_torch.scripts import skill_proof
    from spherical_dyffusion_tpu_torch.training.experiments import (
        ExperimentConfig,
        InterpolationExperiment,
    )
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

    steps = 20
    args = skill_proof.parser().parse_args(["--preset=mini"])
    P = skill_proof.preset(args)
    dm = skill_proof.datamodule(P, "ou")
    cfg = skill_proof.sfno_config(P, args, interpolator=True)
    assert cfg.use_pallas
    init = None
    out = {}
    for k1 in (True, False):
        model = SFNO(dataclasses.replace(cfg, use_pallas=k1)).to(cuda)
        if init is None:
            model.init_weights(torch.Generator(device=cuda).manual_seed(0))
            init = {n: v.clone() for n, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        exp = InterpolationExperiment(
            model, ExperimentConfig(horizon=P["horizon"], enable_inference_dropout=True),
            dm.in_packer, dm.out_packer, dm.normalizer)
        tr = Trainer(exp, dm, TrainerConfig(lr=P["lr_interp"], epochs=1, use_ema=True,
                                            warmup_steps=50, steps_per_epoch=steps, seed=0))
        images, launches = dhconv_weight_image.launches, dhconv_weight_grad.launches
        hist = tr.fit_in_memory(verbose=False, val_every=10 ** 9)
        out[k1] = (hist["step_losses"], dhconv_weight_image.launches - images,
                   dhconv_weight_grad.launches - launches)
    (losses, images, dws), (plain, plain_images, plain_dws) = out[True], out[False]
    assert len(losses) == len(plain) == steps
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    assert max(gaps) < 1e-4, gaps
    assert images == 2 * cfg.num_layers * steps and plain_images == 0
    assert dws == cfg.num_layers * steps and plain_dws == 0


@pytest.mark.parametrize("lead,L,M,CI,CO", [((16,), 5, 65, 64, 64), ((4,), 3, 181, 40, 130),
                                             ((60,), 2, 150, 33, 48), ((8,), 16, 17, 16, 16),
                                             ((16,), 64, 65, 64, 64), ((40,), 4, 181, 256, 256)])
def test_dhconv_weight_grad_promotes_over_long_sums(cuda, lead, L, M, CI, CO):
    """Over long sums (K = B M) ``wgrad_plan`` splits the chunks over blocks,
    and a block adds its accumulators into its float32 promotion tile every
    ``promote`` chunks: 65 chunks in 22 splits of 3 at L = 5 (the full skill
    preset's CI = CO = 64), 46 with partial ci and co tiles in 23 of 2, 563
    in 94 splits of 6 promoting every chunk, the mini preset's 9 unsplit,
    the full preset's real grid (64 l, 3 splits of 22, promoting every 8)
    and 453 chunks at 256 channels (6 splits of 76, promoting every chunk);
    each within 1e-5 of the largest entry of the plain version in float64,
    as the short sums are, and the same bits on a second call (the partials
    are added in split order, each promotion by the one thread that owns
    the entry)."""
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import wgrad_plan

    g = torch.Generator(device=cuda).manual_seed(44)
    x = torch.randn(lead + (L, M, CI, 2), device=cuda, generator=g)
    gy = torch.randn(lead + (L, M, CO, 2), device=cuda, generator=g)
    dw = dhconv_weight_grad(x, gy)
    again = dhconv_weight_grad(x, gy)
    torch.cuda.synchronize()
    want = dhconv_weight_grad_plain(x.double(), gy.double())
    assert _rel_err(dw, want) < 1e-5, (wgrad_plan(lead[0], L, M, CI, CO), _rel_err(dw, want))
    assert torch.equal(dw, again)



def test_mesh_paper_window_fake_mode_on_the_card(cuda, tmp_path):
    """``scripts/mesh_paper_window.py``'s fake mode at a small width on the
    card (embed 32 x 2 on 16 x 32, K1 on, data 1 x h 2 x w 2): every rank
    reports a peak above the parameters' bytes and a temp figure, K1 once
    a filter call on its "w" channel shard, no K1 image made in the timed
    window, the collectives not performed, and no process group left up."""
    import torch.distributed as dist

    from spherical_dyffusion_tpu_torch.scripts import mesh_paper_window as mpw

    stats = mpw.main(["--embed", "32", "--layers", "2", "--img-shape", "16", "32", "--window",
                      "6", "--data", "1", "--h", "2", "--w", "2", "--use-pallas", "--out",
                      str(tmp_path)])
    assert stats["collectives"] == "not performed" and len(stats["per_rank"]) == 4
    for r in stats["per_rank"]:
        assert r["peak_mb"] * 1e6 > r["params_bytes"] > 0
        assert r["temp_mb"] > 0 and r["k1_images_mb"] > 0
        assert r["launches"]["K1"] > 0 and r["k1_images"] == 0
        assert r["launches"]["K1"] == stats["per_rank"][0]["launches"]["K1"]
    assert not dist.is_initialized()
