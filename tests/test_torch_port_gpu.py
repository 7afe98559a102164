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

from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    fused_block_tail,
    fused_block_tail_plain,
    fused_mlp,
    fused_mlp_plain,
)
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv, dhconv_plain

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


@pytest.mark.parametrize("x_dtype,res_dtype", [
    (torch.float32, None), (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
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
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    assert _rel_err(y, want) < tol


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
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
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    assert _rel_err(y, want) < tol


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
    (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)])
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
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    assert _rel_err(y, want) < tol


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
