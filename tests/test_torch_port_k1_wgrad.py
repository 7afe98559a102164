"""K1's weight gradient (dW) against the JAX package, on the CPU.

``dhconv_weight_grad`` launches ``dhconv_wgrad_tc_kernel``
(``spherical_dyffusion_tpu_torch/csrc/dhconv.cu``) on the card and runs its
plain version, ``dhconv_weight_grad_plain``, on the CPU. The kernel cannot
run here, so ``_dw_as_the_kernel`` repeats its arithmetic step for step:
each b's m zero-padded to a multiple of ``WGRAD_K``, the real GEMMs over
K' = (b, m, re/im) of A' = (xr, xi) and A'' = (-xi, xr) with B = (gr, gi),
every operand split by ``split_tf32`` and hi.hi + hi.lo + lo.hi summed in
float64. It is held against dW from ``jax.vjp`` of ``dhconv_pallas`` in
interpret mode (JAX's ``_dhconv_rr_bwd``, whose dW is two XLA einsums a
part) within 1e-5 of the largest entry, and against float64 autograd of
``contract_dhconv`` within 1e-6. The kernel itself is held against the
plain version on the card (``tests/test_torch_port_gpu.py``,
``chip_smoke.py`` phase 11 (a)).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spherical_dyffusion_tpu.ops.pallas_contractions import dhconv_pallas
from spherical_dyffusion_tpu_torch.ops import _cuda
from spherical_dyffusion_tpu_torch.ops import pallas_contractions as pc
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
    WGRAD_K,
    dhconv_weight_grad,
    dhconv_weight_grad_plain,
    split_tf32,
)

REPO = Path(__file__).resolve().parent.parent

# (lead, L, M, CI, CO): no lead and an odd M; M across a chunk (17 > 16) with
# CO not a multiple of 16; CI 64 as on a "w" = 4 shard of the 256 channels
CASES = [((), 3, 7, 20, 12), ((2,), 4, 17, 16, 33), ((2,), 2, 9, 64, 40)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(case):
    lead, L, M, CI, CO = case
    r = np.random.default_rng(sum(case[1:]))
    x = r.standard_normal(lead + (L, M, CI, 2)).astype(np.float32)
    g = r.standard_normal(lead + (L, M, CO, 2)).astype(np.float32)
    return x, g


@pytest.fixture(scope="module")
def jax_dw():
    """dW of ``jax.vjp`` of ``dhconv_pallas`` (interpret mode) for every
    case, computed once: ``(CI, CO, L, 2)``."""
    out = {}
    for case in CASES:
        _, L, _, CI, CO = case
        x, g = _inputs(case)
        xc = jnp.asarray(x[..., 0] + 1j * x[..., 1], jnp.complex64)
        w = jnp.zeros((CI, CO, L, 2), jnp.float32)  # dW does not depend on w
        _, vjp = jax.vjp(lambda b: dhconv_pallas(xc, b, interpret=True), w)
        # JAX's cotangent of a complex output is the conjugate of the
        # real-pair gradient: (gr, gi) enters as gr - i gi
        out[case], = vjp(jnp.asarray(g[..., 0] - 1j * g[..., 1], jnp.complex64))
    return out


def _dw_as_the_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW as ``dhconv_wgrad_tc_kernel`` computes it, in float64 sums."""
    L, M, CI = x.shape[-4:-1]
    CO = g.shape[-2]
    pad = (0, 0, 0, 0, 0, -M % WGRAD_K)  # each b's m to a multiple of the chunk
    xb = F.pad(x.reshape(-1, L, M, CI, 2), pad)
    gb = F.pad(g.reshape(-1, L, M, CO, 2), pad)

    def k_major(t):  # (B, L, Mp, rows, 2) -> (L, rows, K' = (b, m, re/im))
        return t.permute(1, 3, 0, 2, 4).reshape(L, t.shape[3], -1)

    bh, bl = (t.double() for t in split_tf32(k_major(gb)))
    outs = []
    for a in (xb, torch.stack([-xb[..., 1], xb[..., 0]], -1)):  # A', A''
        ah, al = (t.double() for t in split_tf32(k_major(a)))
        mm = lambda p, q: torch.einsum("lik,lok->lio", p, q)  # noqa: E731
        outs.append(mm(ah, bh) + mm(ah, bl) + mm(al, bh))
    return torch.stack(outs, -1).permute(1, 2, 0, 3)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[1:])))
def test_dw_kernel_arithmetic_matches_jax_vjp_of_pallas(jax_dw, case):
    """The kernel's arithmetic against JAX's dW within 1e-5 of the largest
    entry (3xTF32 drops about 2^-22 of each product) and against float64
    autograd of ``contract_dhconv`` within 1e-6."""
    _, L, _, CI, CO = case
    x, g = _inputs(case)
    got = _dw_as_the_kernel(torch.from_numpy(x), torch.from_numpy(g))
    assert got.shape == (CI, CO, L, 2)
    assert _rel(got.numpy(), np.asarray(jax_dw[case])) <= 1e-5
    w = torch.zeros((CI, CO, L, 2), dtype=torch.float64, requires_grad=True)
    want, = torch.autograd.grad(contract_dhconv(torch.from_numpy(x).double(), w),
                                w, torch.from_numpy(g).double())
    assert _rel(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[1:])))
def test_dw_on_the_cpu_is_the_plain_version_bit_for_bit(jax_dw, case):
    """On the CPU the dispatcher runs the plain version, launches nothing,
    and the plain version holds JAX's dW within 1e-5."""
    x, g = (torch.from_numpy(a) for a in _inputs(case))
    before = dhconv_weight_grad.launches
    got = dhconv_weight_grad(x, g)
    assert dhconv_weight_grad.launches == before
    torch.testing.assert_close(got, dhconv_weight_grad_plain(x, g), rtol=0, atol=0)
    assert _rel(got.numpy(), np.asarray(jax_dw[case])) <= 1e-5


def test_dw_refuses_a_device_it_has_no_version_for():
    """A tensor on neither the CPU nor the card raises: no fallback."""
    x = torch.empty((1, 2, 3, 4, 2), device="meta")
    g = torch.empty((1, 2, 3, 5, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dhconv_weight_grad(x, g)


def test_dw_kernel_is_bound_and_its_module_imports_no_jax():
    """The kernel and its C entry are in K1's source with a signature of
    eleven arguments (x, g, dW and the promotion workspace, the promotion
    interval and five sizes, the stream), and the port's
    module that launches it imports nothing of JAX or the JAX package (the
    import scan of ``tests/test_torch_port_ops.py`` covers every module)."""
    src = (REPO / "spherical_dyffusion_tpu_torch" / "csrc" / "dhconv.cu").read_text()
    assert "dhconv_wgrad_tc_kernel(" in src and 'extern "C" int sdt_dhconv_wgrad(' in src
    assert len(_cuda._SIGNATURES["sdt_dhconv_wgrad"]) == 11
    tree = ast.parse(Path(pc.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots.isdisjoint({"jax", "flax", "optax", "spherical_dyffusion_tpu"})


def test_wgrad_promotion_plan():
    """dW's kernel sums at most ``WGRAD_SUM_BUDGET`` chunk-intervals' worth
    in its accumulators (chunks x promote within the budget, promote at
    least 1): the main path's B = 1 and 2 (12 and 24 chunks) never
    promote, the full skill preset's (16, 64, 65, 64) promotes every 7 of
    its 80 chunks."""
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        WGRAD_SUM_BUDGET,
        wgrad_promote,
    )

    assert wgrad_promote(1, 181) >= 12
    assert wgrad_promote(2, 181) >= 24
    assert wgrad_promote(16, 65) == 7
    for B in (1, 2, 3, 7, 16, 40, 300):
        for M in (5, 17, 65, 181):
            chunks = B * -(-M // WGRAD_K)
            p = wgrad_promote(B, M)
            assert p >= 1 and (chunks * p <= WGRAD_SUM_BUDGET or p == 1), (B, M, p)
