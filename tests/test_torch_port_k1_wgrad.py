"""K1's weight gradient (dW) against the JAX package, on the CPU.

``dhconv_weight_grad`` launches ``dhconv_wgrad_tc_kernel``
(``spherical_dyffusion_tpu_torch/csrc/dhconv.cu``) on the card and runs its
plain version, ``dhconv_weight_grad_plain``, on the CPU. The kernel cannot
run here, so ``_dw_as_the_kernel`` repeats its arithmetic step for step:
each l's (b, m) rows flattened into one sequence and zero-padded at its end
to a multiple of ``WGRAD_K``, the chunks cut into ``wgrad_plan``'s splits,
per split the real GEMMs over K' = (b, m, re/im) of A' = (xr, xi) and A'' =
(-xi, xr) with B = (gr, gi), every operand split by ``split_tf32`` and
hi.hi + hi.lo + lo.hi summed in float64, and the split partials added in
split order. It is held against dW from
``jax.vjp`` of ``dhconv_pallas`` in interpret mode (JAX's
``_dhconv_rr_bwd``, whose dW is two XLA einsums a part) within 1e-5 of the
largest entry, and against float64 autograd of ``contract_dhconv`` within
1e-6. The kernel itself is held against the plain version on the card
(``tests/test_torch_port_gpu.py``, ``chip_smoke.py`` phases 11 (a) and 22
(a)).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.ops.pallas_contractions import dhconv_pallas
from spherical_dyffusion_tpu_torch.ops import _cuda
from spherical_dyffusion_tpu_torch.ops import pallas_contractions as pc
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
    WGRAD_K,
    WGRAD_MIN_SPLIT,
    WGRAD_SMS,
    WGRAD_TARGET,
    WGRAD_SUM_BUDGET,
    dhconv_weight_grad,
    dhconv_weight_grad_plain,
    split_tf32,
    wgrad_plan,
)

REPO = Path(__file__).resolve().parent.parent

# (lead, L, M, CI, CO): no lead and an odd M; M across a chunk (17 > 16) with
# CO not a multiple of 16; CI 64 as on a "w" = 4 shard of the 256 channels;
# chunks across b boundaries (B M = 60, 4 chunks, CO 72 on the 128-co tile);
# 17 chunks of M = 13 rows cut into 6 splits (the partials added in order)
CASES = [((), 3, 7, 20, 12), ((2,), 4, 17, 16, 33), ((2,), 2, 9, 64, 40),
         ((6,), 3, 10, 24, 72), ((20,), 2, 13, 8, 8)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ranges(plan):
    """Each split's chunks, ``[(first, end), ...]`` in split order."""
    return [(z * plan.per_split, min(plan.chunks, (z + 1) * plan.per_split))
            for z in range(plan.splits)]


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
    B = x.numel() // (L * M * CI * 2)
    plan = wgrad_plan(B, L, M, CI, CO)
    K = plan.chunks * WGRAD_K  # the rows (b, m) of an l, zero-padded at the end

    def k_major(t):  # (..., L, M, C, 2) -> (L, C, K' = (b, m, re/im)), rows padded
        t = t.reshape(B, L, M, t.shape[-2], 2).transpose(0, 1).reshape(L, B * M, -1, 2)
        t = torch.cat([t, t.new_zeros((L, K - B * M) + t.shape[2:])], 1)
        return t.permute(0, 2, 1, 3).reshape(L, t.shape[2], -1)

    bh, bl = (t.double() for t in split_tf32(k_major(g)))
    parts = []
    for a in (x, torch.stack([-x[..., 1], x[..., 0]], -1)):  # A', A''
        ah, al = (t.double() for t in split_tf32(k_major(a)))
        mm = lambda p, q, k: torch.einsum("lik,lok->lio", p[..., k], q[..., k])  # noqa: E731
        out = None
        for first, end in _ranges(plan):  # the split partials, added in split order
            k = slice(2 * WGRAD_K * first, 2 * WGRAD_K * end)
            part = mm(ah, bh, k) + mm(ah, bl, k) + mm(al, bh, k)
            out = part if out is None else out + part
        parts.append(out)
    return torch.stack(parts, -1).permute(1, 2, 0, 3)


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
    twelve arguments (x, g, dW and the workspace of split partials and
    promotion tiles, five sizes, the plan's chunks a split and promotion
    interval, the stream),
    and the port's
    module that launches it imports nothing of JAX or the JAX package (the
    import scan of ``tests/test_torch_port_ops.py`` covers every module)."""
    src = (REPO / "spherical_dyffusion_tpu_torch" / "csrc" / "dhconv.cu").read_text()
    assert "dhconv_wgrad_tc_kernel(" in src and 'extern "C" int sdt_dhconv_wgrad(' in src
    assert len(_cuda._SIGNATURES["sdt_dhconv_wgrad"]) == 12
    tree = ast.parse(Path(pc.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots.isdisjoint({"jax", "flax", "optax", "spherical_dyffusion_tpu"})


PLAN_SHAPES = [(1, 180, 181, 256, 256), (2, 180, 181, 256, 256), (1, 180, 181, 128, 256),
               (1, 180, 181, 64, 256), (16, 64, 65, 64, 64), (8, 16, 17, 16, 16),
               (60, 2, 150, 33, 48), (16, 5, 65, 64, 64), (3, 1, 5, 8, 3), (300, 3, 181, 256, 256),
               (40, 4, 181, 256, 256), (4, 3, 181, 40, 130)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_wgrad_plan(shape):
    """Every (b, m) row of an l lies in exactly one chunk of one split (the
    splits' chunks cover ``ceil(B M / WGRAD_K)`` in order, none empty); each
    block sums at most ``promote`` chunks in the tensor cores, with chunks x
    that within ``WGRAD_SUM_BUDGET`` (or one chunk); the workspace holds the
    splits after the first, each dW's size, and one promotion tile a block
    (64 ci by the block's co) where a split is longer than ``promote``;
    the grid counts the tiles, the l rounded up to the cluster and the
    splits."""
    B, L, M, CI, CO = shape
    p = wgrad_plan(B, L, M, CI, CO)
    owner = np.full(p.chunks * WGRAD_K, -1)
    for z, (first, end) in enumerate(_ranges(p)):
        assert first < end
        assert np.all(owner[first * WGRAD_K:end * WGRAD_K] == -1)
        owner[first * WGRAD_K:end * WGRAD_K] = z
    assert np.all(owner[:B * M] >= 0) and p.chunks == -(-B * M // WGRAD_K)
    assert list(owner[:B * M]) == sorted(owner[:B * M])
    serial = min(p.promote, p.per_split)
    assert serial >= 1 and (p.chunks * serial <= WGRAD_SUM_BUDGET or serial == 1)
    partials = (p.splits - 1) * CI * CO * L
    tiles = p.blocks * 64 * p.co_tile if p.per_split > p.promote else 0
    assert p.workspace == 2 * (partials + (partials & 1 if tiles else 0) + tiles)
    assert p.co_tile == (64 if CO <= 64 else 128)
    assert p.tiles == -(-CI // 64) * -(-CO // p.co_tile)
    assert p.blocks == p.tiles * -(-L // 4) * 4 * p.splits


def test_wgrad_plan_fills_the_card_at_small_widths():
    """At the skill studies' (16, 64, 65, 64) the splits give every one of
    the card's SMs a block (one 64 x 64 tile of 64 l alone were 64 blocks)
    within ``WGRAD_TARGET``: three of 22 chunks, promoting every 8; the main
    path's B = 1 and 2 and the "w" shards already fill it with one split and
    no workspace; the mini preset's 9 chunks (under ``WGRAD_MIN_SPLIT``)
    stay whole; a size of 0 or a grid past the kernel's raises."""
    p = wgrad_plan(16, 64, 65, 64, 64)
    assert (p.splits, p.per_split, p.promote, p.tiles, p.co_tile) == (3, 22, 8, 1, 64)
    assert WGRAD_SMS <= p.splits * p.tiles * 64 <= WGRAD_TARGET
    for B, CI in ((1, 256), (2, 256), (1, 128), (1, 64)):
        q = wgrad_plan(B, 180, 181, CI, 256)
        assert q.splits == 1 and q.workspace == 0 and q.tiles * 180 >= WGRAD_SMS
    mini = wgrad_plan(8, 16, 17, 16, 16)
    assert mini.chunks < WGRAD_MIN_SPLIT and mini.splits == 1 and mini.workspace == 0
    with pytest.raises(ValueError, match="positive"):
        wgrad_plan(0, 4, 5, 8, 8)
    with pytest.raises(ValueError, match="grid"):
        wgrad_plan(1, 70000, 5, 8, 8)


@pytest.mark.parametrize("splits", [1, 3, 9, 65])
def test_wgrad_plan_takes_a_number_of_splits(splits):
    """``wgrad_plan(..., splits=n)`` cuts the chunks into n splits of equal
    length (the last may be shorter, none empty) in place of its own choice,
    with the workspace and grid that follow: at the studies' (16, 64, 65,
    64), 9 or more splits sum no more than ``promote`` chunks a block and
    need no promotion tiles; a count of 0 or above the chunks raises."""
    p = wgrad_plan(16, 64, 65, 64, 64, splits=splits)
    assert p.splits == splits and p.per_split == -(-65 // splits)
    assert _ranges(p)[-1][1] == p.chunks == 65
    assert p.blocks == 64 * splits
    tiles = p.blocks * 64 * 64 if p.per_split > p.promote else 0
    partials = (splits - 1) * 64 * 64 * 64
    assert p.workspace == 2 * (partials + (partials & 1 if tiles else 0) + tiles)
    assert (p.per_split <= p.promote) == (splits >= 9)
    for bad in (0, 66):
        with pytest.raises(ValueError, match="splits"):
            wgrad_plan(16, 64, 65, 64, 64, splits=bad)

