"""Spatial model parallelism in one process: the dropout bits of a block of
the grid, and the mesh's blocks, on the CPU.

On a grid split over a mesh's "h" and "w" axes a rank holds the block
``(B, Hl, Wl, C)`` at origin ``(h0, w0)`` of the ``(H, W)`` grid, and K2's
and K3's dropout draws each local row ``b*Hl*Wl + i*Wl + j`` at its pixel's
row of the whole grid, ``b*H*W + (h0+i)*W + (w0+j)``
(``ops/fused_mlp.py:global_rows``). Here: ``philox_bits`` and
``quantized_dropout`` of a block equal the whole grid's restricted to it,
on aligned and unaligned blocks (hypothesis); K2's and K3's plain versions
at an origin, with dropout 0.1, equal the whole grid's restricted (the same
dropped elements, the values to float32 rounding); on the whole grid the
bits are those of the map before blocks existed (a copy of that code); the
wrappers pass the block to their plain versions on the CPU; and the mesh's
partition specs and blocks are JAX's. The multi-rank runs are in
``tests/test_torch_port_parallel.py``.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spherical_dyffusion_tpu.parallel import batch_sharding as jbatch_sharding
from spherical_dyffusion_tpu.parallel import make_mesh as jmake_mesh
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    _map_args,
    fused_block_tail,
    fused_block_tail_plain,
    fused_mlp,
    fused_mlp_plain,
    global_rows,
    keep_threshold,
    philox4x32,
    philox_bits,
    quantized_dropout,
)
from spherical_dyffusion_tpu_torch.parallel.mesh import (
    Block,
    Mesh,
    batch_sharding,
    make_mesh,
    shard,
    shard_batch,
    spatial_block,
)

torch.set_num_threads(2)


def _restrict(whole: torch.Tensor, blk: Block) -> torch.Tensor:
    """(B, H, W, C) -> the block's (B, Hl, Wl, C)."""
    return whole[:, blk.rows(), blk.cols()]


@st.composite
def blocks(draw):
    """A block of an (H, W) grid at any origin, aligned to 16 rows or not."""
    H = draw(st.integers(1, 12))
    W = draw(st.integers(1, 40))
    h0 = draw(st.integers(0, H - 1))
    w0 = draw(st.integers(0, W - 1))
    Hl = draw(st.integers(1, H - h0))
    Wl = draw(st.integers(1, W - w0))
    return Block(h0, w0, (Hl, Wl), (H, W))


@settings(max_examples=40, deadline=None, database=None)
@given(blk=blocks(), B=st.integers(1, 3), cols=st.integers(1, 70), stream=st.integers(0, 1),
       seed=st.integers(0, 2**63 - 1))
def test_block_bits_are_the_whole_grids_restricted(blk, B, cols, stream, seed):
    (H, W), (Hl, Wl) = blk.shape, blk.local
    whole = philox_bits(seed, B * H * W, cols, stream).reshape(B, H, W, cols)
    got = philox_bits(seed, B * Hl * Wl, cols, stream, block=blk).reshape(B, Hl, Wl, cols)
    assert torch.equal(got, _restrict(whole, blk))
    rows = global_rows(B * Hl * Wl, blk).reshape(B, Hl, Wl)
    want = torch.arange(B * H * W).reshape(B, H, W)
    assert torch.equal(rows, _restrict(want[..., None], blk)[..., 0])


@pytest.mark.parametrize("blk", [
    Block(0, 0, (8, 16), (16, 32)), Block(8, 16, (8, 16), (16, 32)),  # the h=2, w=2 blocks
    Block(90, 180, (90, 180), (180, 360)), Block(0, 180, (90, 180), (180, 360)),
    Block(3, 5, (7, 11), (16, 32)),  # unaligned: Wl not a multiple of 16
])
def test_quantized_dropout_of_a_block_is_the_whole_grids_restricted(blk):
    (H, W), (Hl, Wl) = blk.shape, blk.local
    gen = torch.Generator().manual_seed(int(blk.h0 * 1000 + blk.w0))
    whole = torch.randn((2, H, W, 32), generator=gen)
    t = keep_threshold(0.1)
    want = _restrict(quantized_dropout(whole, t, seed=77, stream=1), blk)
    got = quantized_dropout(_restrict(whole, blk).contiguous(), t, seed=77, stream=1, block=blk)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="block"):
        quantized_dropout(whole, t, seed=77, block=blk)


def _operands(H, W, C=32, Hd=64, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(x=torch.randn((B, H, W, C), generator=g),
                w1=torch.randn((C, Hd), generator=g) / C ** 0.5,
                b1=0.1 * torch.randn((Hd,), generator=g),
                w2=torch.randn((Hd, C), generator=g) / Hd ** 0.5,
                b2=0.1 * torch.randn((C,), generator=g),
                res=torch.randn((B, H, W, C), generator=g),
                a=1.0 + 0.1 * torch.randn((B, 1, 1, C), generator=g),
                c=0.1 * torch.randn((B, 1, 1, C), generator=g))


def _same_drops(got, want):
    """The same dropped elements (exact zeros without a residual), the
    values within float32 rounding of the summed magnitudes."""
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("blk", [Block(0, 0, (8, 16), (16, 32)), Block(8, 0, (8, 32), (16, 32)),
                                 Block(8, 16, (8, 16), (16, 32)), Block(5, 9, (6, 7), (16, 32))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_plain_versions_at_an_origin_are_the_whole_grids_restricted(blk, dtype):
    """K2 (no residual, so a dropped output is 0) and K3 (per-sample
    affine) with dropout 0.1: the block's result at its origin is the whole
    grid's restricted to the block, element for element in its masks."""
    o = _operands(*blk.shape)
    x = o["x"].to(dtype)
    kw = dict(seed=2026, drop_rate=0.1)
    xb = _restrict(x, blk).contiguous()
    want = _restrict(fused_mlp_plain(x, o["w1"], o["b1"], o["w2"], o["b2"], **kw), blk)
    got = fused_mlp_plain(xb, o["w1"], o["b1"], o["w2"], o["b2"], block=blk, **kw)
    _same_drops(got.float(), want.float())
    want = _restrict(fused_block_tail_plain(x, o["a"], o["c"], o["w1"], o["b1"], o["w2"],
                                            o["b2"], **kw), blk)
    got = fused_block_tail_plain(xb, o["a"], o["c"], o["w1"], o["b1"], o["w2"], o["b2"],
                                 block=blk, **kw)
    _same_drops(got.float(), want.float())
    # with the residual the dropped elements carry it through
    res = _restrict(o["res"], blk).contiguous()
    got = fused_mlp(xb, o["w1"], o["b1"], o["w2"], o["b2"], residual=res, block=blk, **kw)
    want = fused_mlp_plain(xb, o["w1"], o["b1"], o["w2"], o["b2"], residual=res, block=blk,
                           **kw)
    assert torch.equal(got, want)  # the CPU wrapper is the plain version, block and all
    got = fused_block_tail(xb, o["a"], o["c"], o["w1"], o["b1"], o["w2"], o["b2"], block=blk,
                           **kw)
    want = fused_block_tail_plain(xb, o["a"], o["c"], o["w1"], o["b1"], o["w2"], o["b2"],
                                  block=blk, **kw)
    assert torch.equal(got, want)


def _bits_before_blocks(seed, rows, cols, stream):
    """``philox_bits`` as it was before blocks: the layout's counters over
    the whole grid of 16-row by 32-column tiles, each evaluated once."""
    row = torch.arange(rows, dtype=torch.int64)[:, None]
    col = torch.arange(cols, dtype=torch.int64)[None, :]
    c0 = (col // 32) * 4 + (col % 8) // 2
    c1 = (row // 16) * 8 + row % 8
    byte = 4 * ((col % 32) // 8) + 2 * (col % 2) + (row % 16) // 8
    n1, n0 = -(-rows // 16) * 8, -(-cols // 32) * 4
    g0 = torch.arange(n0, dtype=torch.int64).expand(n1, n0)
    g1 = torch.arange(n1, dtype=torch.int64)[:, None].expand(n1, n0)
    zero = torch.zeros((n1, n0), dtype=torch.int64)
    words = torch.stack(philox4x32((g0, g1, zero + stream, zero),
                                   (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)))
    return (words[byte // 4, c1, c0] >> (8 * (byte % 4))) & 255


@settings(max_examples=25, deadline=None, database=None)
@given(rows=st.integers(1, 300), cols=st.integers(1, 100), stream=st.integers(0, 1),
       seed=st.integers(0, 2**63 - 1), H=st.integers(1, 6))
def test_whole_grid_bits_are_unchanged(rows, cols, stream, seed, H):
    want = _bits_before_blocks(seed, rows, cols, stream)
    assert torch.equal(philox_bits(seed, rows, cols, stream), want)
    whole = Block(0, 0, (H, rows), (H, rows))  # a block that is the whole grid: no map
    assert torch.equal(philox_bits(seed, H * rows, cols, stream, block=whole),
                       _bits_before_blocks(seed, H * rows, cols, stream))
    assert _map_args(whole) == _map_args(None) == [0] * 5


def test_kernel_row_map_arguments():
    """The kernels' RowMap: local rows per sample, local and global widths,
    global rows per sample, the origin's offset."""
    assert _map_args(Block(90, 180, (90, 180), (180, 360))) == [
        16200, 180, 360, 64800, 90 * 360 + 180]
    assert _map_args(Block(0, 0, (90, 360), (180, 360))) == [32400, 360, 360, 64800, 0]


def _layout(kw, rank):
    """The make_mesh layout of 8 ranks as the given rank sees it."""
    mesh = make_mesh(ranks=range(8), **kw)
    return Mesh(ranks=mesh.ranks, groups=mesh.groups, rank=rank)


@pytest.mark.parametrize("kw", [dict(data=2, h=2, w=2), dict(data=4, h=2), dict(data=1, w=8),
                                dict(data=2, h=2, w=1, matmul=2)])
def test_mesh_blocks_tile_the_grid_as_jax_places_them(kw):
    """``batch_sharding(..., spatial=True)`` is JAX's spec; each rank's
    ``shard_batch`` block is the piece JAX's sharding places on the device of
    the same mesh position, at the origin ``spatial_block`` gives."""
    x = torch.arange(4 * 2 * 16 * 32 * 3, dtype=torch.float32).reshape(4, 2, 16, 32, 3)
    jmesh = jmake_mesh(**kw)
    assert batch_sharding(_layout(kw, 0), 5, spatial=True) == tuple(
        jbatch_sharding(jmesh, 5, spatial=True).spec)
    placed = jbatch_sharding(jmesh, 5, spatial=True).devices_indices_map(tuple(x.shape))
    devices = list(jmesh.devices.ravel())
    for rank in range(8):
        mesh = _layout(kw, rank)
        got = shard_batch(mesh, x, spatial=True)
        assert torch.equal(got, x[placed[devices[rank]]])
        blk = spatial_block(mesh, got.shape[-3:-1])
        assert blk.shape == (16, 32)
        assert torch.equal(got, shard(mesh, x, ("data", None, None, None, None))
                           [:, :, blk.rows(), blk.cols()])
    assert shard_batch(make_mesh(), x, spatial=True) is x  # one rank: the batch itself
