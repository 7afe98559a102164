"""The UNet backbone on a grid split over "h" and "w", on the CPU, against
JAX's sharded UNet and against one process.

Four gloo ranks, spawned once for the module
(``test_torch_port_parallel_workers.py:start_unet``, which imports no JAX),
run the UNets of ``workers.UNETS`` on the meshes of ``workers.UNET_MESHES``:
bilinear 20 x 40 -> 24 x 48 with ``dim_mults`` (1, 2, 4, 8), a time
embedding and both conditions on h = 2 with w = 2, on "h" = 2, "w" = 2 and
"h" = 4; nearest 45 x 90 -> 48 x 96 on "h" = 3 (ranks 0-2; rank 3 holds no
block); ``keep_spatial_dims`` on "h" = 2. Each forward is gathered. The
ranks also record the inputs of a few modules at h = 2, w = 2 and roll the
main path's UNet window out on "h" = 2. While they run, this process
computes the one-process forwards and window and JAX's UNet jitted with its
input sharded ``P("data", "h", "w", None)`` on the same layout of the
virtual CPU devices (weights carried from the port by
``state_dict_to_flax``):

(a) dropout off, every rank's gathered output within 1e-5 of the largest
    output of JAX's sharded UNet (the one-process UNet test's tolerance);
(b) dropout 0.1 live, equal to the one-process forward from the same
    generator within 1e-5 of its largest value: the same elements dropped;
(c) the 12-step window with the interpolator's dropout live on "h" = 2
    within 1e-5 of the one-process window's largest prediction;
(d) a split level's activations are the block's, a whole level's the
    whole grid's.

In this process: the level plan of the published config
(``configs/model/unet.json``) on h2w2, h4 and h3; the published grid's
activations at dim 8 on one rank's block, its collectives recorded, not
made; and, over simulated blocks, a block's conv and resize with their
halos against the whole grid's restricted to the block.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import assume, given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_port_parallel_workers as workers
from spherical_dyffusion_tpu.models import unet as junet
from spherical_dyffusion_tpu.parallel import batch_sharding as jbatch_sharding
from spherical_dyffusion_tpu.parallel import make_mesh as jmake_mesh
from spherical_dyffusion_tpu_torch.models import unet
from spherical_dyffusion_tpu_torch.parallel import mesh as mesh_module
from spherical_dyffusion_tpu_torch.parallel.mesh import Mesh, halo_exchange, spatial_block
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)

JAX_MESHES = {"h2w2": dict(data=1, h=2, w=2), "h2": dict(data=1, h=2), "w2": dict(data=1, w=2),
              "h4": dict(data=1, h=4), "h3": dict(data=1, h=3)}
CASES = [(key, name) for key, names in workers.UNET_MESHES.items() for name in names]
PUBLISHED = unet.UNetConfig(img_shape=(180, 360), in_chans=72, out_chans=35, dim=64,
                            dim_mults=(1, 2, 4, 8), with_time_emb=True,
                            outer_sample_mode="bilinear", upsample_dims=(184, 368))


def _jax_forwards() -> dict:
    """JAX's UNet of each case, dropout off, jitted with the input sharded
    over "h" and "w" on the case's mesh layout: by (mesh, config). One jitted
    function a config, so its meshes share the trace."""
    out, jitted = {}, {}
    for key, name in CASES:
        n = int(np.prod(list(JAX_MESHES[key].values())))
        mesh = jmake_mesh(**JAX_MESHES[key], devices=jax.devices()[:n])
        x, t, conds = workers.unet_inputs(name)
        spatial = jbatch_sharding(mesh, 4, spatial=True)
        if name not in jitted:
            model = junet.UNet(junet.UNetConfig(**workers.UNETS[name]))
            jitted[name] = (jax.jit(lambda p, x, t, c, model=model: model.apply(p, x, time=t, **c)),
                            state_dict_to_flax(workers.unet_net(name).state_dict()))
        fwd, params = jitted[name]
        y = fwd(jax.device_put(params, NamedSharding(mesh, P())),
                jax.device_put(jnp.asarray(x.numpy()), spatial),
                None if t is None else jax.device_put(jnp.asarray(t.numpy()),
                                                      NamedSharding(mesh, P("data"))),
                {k: jax.device_put(jnp.asarray(v.numpy()), spatial) for k, v in conds.items()})
        out[(key, name)] = np.asarray(y)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the one-process forwards and window, and JAX's
    forwards; the ranks start first and run while this process computes the
    rest."""
    out = str(tmp_path_factory.mktemp("unet"))
    ctx = workers.start_unet(out)
    one = {}
    for name in workers.UNETS:
        net = workers.unet_net(name)
        one[name] = dict(det=workers.unet_forward(net, name, False),
                         drop=workers.unet_forward(net, name, True))
    one["window"] = workers.unet_window(workers.unet_window_stepper())
    return workers.results(ctx, 4, out), one, _jax_forwards()


def _ranks(ranks, key):
    return [r[key] for r in ranks if key in r]


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("key,name", CASES)
def test_unet_without_dropout_matches_jax_sharded_unet(runs, key, name):
    ranks, _, jax_out = runs
    assert len(_ranks(ranks, key)) == (3 if key == "h3" else 4)
    for r in _ranks(ranks, key):
        assert _gap(r[name]["det"], jax_out[(key, name)]) <= 1e-5


@pytest.mark.parametrize("key,name", CASES)
def test_unet_with_dropout_equals_one_process(runs, key, name):
    ranks, one, _ = runs
    want = one[name]["drop"]
    assert _gap(one[name]["det"], want) > 1e-2  # the dropout did run
    for r in _ranks(ranks, key):
        assert _gap(r[name]["drop"], want) <= 1e-5


def test_split_levels_hold_blocks_and_whole_levels_the_grid(runs):
    """At h = 2, w = 2 the bilinear config (24 x 48, dim 8, four levels)
    splits levels 0-2: their blocks are a quarter of the grid; level 3 and
    the input of level 2's downsample are whole; the output grid's final
    block is a quarter of 20 x 40."""
    ranks, _, _ = runs
    want = {"down0_block1": (2, 8, 12, 24), "down1_block1": (2, 8, 6, 12),
            "down2_block1": (2, 16, 3, 6), "down2_downsample": (2, 16, 6, 12),
            "down3_block1": (2, 32, 3, 6), "mid_block1": (2, 64, 3, 6),
            "up0_upsample": (2, 64, 6, 12), "up1_block1": (2, 48, 3, 6),
            "up3_block1": (2, 16, 12, 24), "final_res_block": (2, 16, 10, 20)}
    for r in ranks:
        assert r["probes"] == want


def test_unet_window_on_h2_equals_one_process(runs):
    """``main_path.build_unet``'s window (debug size, bilinear 20 x 40 ->
    24 x 48, the interpolator's dropout live) on "h" = 2: the final state
    and the predictions of every rank within 1e-5 of the one-process
    window's largest prediction."""
    ranks, one, _ = runs
    state, preds = one["window"]
    assert preds.shape == (1, workers.UNET_WINDOW_STEPS, 20, 40, workers.UNET_WINDOW["n_state"])
    scale = float(preds.abs().max())
    for r in ranks:
        got_state, got_preds = r["window"]
        assert float((got_preds - preds).abs().max()) <= 1e-5 * scale
        assert float((got_state - state).abs().max()) <= 1e-5 * scale


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("ways,split,blocks", [
    ((2, 2), 3, [(92, 184), (46, 92), (23, 46)]),
    ((4, 1), 2, [(46, 368), (23, 184)]),
    ((3, 1), 0, []),
])
def test_level_plan_of_the_published_config(ways, split, blocks):
    """184 x 368, 92 x 184, 46 x 92, 23 x 46: the bottleneck level never
    splits, 46 rows do not split over 4 ranks, 184 rows not over 3."""
    plan = unet.level_plan(PUBLISHED, *ways)
    assert plan.grids == ((184, 368), (92, 184), (46, 92), (23, 46))
    assert plan.split == split
    assert [(g[0] // ways[0], g[1] // ways[1]) for g in plan.grids[:split]] == blocks


def _layout(ways, rank) -> Mesh:
    """``rank``'s view of a (1, h, w, 1) mesh whose groups are names: the
    collectives go to ``_recorded``."""
    return Mesh(ranks=np.arange(ways[0] * ways[1]).reshape(1, *ways, 1),
                groups={"data": None, "h": "h", "w": "w", "matmul": None}, rank=rank)


@contextlib.contextmanager
def _recorded(calls: list):
    """``torch.distributed``'s collectives replaced by records of (name,
    group, shape); nothing moves."""
    def record(name):
        def call(out, *args, group=None, **kw):
            calls.append((name, group, tuple(out.shape)))
        return call
    with pytest.MonkeyPatch.context() as mp:
        for name in ("all_reduce", "all_to_all_single", "all_gather_into_tensor"):
            mp.setattr(mesh_module.dist, name, record(name))
        yield


def test_published_grid_runs_its_split_levels_on_blocks():
    """The published grid (180 x 360 -> 184 x 368, four levels) at dim 8 on
    the last rank's block of h = 2, w = 2: ``down0_block1`` takes (B, C,
    92, 184), level 2 its 23 x 46 block, level 3 the whole 23 x 46 grid
    after the gather of the 46 x 92 input of ``down2_downsample``; halos go
    over both axes, the gather "w" then "h"."""
    net = unet.UNet(dataclasses.replace(PUBLISHED, dim=8, in_chans=3))
    net.init_weights(torch.Generator().manual_seed(0))
    net.set_mesh(_layout((2, 2), 3))
    assert net.plan.split == 3
    assert net.FullAttention_0.drop._mesh is None and net.mid_block1.ConvBlock_0.drop._mesh is None
    assert net.down2_block1.ConvBlock_0.drop._mesh is not None
    assert net.down2_downsample._mesh is None and net.down1_downsample._mesh is not None
    seen, calls = {}, []
    hooks = [net.get_submodule(n).register_forward_pre_hook(
        lambda mod, args, n=n: seen.__setitem__(n, tuple(args[0].shape)))
        for n in ("down0_block1", "down2_block1", "down2_downsample", "down3_block1",
                  "up1_block1", "final_res_block")]
    with _recorded(calls), torch.no_grad():
        y = net(torch.zeros(1, 90, 180, 3), time=torch.ones(1))
    for hk in hooks:
        hk.remove()
    assert y.shape == (1, 90, 180, 35)
    assert seen == {"down0_block1": (1, 8, 92, 184), "down2_block1": (1, 16, 23, 46),
                    "down2_downsample": (1, 16, 46, 92), "down3_block1": (1, 32, 23, 46),
                    "up1_block1": (1, 48, 23, 46), "final_res_block": (1, 16, 90, 180)}
    kinds = {(name, group) for name, group, _ in calls}
    assert kinds == {("all_to_all_single", "h"), ("all_to_all_single", "w"),
                     ("all_reduce", "h"), ("all_reduce", "w"),
                     ("all_gather_into_tensor", "h"), ("all_gather_into_tensor", "w")}
    gathers = [(g, s) for name, g, s in calls if name == "all_gather_into_tensor"]
    assert gathers == [("w", (92, 1, 16, 23)), ("h", (46, 1, 16, 92))]


def _from_whole(whole: torch.Tensor):
    """A stand-in for ``halo_exchange`` over simulated blocks of the NHWC
    ``whole`` grid: each block's halo cut from the zero-padded grid."""
    def exchange(mesh, x, rows, cols):
        blk = spatial_block(mesh, x.shape[-3:-1])
        padded = F.pad(whole, (0, 0, cols, cols, rows, rows))
        return padded[:, blk.h0:blk.h0 + blk.local[0] + 2 * rows,
                      blk.w0:blk.w0 + blk.local[1] + 2 * cols]
    return exchange


CONVS = {"7x7": dict(kernel_size=(7, 7)), "3x3": dict(kernel_size=(3, 3)),
         "4x4 stride 2": dict(kernel_size=(4, 4), strides=(2, 2), padding=(1, 1))}


@settings(max_examples=25, deadline=None)
@given(conv=st.sampled_from(sorted(CONVS)), nh=st.integers(1, 4), nw=st.integers(1, 3),
       bh=st.integers(1, 4), bw=st.integers(1, 4), seed=st.integers(0, 2 ** 16))
def test_block_conv_equals_the_whole_conv_on_the_block(conv, nh, nw, bh, bw, seed):
    """Each simulated block's conv (its halo from the zero-padded grid, no
    padding) equals the whole grid's conv restricted to the block's output
    rows and columns (the stride-2 conv's blocks are even)."""
    kw = CONVS[conv]
    step = 2 if "strides" in kw else 1
    bh, bw = bh * step, bw * step
    assume(bh >= kw["kernel_size"][0] // 2 or nh == 1)
    assume(bw >= kw["kernel_size"][1] // 2 or nw == 1)
    H, W = nh * bh, nw * bw
    conv_mod = unet.Conv(3, 4, **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv_mod.kernel.copy_(torch.randn(conv_mod.kernel.shape, generator=g))
        conv_mod.bias.copy_(torch.randn(conv_mod.bias.shape, generator=g))
    x = torch.randn((2, H, W, 3), generator=g)
    nchw = x.permute(0, 3, 1, 2)
    want = conv_mod(nchw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet, "halo_exchange", _from_whole(x))
        for rank in range(nh * nw):
            conv_mod._mesh = mesh = _layout((nh, nw), rank)
            blk = spatial_block(mesh, (bh, bw))
            got = conv_mod(nchw[:, :, blk.rows(), blk.cols()])
            conv_mod._mesh = None
            out = spatial_block(mesh, (bh // step, bw // step))
            torch.testing.assert_close(got, want[:, :, out.rows(), out.cols()],
                                       rtol=1e-5, atol=1e-5)


@settings(max_examples=30, deadline=None)
@given(mode=st.sampled_from(["bilinear", "nearest"]), k=st.integers(1, 4),
       a=st.integers(2, 12), b=st.integers(2, 12), seed=st.integers(0, 2 ** 16))
def test_block_resize_equals_the_whole_resize_on_the_block(mode, k, a, b, seed):
    """A grid of k * a rows and 2 * a columns resized to k * b by 2 * b
    (up or down; the bilinear kernel renormalised at the edges), split k
    ways over "h" and 2 over "w": each simulated block's resize (the whole
    grid's weights on its rows and halo) equals the whole resize restricted
    to its output block."""
    n_in, n_out = (k * a, 2 * a), (k * b, 2 * b)
    for n, m in zip(n_in, n_out):
        assume(unet._resize_halo(unet._resize_matrix(n, m, mode), n // a) <= a)
    x = torch.randn((2,) + n_in + (3,), generator=torch.Generator().manual_seed(seed))
    nchw = x.permute(0, 3, 1, 2)
    want = unet._resize(nchw, n_out, mode)
    weights = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet, "halo_exchange", _from_whole(x))
        for rank in range(2 * k):
            mesh = _layout((k, 2), rank)
            blk, out = spatial_block(mesh, (a, a)), spatial_block(mesh, (b, b))
            got = unet._block_resize(nchw[:, :, blk.rows(), blk.cols()], n_out, mode, mesh,
                                     weights)
            torch.testing.assert_close(got, want[:, :, out.rows(), out.cols()],
                                       rtol=1e-5, atol=1e-5)


def test_halo_exchange_makes_no_call_on_one_rank_and_refuses_a_narrow_block():
    """On a (1, 1) layout the halo is zeros and no collective is made; a
    halo wider than the neighbour's block raises before any collective."""
    x = torch.randn(1, 3, 4, 2)
    calls = []
    with _recorded(calls):
        y = halo_exchange(_layout((1, 1), 0), x, 2, 1)
        assert y.shape == (1, 7, 6, 2) and torch.equal(y[:, 2:5, 1:5], x)
        y[:, 2:5, 1:5] = 0.0
        assert not y.any()
        with pytest.raises(ValueError, match="wider than the neighbour's block"):
            halo_exchange(_layout((2, 1), 0), x, 4, 0)
    assert calls == []
