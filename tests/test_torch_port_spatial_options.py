"""The SFNO's options on a grid split over "h" and "w", on the CPU, against
JAX's sharded SFNO and against one process.

Four gloo ranks, spawned once for the module
(``test_torch_port_parallel_workers.py:start_options``, which imports no
JAX), run every option of ``workers.OPTIONS`` on ``make_mesh(data=1, h=2,
w=2)`` (the folded Legendre stage with bf16 operands, the FFT longitude
stage and the CP rank pipeline; the planar FFT transform with
``scale_factor`` and spectral attention among them), the rank pipelines
(CP, CP through K4's plain version, Tucker) and the folded stage also on
"h" = 2 and on "w" = 2 alone, K4's two routes, the folded stage on "h" = 4
(ranks 0 and 3, 1 and 2 mirror each other) and, at 18 x 32 on ranks 0-2,
on "h" = 3, whose middle rank holds the equator and pairs with itself;
each forward is gathered. While they run, this process computes the one-process forwards
and JAX's (weights carried from the port by ``state_dict_to_flax``, JAX's
SHT matrices from the same jitted apply):

(a) dropout off, the gathered forward against JAX's SFNO jitted with the
    input sharded ``P("data", "h", "w", None)`` on the same layout of the
    virtual CPU devices, as ``tests/test_parallel.py:47``: float32 within
    ``atol=2e-5, rtol=1e-4``; with bf16 operands or spectral IO (JAX's CPU
    fallback to float32 lifted, as ``tests/test_torch_port_options.py``'s
    ``jax_bf16``) within twice the port's own one-process error against the
    same JAX forward;
(b) dropout live (quantized, and at the exact rate with ``exact_dropout``),
    the gathered forward against the one-process forward from the same
    generator, within 1e-5 of its largest value: the same elements dropped,
    the sums over ranks reordered (the float32 options; the draws do not
    depend on the matmul dtype);
(c) the main path's window with the ``data+noise-v1`` forecaster
    conditioning, and the fused-tail window with the folded Legendre stage,
    on "h" = 2 against the one-process window (the noise drawn for the
    whole grid and sliced);
(d) in this process, K4's plain version with a block's synthesis rows equal
    to the whole grid's restricted to those rows, the folded analysis over
    the latitude pairs each "h" rank owns summed over the ranks and the
    folded synthesis of each rank's rows against the whole grid's, and the
    planar FFT's two stages against its forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import spherical_dyffusion_tpu.ops.contractions as jcontractions
import spherical_dyffusion_tpu.ops.sht as jsht
import test_torch_port_parallel_workers as workers
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.parallel import batch_sharding as jbatch_sharding
from spherical_dyffusion_tpu.parallel import make_mesh as jmake_mesh
from spherical_dyffusion_tpu_torch.models.sfno import SFNO
from spherical_dyffusion_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
from spherical_dyffusion_tpu_torch.parallel.distributed_sht import mirror_pairs
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax
from test_torch_port_options import _Float32Dots

torch.set_num_threads(2)

JAX_MESHES = {"h2w2": dict(data=1, h=2, w=2), "h2": dict(data=1, h=2), "w2": dict(data=1, w=2),
              "h4": dict(data=1, h=4), "h3": dict(data=1, h=3)}
# the largest error of a one-process bf16 forward against JAX that the bf16
# comparison accepts as a yardstick (tests/test_torch_port_options.py's
# REL_BF16_SFNO); a float32 forward of the same weights misses JAX's bf16
# forward by more than F32_MISSES_BF16, so the comparison sees the rounding
REL_BF16_SFNO = 1e-2
F32_MISSES_BF16 = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_forwards() -> dict:
    """JAX's SFNO of each option, dropout off, jitted on each mesh layout of
    ``workers.OPTION_MESHES`` with the input sharded over "h" and "w": by
    (mesh, option). K4 is the port's, so its options share the reference of
    the pipeline without it."""
    out, done = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsht, jcontractions):  # bf16 operands, float32 sums, as on the TPU
            mp.setattr(mod, "_effective_matmul_dtype", lambda requested: requested)
            mp.setattr(mod, "jnp", _Float32Dots())
        for key, names in workers.OPTION_MESHES.items():
            n = int(np.prod(list(JAX_MESHES[key].values())))
            mesh = jmake_mesh(**JAX_MESHES[key], devices=jax.devices()[:n])
            for name in names:
                cfg = workers.option_config(name)
                x, t = workers.sfno_inputs(cfg.img_shape)
                xj, tj = jnp.asarray(x.numpy()), jnp.asarray(t.numpy())
                if name == "exact dropout":
                    continue
                if (key, cfg) in done:
                    out[(key, name)] = done[(key, cfg)]
                    continue
                model = JSFNO(JSFNOConfig(**{f.name: getattr(cfg, f.name)
                                             for f in dataclasses.fields(cfg)}))
                params = state_dict_to_flax(workers.option_sfno(name).state_dict())["params"]
                fwd = jax.jit(lambda p, x, t, model=model: model.apply(
                    {"params": p}, x, time=t, mutable=["constants"])[0])
                y = np.asarray(fwd(jax.device_put(params, NamedSharding(mesh, P())),
                                   jax.device_put(xj, jbatch_sharding(mesh, 4, spatial=True)),
                                   jax.device_put(tj, NamedSharding(mesh, P("data")))))
                out[(key, name)] = done[(key, cfg)] = y
    return out


def _one_process() -> dict:
    """The one-process forwards of every option (dropout off and live), and
    the noised window with its conditioning and with ``"data"`` instead."""
    out = {}
    for name in workers.OPTIONS:
        model = workers.option_sfno(name)
        out[name] = dict(det=workers.option_forward(model, False),
                         drop=workers.option_forward(model, True), model=model)
        if name in workers.BF16_OPTIONS:  # the same weights, computed in float32
            f32 = SFNO(dataclasses.replace(model.cfg, sht_matmul_dtype="float32",
                                           spectral_io_dtype=""), fused_rank=model.fused_rank)
            f32.load_state_dict(model.state_dict())
            out[name]["f32"] = workers.option_forward(f32, False)
    out["fold_window"] = workers.spatial_window(workers.fold_window_stepper())
    out["unfolded_window"] = workers.spatial_window(
        workers.spatial_window_stepper("k3", True, sht_fold_symmetry=False))
    st_ = workers.noised_window_stepper()
    out["noised"] = workers.spatial_window(st_)
    st_.exp.diffusion_cfg = dataclasses.replace(st_.exp.diffusion_cfg,
                                                forward_conditioning="data")
    out["data"] = workers.spatial_window(st_)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the one-process runs and JAX's forwards; the ranks
    start first and run while this process computes the rest."""
    out = str(tmp_path_factory.mktemp("options"))
    ctx = workers.start_options(out)
    one, jax_out = _one_process(), _jax_forwards()
    return workers.results(ctx, 4, out), one, jax_out


def _ranks(ranks, key):
    """The ranks that ran mesh ``key`` (both two-rank meshes of "h" = 2 or
    "w" = 2 alone run the same work; rank 3 is outside "h" = 3)."""
    return [r[key] for r in ranks if key in r]


A_CASES = [(key, name) for key, names in workers.OPTION_MESHES.items() for name in names
           if name != "exact dropout"]
B_CASES = [(key, name) for key, names in workers.OPTION_MESHES.items() for name in names
           if name not in workers.BF16_OPTIONS]


@pytest.mark.parametrize("key,name", A_CASES)
def test_option_without_dropout_matches_jax_sharded_sfno(runs, key, name):
    ranks, one, jax_out = runs
    want = jax_out[(key, name)]
    model = one[name]["model"]
    if "pipeline" in name:
        assert [b.filter.rank_pipeline for b in model.blocks] == [False, True, False]
        assert model.blocks[1].filter.fused_rank == ("K4" in name)
    for r in _ranks(ranks, key):
        got = r[name]["det"]
        assert got.shape == (2,) + model.cfg.img_shape + (workers.OUT,)
        if name in workers.BF16_OPTIONS:
            own = _rel(one[name]["det"], want)
            assert 0.0 < own <= REL_BF16_SFNO, own
            assert _rel(got, want) <= 2.0 * own, (_rel(got, want), own)
            assert _rel(one[name]["f32"], want) > F32_MISSES_BF16  # bf16 rounding did run
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("key,name", B_CASES)
def test_option_with_dropout_equals_one_process(runs, key, name):
    ranks, one, _ = runs
    want = one[name]["drop"]
    assert not torch.allclose(want, one[name]["det"])  # the dropout did run
    for r in _ranks(ranks, key):
        got = r[name]["drop"]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_noised_conditioning_window_on_h2_equals_one_process(runs):
    """The ``data+noise-v1`` window (K1, K3, the peeled sampler, the
    interpolator's dropout live) on "h" = 2: the final state and the
    predictions of every rank within 1e-5 of the one-process window's
    largest prediction; the noise moves the window (against ``"data"``)."""
    ranks, one, _ = runs
    x1, p1 = one["noised"]
    assert p1.shape == (2, workers.WINDOW_STEPS) + workers.GRID + (workers.STATE,)
    assert not torch.allclose(p1, one["data"][1])
    scale = float(p1.abs().max())
    for r in ranks:
        x, p = r["noised"]
        assert float((p - p1).abs().max()) <= 1e-5 * scale
        assert float((x - x1).abs().max()) <= 1e-5 * scale


def test_folded_window_on_h2_equals_one_process(runs):
    """The fused-tail window (K1, K3, the peeled sampler, the interpolator's
    dropout live) with the folded Legendre stage on "h" = 2: the final state
    and the predictions of every rank within 1e-5 of the one-process
    window's largest prediction; folding moves the window's last bits only
    (against the unfolded window, within 1e-4)."""
    ranks, one, _ = runs
    x1, p1 = one["fold_window"]
    assert p1.shape == (2, workers.WINDOW_STEPS) + workers.GRID + (workers.STATE,)
    scale = float(p1.abs().max())
    assert not torch.equal(p1, one["unfolded_window"][1])
    assert float((p1 - one["unfolded_window"][1]).abs().max()) <= 1e-4 * scale
    for r in ranks:
        x, p = r["fold_window"]
        assert float((p - p1).abs().max()) <= 1e-5 * scale
        assert float((x - x1).abs().max()) <= 1e-5 * scale


def _folded_transforms(data):
    """A folded SHT pair at a drawn even grid, grid type and matmul dtype,
    with a drawn "h" size that divides the latitudes (odd ones included)."""
    H = data.draw(st.sampled_from([6, 8, 10, 12, 18]))
    nh = data.draw(st.sampled_from([d for d in range(1, H + 1) if H % d == 0]))
    kw = dict(grid=data.draw(st.sampled_from(["equiangular", "legendre-gauss"])),
              matmul_dtype=data.draw(st.sampled_from(["float32", "bfloat16"])),
              fold_symmetry=True)
    fwd, inv = RealSHT(H, 2 * H, **kw), InverseRealSHT(H, 2 * H, **kw)
    assert fwd.folded and inv.folded
    g = torch.Generator().manual_seed(data.draw(st.integers(0, 2**16)))
    return H, nh, fwd, inv, g


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_folded_analysis_over_the_mirror_pairs_of_each_rank(data):
    """The latitude pairs that ``mirror_pairs`` gives the ranks of "h" cover
    every pair once, and each rank's ``folded_pairs`` (its kept rows and
    the mirror rank's sent rows, as ``distributed_sht`` forms them), summed
    over the ranks, is the folded analysis of the whole grid (float32, 1e-6
    of the largest value)."""
    H, nh, fwd, _, g = _folded_transforms(data)
    xf = torch.randn(2, H, H + 1, 3, 2, generator=g)
    k = H // nh
    blocks = [xf[:, r * k:(r + 1) * k] for r in range(nh)]
    total, owned = torch.zeros(()), []
    for i in range(nh):
        j = nh - 1 - i
        keep, send, north = mirror_pairs(H, nh, i)
        owned += list(range(H))[north]
        mine = blocks[i][:, :keep]
        if i == j:
            part = fwd.folded_pairs(mine, blocks[i][:, keep:].flip(1), north)
        else:
            assert mirror_pairs(H, nh, j)[1] == keep  # the mirror sends what this rank keeps
            theirs = blocks[j][:, k - keep:]
            part = fwd.folded_pairs(*((mine, theirs.flip(1)) if i < j else
                                      (theirs, mine.flip(1))), north)
        total = total + part
    assert sorted(owned) == list(range(H // 2))
    want = fwd._folded(xf)
    assert total.shape == want.shape
    assert float((total - want).abs().max()) <= 1e-6 * float(want.abs().max())


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_folded_synthesis_of_each_ranks_rows(data):
    """``folded_rows`` of each rank's rows, concatenated over the ranks of
    "h", is the folded synthesis of the whole grid: bit for bit where each
    block's rows mirror to the whole northern half ("h" = 1 or 2: the same
    products), else within 1e-6 of the largest value (the CPU's GEMM sums a
    product of fewer rows in another order)."""
    H, nh, _, inv, g = _folded_transforms(data)
    x = torch.randn(2, H, H + 1, 3, 2, generator=g)
    k = H // nh
    got = torch.cat([inv.folded_rows(x, slice(r * k, (r + 1) * k)) for r in range(nh)], dim=1)
    want = inv._folded(x)
    assert got.shape == want.shape == (2, H, H + 1, 3, 2)
    if nh <= 2:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_planar_fft_stages_compose_to_the_forward(data):
    """``RealFFT2``'s ``latitude(longitude(x))`` and ``InverseRealFFT2``'s
    ``longitude(latitude(x))`` equal the one-expression 2-D transforms (the
    real FFT over W, the FFT over H and the kept rows; the scatter into the
    full spectrum, the inverse FFT over H and the inverse real FFT over W)
    bit for bit, at any truncation."""
    H = data.draw(st.integers(2, 12))
    W = data.draw(st.integers(2, 12)) * 2
    lmax = data.draw(st.integers(1, H))
    mmax = data.draw(st.integers(1, W // 2 + 1))
    g = torch.Generator().manual_seed(data.draw(st.integers(0, 2**16)))
    fwd, inv = RealFFT2(H, W, lmax, mmax), InverseRealFFT2(H, W, lmax, mmax)
    x = torch.randn(2, H, W, 3, generator=g)
    s = torch.randn(2, lmax, mmax, 3, 2, generator=g)
    lpos, lneg = (lmax + 1) // 2, lmax // 2
    two_d = torch.view_as_real(torch.fft.fft(
        torch.fft.rfft(x, dim=-2, norm="ortho")[..., :mmax, :], dim=-3, norm="ortho"))
    want_f = torch.cat([two_d[:, :lpos]] + ([two_d[:, H - lneg:]] if lneg else []), dim=1)
    full = torch.zeros(2, H, W // 2 + 1, 3, dtype=torch.complex64)
    sc = torch.view_as_complex(s)
    full[:, :lpos, :mmax] = sc[:, :lpos]
    if lneg:
        full[:, H - lneg:, :mmax] = sc[:, lpos:]
    want_i = torch.fft.irfft(torch.fft.ifft(full, dim=-3, norm="ortho"), n=W, dim=-2,
                             norm="ortho")
    xf = fwd.longitude(x)
    assert xf.shape == (2, H, mmax, 3, 2)
    assert torch.equal(fwd.latitude(xf), want_f) and torch.equal(fwd(x), want_f)
    y = inv.latitude(s)
    assert y.shape == (2, H, W // 2 + 1, 3, 2)
    assert torch.equal(inv.longitude(y), want_i) and torch.equal(inv(s), want_i)


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.data())
def test_k4_plain_with_a_blocks_synthesis_rows(data):
    """K4 (the wrapper on the CPU: its plain version) with the whole
    analysis and the synthesis rows of a block of latitudes, at any origin:
    the whole grid's result restricted to those rows (float32 to 1e-6 of
    the largest value; bf16 to one bf16 step of each value, as a float32 sum
    in another order may round the other way)."""
    H, L, B, R = 12, 7, 2, 3
    dtype = data.draw(st.sampled_from([torch.float32, torch.bfloat16]))
    n = data.draw(st.integers(1, H))
    h0 = data.draw(st.integers(0, H - n))
    kw = dict(grid="legendre-gauss", matmul_dtype=dtype, kernel_layout=True)
    fwd, inv = RealSHT(H, 2 * H, L, L, **kw), InverseRealSHT(H, 2 * H, L, L, **kw)
    g = torch.Generator().manual_seed(data.draw(st.integers(0, 2**16)))
    xf = torch.randn(B, H, L, 2 * R, 2, generator=g).to(dtype)
    C = torch.randn(L, R, 2, generator=g)
    l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
    rows = inv.synthesis_mhl[:, h0:h0 + n].contiguous()
    got = fused_rank(xf, fwd.analysis_mhl, rows, C, l_first)
    want = fused_rank_plain(xf, fwd.analysis_mhl, inv.synthesis_mhl, C)[:, h0:h0 + n]
    assert got.shape == want.shape == (B, n, L, 2 * R, 2) and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-6 * float(want.abs().max())
    else:
        assert bool((diff <= 2.0 ** -7 * want.float().abs()).all())
