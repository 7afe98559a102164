"""Parity of the port's fused-tail path with the JAX package, on the CPU.

The fused block tail (``fused_tail=True``) folds each block's norm1 and time
scale-shift into a per-(sample, channel) affine and runs norm-apply, MLP and
outer skip as one kernel (K3); its window is cold-sampled by the
double-batch scan samplers. The same numpy inputs and the same weights go
through the JAX package (K3 in Pallas interpret mode) and the port (the
wrappers' plain versions on the CPU). Float32 results agree to a few float32
ulps of their largest magnitude, as in the other port tests; bf16 results to
bf16 precision, with the tolerances stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data.normalization import StandardNormalizer as JNormalizer
from spherical_dyffusion_tpu.data.packer import Packer as JPacker
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JConfig
from spherical_dyffusion_tpu.diffusion import build_schedule as j_build_schedule
from spherical_dyffusion_tpu.diffusion import sample_loop_scan as j_sample_loop_scan
from spherical_dyffusion_tpu.inference.prescriber import PrescriberConfig as JPrescriberConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.models.modules import MLP2d as JMLP2d
from spherical_dyffusion_tpu.models.modules import InstanceNorm2d as JInstanceNorm2d
from spherical_dyffusion_tpu.ops.fused_mlp import fused_block_tail as jax_fused_block_tail
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import (
    InterpolationExperiment as JInterpolation,
)
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import (
    DYffusionConfig,
    build_schedule,
    sample_loop,
    sample_loop_scan,
    select_sampler,
)
from spherical_dyffusion_tpu_torch.models.modules import MLP2d, InstanceNorm2d
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    fused_block_tail,
    fused_block_tail_plain,
    fused_mlp_plain,
)
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

GRID = (16, 32)
N_STATE = 5
# The fused-tail window in bf16 (norm1 folded into K3; x rounded to bf16,
# then the folded input once more) against the plain path in bf16 (norm1 in
# float32, rounded once at the first Dense; the MLP unfused), dropout off,
# as a multiple of the plain path's own bf16 error (bf16 against float32).
# Measured at debug size (3 layers, horizon 6, 12 steps): 5.5e-3 of the
# largest model-driven prediction against 7.3e-3, a ratio of 0.76.
# chip_smoke.py holds the full-size window to the same ratio bound: a ratio
# scales with width and depth where an absolute gap does not.
BF16_TAIL_VS_PLAIN = 2.0


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rand(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ the fold

@pytest.mark.parametrize("exact", [False, True])
def test_instance_norm_fold_matches_jax(exact):
    """``fold=True`` returns (A, B) with norm(x) = x * A + B, float32
    (B, 1, 1, C), from the float32 statistics of x."""
    r = np.random.default_rng(0)
    x = _rand(r, 2, 8, 16, 12) * 3 + 1
    scale, bias = _rand(r, 12) + 1, _rand(r, 12)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ja, jb = JInstanceNorm2d(12, exact=exact).apply(params, jnp.asarray(x), fold=True)
    norm = InstanceNorm2d(12, exact=exact)
    norm.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        a, b = norm(torch.from_numpy(x), fold=True)
        y = norm(torch.from_numpy(x))
    assert a.shape == b.shape == (2, 1, 1, 12) and a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((torch.from_numpy(x) * a + b).numpy(), y.numpy(), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ K3's plain form

def _tail_operands(seed, B=2, H=8, W=16, C=12, Hd=24):
    r = np.random.default_rng(seed)
    return dict(x=_rand(r, B, H, W, C, scale=0.5), a=_rand(r, B, 1, 1, C, scale=0.1) + 1.0,
                c=_rand(r, B, 1, 1, C, scale=0.1), w1=_rand(r, C, Hd, scale=0.2),
                b1=_rand(r, Hd, scale=0.1), w2=_rand(r, Hd, C, scale=0.2),
                b2=_rand(r, C, scale=0.1), res=_rand(r, B, H, W, C))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [True, False])
def test_fused_block_tail_plain_matches_jax_kernel(dtype, with_residual):
    """B = 2, 128 rows per sample against tiles of 64 (JAX grid (B, 2)).
    float32: 2e-6 absolute, as the JAX package's own test of the kernel.
    bf16: x, the folded input and the hidden tensor are rounded to bf16 on
    both sides, and a tie may round either way: 1e-2 of the largest output."""
    o = _tail_operands(1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    res = o["res"] if with_residual else None
    want = jax_fused_block_tail(
        jnp.asarray(o["x"]).astype(jdt), jnp.asarray(o["a"]), jnp.asarray(o["c"]),
        jnp.asarray(o["w1"]), jnp.asarray(o["b1"]), jnp.asarray(o["w2"]), jnp.asarray(o["b2"]),
        residual=None if res is None else jnp.asarray(res), tile_rows=64, interpret=True)
    got = fused_block_tail(
        torch.from_numpy(o["x"]).to(tdt), torch.from_numpy(o["a"]), torch.from_numpy(o["c"]),
        torch.from_numpy(o["w1"]), torch.from_numpy(o["b1"]), torch.from_numpy(o["w2"]),
        torch.from_numpy(o["b2"]), residual=None if res is None else torch.from_numpy(res))
    assert got.shape == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    else:
        assert _rel(got.float(), np.asarray(want, np.float32)) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_tail_plain_rows_and_unit_affine(dtype):
    """Dropout on, two samples of 77 rows (a 64-row tile holds rows of both
    samples): every row takes its own sample's A and C and the Philox row
    b * N + n, so the tail equals K2's plain version on the folded rows bit
    for bit; with A = 1, C = 0 it equals K2's plain version on x itself."""
    o = _tail_operands(2, H=7, W=11)
    x = torch.from_numpy(o["x"]).to(dtype)
    a, c = torch.from_numpy(o["a"]), torch.from_numpy(o["c"])
    w = [torch.from_numpy(o[k]) for k in ("w1", "b1", "w2", "b2")]
    res = torch.from_numpy(o["res"])
    kw = dict(seed=123456789, drop_rate=0.1)
    got = fused_block_tail_plain(x, a, c, *w, res, **kw)
    xn = (x.float() * a + c).to(dtype)
    assert torch.equal(got, fused_mlp_plain(xn, *w, res, **kw))
    got1 = fused_block_tail_plain(x, torch.ones_like(a), torch.zeros_like(c), *w, res, **kw)
    assert torch.equal(got1, fused_mlp_plain(x, *w, res, **kw))
    assert (got == res).any()  # dropout fired: a dropped output is the residual alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_tail_plain_unit_affine_drops_what_k2_drops(dtype):
    """No residual, dropout on, rows 2 x 77 (ragged 16-row and 32-column
    blocks of the Philox layout): K3's plain version at A = 1, C = 0 zeroes
    exactly the outputs that K2's plain version zeroes, at the keep rate of
    both masks."""
    o = _tail_operands(4, H=7, W=11, C=16, Hd=48)
    x = torch.from_numpy(o["x"]).to(dtype)
    w = [torch.from_numpy(o[k]) for k in ("w1", "b1", "w2", "b2")]
    kw = dict(seed=2**40 + 17, drop_rate=0.25)
    got = fused_block_tail_plain(x, torch.ones(2, 1, 1, 16), torch.zeros(2, 1, 1, 16), *w,
                                 **kw)
    want = fused_mlp_plain(x, *w, **kw)
    assert torch.equal(got == 0, want == 0)
    assert torch.equal(got, want)
    dropped = (got == 0).float().mean().item()
    assert 0.1 < dropped < 0.45  # the output mask drops a quarter of the outputs


def test_fused_block_tail_validation():
    o = _tail_operands(3)
    args = [torch.from_numpy(o[k]) for k in ("x", "a", "c", "w1", "b1", "w2", "b2")]
    with pytest.raises(ValueError, match="keep-nothing"):
        fused_block_tail(*args, seed=1, drop_rate=0.999)
    with pytest.raises(ValueError, match="requires a seed"):
        fused_block_tail(*args, drop_rate=0.1)
    with pytest.raises(ValueError, match="affine"):
        fused_block_tail(args[0], args[1][:1], *args[2:])
    before = fused_block_tail.launches
    fused_block_tail(*args)  # CPU tensors: the plain version, no launch
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block_tail(*meta)
    assert fused_block_tail.launches == before


@pytest.mark.parametrize("fused", [True, False])
def test_mlp2d_affine_matches_jax(fused):
    """MLP2d with ``affine``: the fused form (K3; the JAX kernel interpreted)
    and the unfused form (the fold applied in float32 before Dense_0)."""
    o = _tail_operands(4)
    jm = JMLP2d(hidden_features=24, out_features=12, fused=fused)
    x = jnp.asarray(o["x"])
    params = jm.init(jax.random.PRNGKey(0), x)
    aff = (jnp.asarray(o["a"]), jnp.asarray(o["c"]))
    want = jm.apply(params, x, residual=jnp.asarray(o["res"]), affine=aff)
    tm = MLP2d(12, 24, 12, fused=fused)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(o["x"]), residual=torch.from_numpy(o["res"]),
                 affine=(torch.from_numpy(o["a"]), torch.from_numpy(o["c"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


# ---------------------------------------------------------------- the SFNO

def _sfno_kwargs(**kw):
    base = dict(img_shape=GRID, in_chans=7, out_chans=5, embed_dim=16, num_layers=3,
                operator_type="dhconv", with_time_emb=True, dropout_mlp=0.1,
                drop_path_rate=0.1, min_time=1, max_time=5, fused_tail=True,
                scan_layers=True)
    base.update(kw)
    return base


def _boost_filters(tree):
    """Scale the spectral weights up so the filter shows in the output (see
    tests/test_torch_port_sfno.py)."""
    return {k: (_boost_filters(v) if isinstance(v, dict) else
                (v * 64.0 if k == "weight" else v)) for k, v in tree.items()}


@pytest.mark.parametrize("before_filter", [True, False])
def test_sfno_fused_tail_matches_jax(before_filter):
    """SFNO(fused_tail=True, scan_layers=True), 3 layers (one scanned middle
    block), K1 on, with the time scale-shift before the filter and after it
    (then folded into the kernel's affine); float32, 1e-5 of the largest
    output. The JAX tree (middle block stacked) loads into the port, whose
    modules are the same with the tail on or off."""
    kw = _sfno_kwargs(time_scale_shift_before_filter=before_filter, use_pallas=True)
    r = np.random.default_rng(5)
    x, cond = _rand(r, 2, *GRID, 5), _rand(r, 2, *GRID, 2)
    t = np.asarray([1.0, 3.5], np.float32)
    jm = JSFNO(JSFNOConfig(**kw))
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), time=jnp.asarray(t),
                        static_condition=jnp.asarray(cond))
    variables = {**variables, "params": _boost_filters(variables["params"])}
    assert "blocks_mid" in variables["params"]
    want = np.asarray(jm.apply(variables, jnp.asarray(x), time=jnp.asarray(t),
                               static_condition=jnp.asarray(cond)))
    model = SFNO(SFNOConfig(**kw))
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(SFNO(SFNOConfig(**{**kw, "fused_tail": False})).state_dict())
    model.load_state_dict(sd)
    assert all(b.use_tail for b in model.blocks)
    with torch.no_grad():
        got = model(torch.from_numpy(x), time=torch.from_numpy(t),
                    static_condition=torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (2, *GRID, 5)
    assert _rel(got, want) <= 1e-5


def test_sfno_fused_tail_gating_and_live_drop_path():
    """The tail needs instance norm, an MLP and a gelu, as in the JAX
    package; with dropout live the block keeps DropPath outside the kernel
    and the forward stays seeded."""
    assert not any(b.use_tail for b in SFNO(SFNOConfig(**_sfno_kwargs(
        activation_function="relu"))).blocks)
    assert not any(b.use_tail for b in SFNO(SFNOConfig(**_sfno_kwargs(
        normalization_layer="none"))).blocks)
    model = SFNO(SFNOConfig(**_sfno_kwargs()))
    model.init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(6)
    x, cond = torch.from_numpy(_rand(r, 2, *GRID, 5)), torch.from_numpy(_rand(r, 2, *GRID, 2))
    kw = dict(time=torch.tensor([1.0, 2.0]), static_condition=cond)
    with torch.no_grad():
        det = model(x, **kw)
        a = model(x, **kw, deterministic=False, generator=torch.Generator().manual_seed(1))
        b = model(x, **kw, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, det)


# ------------------------------------------------------------- the samplers

def _toys(mod, calls=None):
    """(interpolate_fn, forecast_fn) in jnp or torch with the same math; the
    torch interpolator records its batch sizes in ``calls``."""
    sin = jnp.sin if mod is jnp else torch.sin

    def interpolate_fn(x_end, x_last, t, rng, static_condition=None, **_):
        if calls is not None:
            calls.append(x_last.shape[0])
        w = (t / 6.0)[:, None, None, None]
        out = (1 - w) * x_end + w * x_last + 0.1 * sin(3.0 * x_last)
        if static_condition is not None:
            out = out + 0.01 * static_condition[..., :1]
        return out

    def forecast_fn(x_t, time, condition, static_condition=None):
        out = 0.9 * x_t + 0.05 * time[:, None, None, None] + 0.1 * sin(x_t)
        if static_condition is not None:
            out = out - 0.02 * static_condition[..., 1:2]
        return out

    return interpolate_fn, forecast_fn


SAMPLER_CASES = [{}, {"additional_interpolation_steps": 2},
                 {"schedule": "linear", "additional_interpolation_steps_factor": 1}]


@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)))
@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("horizon", [6, 3])
def test_scan_samplers_match_jax(horizon, peel, case):
    """The uniform (masked ends) and peeled (degenerate ends) double-batch
    samplers against the JAX package's, and against the port's sample_loop;
    the interpolator sees the double batch, and single batches only at the
    peeled ends."""
    kw = dict(timesteps=horizon, peel_sampler=peel, **SAMPLER_CASES[case])
    r = np.random.default_rng(horizon + 10 * case)
    x0, static = _rand(r, 2, 4, 6, 3), _rand(r, 2, 4, 6, 2)
    jcfg, tcfg = JConfig(**kw), DYffusionConfig(**kw)
    sched = build_schedule(tcfg)
    assert select_sampler(tcfg, sched) is sample_loop_scan
    jout = j_sample_loop_scan(*_toys(jnp), jcfg, j_build_schedule(jcfg), jnp.asarray(x0),
                              jax.random.PRNGKey(0), static_condition=jnp.asarray(static))
    calls = []
    tout = sample_loop_scan(*_toys(torch, calls), tcfg, sched, torch.from_numpy(x0),
                            torch.Generator().manual_seed(0),
                            static_condition=torch.from_numpy(static))
    ref = sample_loop(*_toys(torch), tcfg, sched, torch.from_numpy(x0),
                      static_condition=torch.from_numpy(static))
    assert sorted(tout.preds) == sorted(jout.preds) == sorted(ref.preds)
    for k in jout.preds:
        np.testing.assert_allclose(tout.preds[k].numpy(), np.asarray(jout.preds[k]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tout.preds[k].numpy(), ref.preds[k].numpy(), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(tout.x_last.numpy(), np.asarray(jout.x_last), rtol=0, atol=1e-5)
    N = sched.num_timesteps
    if peel and N >= 3:
        assert calls == [2] + [4] * (N - 2) + [2]
    else:
        assert calls == [4] * N


def test_sampler_choice_follows_jax():
    """Scan form when scan_compatible, sample_loop otherwise; the scan form
    refuses a config that is not scan_compatible."""
    for kw in ({"use_cold_sampling_for_last_step": False}, {"sampling_type": "naive"},
               {"refine_intermediate_predictions": True},
               {"additional_interpolation_steps": 3, "sampling_schedule": "every2"}):
        cfg = DYffusionConfig(timesteps=4, **kw)
        assert select_sampler(cfg, build_schedule(cfg)) is sample_loop
        with pytest.raises(ValueError, match="scan-compatible"):
            sample_loop_scan(*_toys(torch), cfg, build_schedule(cfg), torch.zeros(1, 2, 2, 1))


# ------------------------------------------------------- the fused-tail window

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_stepper(horizon, dtype, layers=3, seed=0):
    """bench.py:build(..., fused_tail=True, scan_layers=True, peel=True) at
    debug size, dropout off."""
    names = main_path.state_names(N_STATE)
    forcing = list(main_path.FORCING_NAMES)
    norm = JNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names}, names)
    fnorm = JNormalizer.from_dicts({n: 0.0 for n in forcing}, {n: 1.0 for n in forcing},
                                   forcing)
    packer = JPacker(names)
    icfg, fcfg = main_path.sfno_configs(16, layers, dtype, GRID, horizon, N_STATE,
                                        use_pallas=True, fused_mlp=False, fused_tail=True,
                                        scan_layers=True)
    imodel = JSFNO(JSFNOConfig(**_fields(icfg)))
    fmodel = JSFNO(JSFNOConfig(**_fields(fcfg)))
    x = jnp.zeros((1,) + GRID + (N_STATE,))
    cond = jnp.zeros((1,) + GRID + (len(forcing),))
    ip = imodel.init(jax.random.PRNGKey(seed), jnp.concatenate([x, x], -1),
                     time=jnp.ones((1,)), static_condition=cond)
    fp = fmodel.init(jax.random.PRNGKey(seed + 1), x, time=jnp.zeros((1,)),
                     static_condition=cond)
    ip = {**ip, "params": _boost_filters(ip["params"])}
    fp = {**fp, "params": _boost_filters(fp["params"])}
    interp = JInterpolation(imodel, JExperimentConfig(horizon=horizon, window=1,
                                                      enable_inference_dropout=True),
                            packer, packer, norm)
    dcfg = JConfig(timesteps=horizon, forward_conditioning="none", time_encoding="dynamics",
                   peel_sampler=True, enable_interpolator_dropout=False)
    exp = JForecasting(fmodel, interp, ip, dcfg, JExperimentConfig(horizon=horizon), packer,
                       packer, norm, forcing_names=forcing, forcing_normalizer=fnorm)
    prescriber = JPrescriberConfig("surface_temperature", main_path.MASK_NAME, 1).build(names)
    return JStepper(exp, fp, prescriber=prescriber), {"interpolator": ip, "forecaster": fp}


def _port_window(params, horizon, n_steps, inp, dtype, **kw):
    stepper = main_path.build(embed=16, layers=3, dtype=dtype, img_shape=GRID,
                              horizon=horizon, n_state=N_STATE, device="cpu",
                              flax_params=params, enable_interpolator_dropout=False, **kw)
    batches = []
    stepper.exp.interpolator.model.register_forward_pre_hook(
        lambda mod, args: batches.append(args[0].shape[0]))
    _, preds = stepper.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                                  torch.Generator().manual_seed(0), n_steps)
    return preds.float().numpy(), batches


TAIL = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True)


def test_run_window_fused_tail_matches_jax():
    """The fused-tail window of the main path (horizon 6, 12 steps, peeled
    sampler, K1 and K3 routes, 3 layers) against the JAX stepper with K3
    interpreted: float32, 1e-5 of the largest prediction. Then in bf16: the
    port's fused tail against the plain path (the comparison chip_smoke.py
    makes on the card), within BF16_TAIL_VS_PLAIN times the plain path's
    bf16 error."""
    horizon, n_steps = 6, 12
    jstep, params = _jax_stepper(horizon, "float32")
    inp = main_path.window_inputs(n_steps, GRID, N_STATE, seed=horizon, device="cpu")
    _, jpreds = jstep.run_window(
        jnp.asarray(inp["x0"].numpy()), jnp.asarray(inp["forcing"].numpy()),
        jnp.asarray(inp["sst"].numpy()), jnp.asarray(inp["mask"].numpy()),
        jax.random.PRNGKey(0), n_steps)
    got, batches = _port_window(params, horizon, n_steps, inp, "float32", **TAIL)
    assert got.shape == (1, n_steps) + GRID + (N_STATE,)
    assert _rel(got, np.asarray(jpreds)) <= 1e-5
    n_seg = -(-n_steps // horizon)
    assert batches == ([1] + [2] * (horizon - 2) + [1]) * n_seg

    tail, _ = _port_window(params, horizon, n_steps, inp, "bfloat16", **TAIL)
    plain = {dt: _port_window(params, horizon, n_steps, inp, dt, use_pallas=False,
                              fused_mlp=False)[0] for dt in ("bfloat16", "float32")}
    gap = np.abs(tail - plain["bfloat16"]).max()
    noise = np.abs(plain["bfloat16"] - plain["float32"]).max()
    assert np.isfinite(tail).all() and 0 < gap <= BF16_TAIL_VS_PLAIN * noise, (gap, noise)
