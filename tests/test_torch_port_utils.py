"""The port's parameter tools, wind conversions, runs query, profiling, native
packer, DCP checkpoints and PNG plots against the JAX package's, on the CPU.

Debug sizes: the SFNO at embed 16, 2 layers, 16 x 32, weights from a seed.
Tolerances: names, masks, copies, packed arrays, checkpoint round trips and
pixels bit for bit; wind conversions (float32 sin/cos of torch against
XLA's) 1e-5 of each value; three AdamW steps against optax's masked
``adamw`` 1e-4 of the learning rate plus one float32 rounding of the value
(optax's float32 bias corrections round about 6e-6 of an update apart; an
update without the weight decay would be 1e-2 of it away).
"""

import ast
import collections
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spherical_dyffusion_tpu.utils.params as jparams
import spherical_dyffusion_tpu.utils.runs_api as jruns_api
from spherical_dyffusion_tpu.utils import native as jnative
from spherical_dyffusion_tpu.utils import profiling as jprofiling
from spherical_dyffusion_tpu.utils import winds as jwinds
from spherical_dyffusion_tpu_torch.data import datasets
from spherical_dyffusion_tpu_torch.evaluation import plots
from spherical_dyffusion_tpu_torch.interface import get_model
from spherical_dyffusion_tpu_torch.utils import convert, native, orbax_ckpt, params, profiling
from spherical_dyffusion_tpu_torch.utils import runs_api, winds
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)


def _sfno(layers=2, seed=0):
    return get_model({"kind": "sfno", "embed_dim": 16, "num_layers": layers}, (16, 32), 5, 3,
                     True, 0.0, 5.0, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _code(module) -> str:
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(inspect.getsource(module))
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return ast.dump(ast.Module(body=body, type_ignores=[]))


# ---------------------------------------------------------------- params

PATTERNS = [["block_0/filter/*"], ["encoder*", "*/norm*"], ["block_*/mlp/*"], ["time_emb/*"],
            ["nothing"]]


@pytest.mark.parametrize("patterns", PATTERNS)
def test_patterns_select_what_jax_selects(patterns):
    """A pattern written for JAX's '/'-joined names selects the same
    parameters of the port's SFNO (its state_dict names with '/')."""
    net = _sfno()
    tree = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(net.state_dict())["params"])
    assert sorted(params.param_names(net)) == sorted(jparams.param_names(tree))
    assert params.param_names(net.state_dict()) == params.param_names(net)
    jmask = {jparams._name(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        jparams.freeze_mask(tree, patterns))}
    assert params.freeze_mask(net, patterns) == jmask
    for name in params.param_names(net):
        assert params.matches_any(name, patterns) == jparams.matches_any(name, patterns)


def test_frozen_optimizer_matches_optax_masked():
    """Three AdamW steps on the same gradients: the frozen parameters do
    not move and have no optimizer state; the others follow optax's
    ``adamw`` under JAX's ``frozen_param_optimizer``."""
    net = _sfno()
    frozen = ["block_0/filter/*", "encoder*"]
    start = {k: v.clone() for k, v in net.state_dict().items()}
    tree = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(start)["params"])
    lr, wd = 1e-3, 5e-3
    opt = params.frozen_param_optimizer(
        lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=wd, eps=1e-8), net, frozen)
    tx = jparams.frozen_param_optimizer(optax.adamw(lr, weight_decay=wd, eps=1e-8), frozen)
    jstate = tx.init(tree)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[k]) if p.requires_grad else None
        opt.step()
        jg = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in grads.items()})["params"])
        upd, jstate = tx.update(jg, jstate, tree)
        tree = optax.apply_updates(tree, upd)
    want = flax_to_state_dict({"params": jax.device_get(tree)})
    stated = {id(p) for group in opt.param_groups for p in group["params"] if p in opt.state}
    for k, p in net.named_parameters():
        if params.matches_any(k.replace(".", "/"), frozen):
            assert torch.equal(p.detach(), start[k]) and torch.equal(want[k], start[k]), k
            assert id(p) not in stated and not p.requires_grad, k
        else:
            ulp = torch.finfo(torch.float32).eps * want[k].abs()
            assert bool(((p.detach() - want[k]).abs() <= 1e-4 * lr + ulp).all()), k
            assert not torch.equal(p.detach(), start[k]), k


def _trees():
    r = np.random.default_rng(1)
    target = {"encoder": {"kernel": r.standard_normal((2, 3)).astype(np.float32),
                          "bias": r.standard_normal(3).astype(np.float32)},
              "block_0": {"filter": {"weight": r.standard_normal((3, 3, 4, 2)).astype(
                  np.float32)}}}
    source = {"encoder": {"kernel": np.full((2, 3), 7.0, np.float32),
                          "bias": np.full((3,), 2.0, np.float32)},
              "block_0": {"filter": {"weight": np.full((2, 5, 4, 2), 5.0, np.float32)}},
              "extra": {"w": np.ones(2, np.float32)}}
    return target, source


@pytest.mark.parametrize("include,exclude", [(None, ()), (["encoder/bias"], ()),
                                             (None, ["encoder/*"]), (["block_*"], ["x"])])
def test_overwrite_weights_matches_jax(include, exclude):
    """By name, with the overlapping hyper-slab of a weight of another
    shape; the port on flat state_dicts, JAX on nested trees."""
    target, source = _trees()
    want = flax_to_state_dict({"params": jax.device_get(jparams.overwrite_weights(
        jax.tree_util.tree_map(jnp.asarray, target), jax.tree_util.tree_map(jnp.asarray, source),
        include, exclude))})
    got = params.overwrite_weights(flax_to_state_dict(target), flax_to_state_dict(source),
                                   include, exclude)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_parameter_init_matches_jax():
    """``ParameterInitConfig``'s fields are JAX's; ``apply_parameter_init``
    loads the source's weights into a module in place as JAX returns them."""
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(params.ParameterInitConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jparams.ParameterInitConfig)]
    net, src = _sfno(seed=0), _sfno(seed=1)
    cfg = params.ParameterInitConfig(weights_path="unused", exclude=["block_1/*"])
    tree = {"params": jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        net.state_dict())["params"])}
    jsrc = {"params": jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        src.state_dict())["params"])}
    want = flax_to_state_dict(jax.device_get(jparams.apply_parameter_init(
        tree, jparams.ParameterInitConfig(weights_path="unused", exclude=["params/block_1/*"]),
        load_fn=lambda p: jsrc)))
    assert params.apply_parameter_init(net, cfg, load_fn=lambda p: src.state_dict()) is net
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert params.apply_parameter_init(net, params.ParameterInitConfig()) is net


def test_block_layouts_match_jax():
    """stack, unstack and adapt on the same trees as JAX's; the port's
    loaders use this module's ``unstack_block_params``."""
    net = _sfno(layers=4)
    unrolled = state_dict_to_flax(net.state_dict())["params"]
    stacked = params.stack_block_params(unrolled)
    jstacked = jax.device_get(jparams.stack_block_params(
        jax.tree_util.tree_map(jnp.asarray, unrolled)))

    def leaves(t):
        return {jparams._name(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(t)}

    a, b = leaves(stacked), leaves(jstacked)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    back = leaves(params.unstack_block_params(stacked))
    assert back.keys() == leaves(unrolled).keys()
    assert all(np.array_equal(back[k], leaves(unrolled)[k]) for k in back)
    for template, source in ((stacked, unrolled), (unrolled, stacked)):
        got = leaves(params.adapt_block_layout(template, source))
        want = leaves(jparams.adapt_block_layout(template, source))
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    for fn in (params.stack_block_params, params.unstack_block_params):
        with pytest.raises(ValueError):
            fn({"encoder": {}})
    assert convert.unstack_block_params is params.unstack_block_params
    sd = flax_to_state_dict({"params": stacked})
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())


# ----------------------------------------------------------------- winds

def test_winds_match_jax():
    r = np.random.default_rng(2)
    lat = np.concatenate([r.uniform(-90, 90, 200), [90.0, -90.0]]).astype(np.float32)
    lon = np.concatenate([r.uniform(0, 360, 200), [17.0, 250.0]]).astype(np.float32)
    u, v = (r.standard_normal(202).astype(np.float32) * 10 for _ in range(2))

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == np.float32
        assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), 1.0))

    for g, w in zip(winds.u_v_to_x_y_z_wind(u, v, lat, lon),
                    jwinds.u_v_to_x_y_z_wind(u, v, lat, lon)):
        close(g, w)
    xyz = winds.lon_lat_to_xyz(torch.from_numpy(lon), torch.from_numpy(lat))
    for g, w in zip(xyz, jwinds.lon_lat_to_xyz(lon, lat)):
        close(g, w)
    close(winds.normalize_vector(u, v), jwinds.normalize_vector(u, v))
    x, y, z = (np.array(c) for c in jwinds.lon_lat_to_xyz(lon, lat))
    x[-2:], y[-2:] = 0.0, 0.0  # on the polar axis: longitude 0
    got, want = winds.xyz_to_lon_lat(x, y, z), jwinds.xyz_to_lon_lat(x, y, z)
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[0][-1]) == float(want[0][-1]) == 0.0


# ---------------------------------------------------------------- runs api

def test_runs_api_copy_is_pinned_and_reads_the_port_logs(tmp_path):
    from spherical_dyffusion_tpu_torch.utils.loggers import JsonlLogger

    assert _code(runs_api) == _code(jruns_api)
    for name, seed, losses in [("runA", 1, [3.0, 2.0, 1.0]), ("runB", 2, [5.0, 4.5, 4.2])]:
        lg = JsonlLogger(str(tmp_path / name))
        lg.log_hyperparams({"seed": seed, "model": {"embed_dim": 8}})
        for i, loss in enumerate(losses):
            lg.log({"val/avg/rmse": loss}, step=i)
        lg.finish()
    for api in (runs_api.RunsApi(str(tmp_path)), jruns_api.RunsApi(str(tmp_path))):
        assert [r.name for r in api.runs(config_filters={"model.embed_dim": 8})] == \
            ["runA", "runB"]
        run = api.get_run("runA")
        assert run.metric_array("val/avg/rmse").tolist() == [[0, 3.0], [1, 2.0], [2, 1.0]]
        assert api.best_run("val/avg/rmse").name == "runA"
        assert run.summary() == {"val/avg/rmse": 1.0}


# --------------------------------------------------------------- profiling

def test_profiling_keys_match_jax(tmp_path, capsys):
    logged = []

    class Logger:
        def log(self, metrics, step=None):
            logged.append((metrics, step))

    sums = []
    for mod in (profiling, jprofiling):
        t = mod.Timers()
        for _ in range(2):
            with t("fwd"):
                pass
        with t("bwd"):
            pass
        sums.append(t.summary())
        with mod.timing_scope("load", logger=Logger(), step=3):
            pass
    assert list(sums[0]) == list(sums[1]) == ["time/fwd", "time/fwd_mean", "time/bwd",
                                              "time/bwd_mean"]
    assert [list(m) for m, _ in logged] == [["time/load"]] * 2 and logged[0][1] == 3
    assert profiling.Timers(sync=True).summary() == {}
    assert profiling.device_memory_stats() == {} == jprofiling.device_memory_stats()
    profiling.print_device_memory("x")
    assert "HBM" not in capsys.readouterr().out
    with profiling.trace_scope(str(tmp_path / "trace")) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ----------------------------------------------------------- native packer

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_native_packer_matches_numpy_and_jax(normalize, n_threads):
    r = np.random.default_rng(5)
    arrays = [(r.standard_normal((7, 8, 16)) * 50 + 300).astype(np.float32) for _ in range(5)]
    means = (r.standard_normal(5) * 100).astype(np.float32) if normalize else None
    stds = (np.abs(r.standard_normal(5)) * 7 + 0.1).astype(np.float32) if normalize else None
    got = native.pack_normalize(arrays, means, stds, n_threads=n_threads)
    assert got.dtype == np.float32 and got.shape == (7, 8, 16, 5)
    assert np.array_equal(got, datasets.pack_normalize(arrays, means, stds))
    assert jnative.native_available()
    assert np.array_equal(got, jnative.pack_normalize(arrays, means, stds, n_threads=n_threads))


def test_native_packer_builds_into_place_and_raises_without_gxx(monkeypatch):
    path = native.build_library()
    assert path == native.build_library() and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "build"
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build_library(force=True)
    assert not [n for n in os.listdir(os.path.dirname(path)) if n.endswith(".tmp")]
    assert os.path.exists(path)


def test_windowed_dataset_packs_through_the_native_packer(monkeypatch):
    """``WindowedDataset`` packs its windows with the native packer, as
    JAX's does; its frames equal the numpy version's bit for bit."""
    from spherical_dyffusion_tpu_torch.data.normalization import StandardNormalizer

    calls = []
    real = native.pack_normalize
    monkeypatch.setattr(native, "pack_normalize",
                        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    src = datasets.SyntheticTimeSeries(["a", "b", "f"], n_timesteps=12, spatial_shape=(8, 16))
    fnorm = StandardNormalizer.from_dicts({"f": 0.3}, {"f": 1.7}, ["f"])
    ds = datasets.WindowedDataset(src, ["a", "b"], horizon=3, forcing_names=["f"],
                                  forcing_normalizer=fnorm)
    item = ds[2]
    assert calls == [2, 1]
    raw = src.read_window(2, 4, ["a", "b", "f"])
    assert np.array_equal(item["dynamics"], datasets.pack_normalize([raw["a"], raw["b"]]))
    assert np.array_equal(item["dynamical_condition"], datasets.pack_normalize(
        [raw["f"]], np.float32([0.3]), np.float32([1.7])))


# --------------------------------------------------------- DCP checkpoints

State = collections.namedtuple("State", "model ema step")


def _state(seed):
    net = _sfno(seed=seed)
    ema = _sfno(seed=seed + 10)
    return State(net, ema, 17 + seed)


def test_dcp_round_trip_is_bit_for_bit(tmp_path):
    st = _state(0)
    orbax_ckpt.save_orbax(str(tmp_path / "c"), st, config={"a": 1})
    payload, config = orbax_ckpt.restore_orbax(str(tmp_path / "c"))
    assert config == {"a": 1} and payload["step"] == 17
    for got, want in ((payload["params"], st.model.state_dict()),
                      (payload["ema_params"], st.ema.state_dict())):
        assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    other = _state(1)  # restored in place into another state's tensors
    payload, _ = orbax_ckpt.restore_orbax(str(tmp_path / "c"), other)
    assert payload["step"] == 17
    assert all(torch.equal(v, st.model.state_dict()[k])
               for k, v in other.model.state_dict().items())
    orbax_ckpt.save_orbax(str(tmp_path / "c"), {"params": other.model.state_dict(),
                                                "ema_params": None, "step": 3})
    payload, config = orbax_ckpt.restore_orbax(str(tmp_path / "c"))
    assert payload["ema_params"] is None and payload["step"] == 3 and config is None
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "keep.txt").write_text("x")
    with pytest.raises(FileExistsError):
        orbax_ckpt.save_orbax(str(tmp_path / "d"), st)


def test_dcp_refuses_an_orbax_directory(tmp_path):
    from spherical_dyffusion_tpu.utils.orbax_ckpt import save_orbax as jsave_orbax

    JState = collections.namedtuple("JState", "params ema step")
    jsave_orbax(str(tmp_path / "o"), JState({"w": np.ones(3, np.float32)}, None, 4))
    with pytest.raises(ValueError, match="Orbax"):
        orbax_ckpt.restore_orbax(str(tmp_path / "o"))
    with pytest.raises(FileNotFoundError):
        orbax_ckpt.restore_orbax(str(tmp_path / "none"))


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_checkpoint_manager_keeps_the_steps_orbax_keeps(tmp_path, max_to_keep):
    from spherical_dyffusion_tpu.utils.orbax_ckpt import \
        OrbaxCheckpointManager as JOrbaxCheckpointManager

    Ema = collections.namedtuple("Ema", "params")
    JState = collections.namedtuple("JState", "params ema step")
    mgr = orbax_ckpt.OrbaxCheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep)
    jmgr = JOrbaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=max_to_keep)
    net = _sfno()
    for step in (0, 5, 10, 20):
        w = {"w": np.full(3, step, np.float32)}
        jmgr.save(step, JState(w, Ema(w), step))
        mgr.save(step, State(net, None, step))
        assert mgr.all_steps == list(jmgr.all_steps)
    assert mgr.restore()["step"] == 20 and mgr.restore(mgr.all_steps[0])["step"] == \
        mgr.all_steps[0]


# ------------------------------------------------------------------- plots

def _mpl_panel(field, vmin, vmax, cmap):
    from matplotlib import colormaps, colors

    return colormaps[cmap](colors.Normalize(vmin, vmax)(np.asarray(field, np.float64)),
                           bytes=True)


def _mpl_row(p, t):
    vmin, vmax = np.percentile(t, [2, 98])
    e = p - t
    return np.concatenate([_mpl_panel(p, vmin, vmax, "viridis"),
                           _mpl_panel(t, vmin, vmax, "viridis"),
                           _mpl_panel(e, np.nanmin(e), np.nanmax(e), "RdBu_r")], axis=1)


def test_snapshot_panels_match_matplotlib(tmp_path):
    """The files JAX writes, one row per variable (max_vars), each pixel
    the matplotlib colour of its value (decoded with PIL)."""
    from PIL import Image

    from spherical_dyffusion_tpu.evaluation.plots import plot_snapshot_panels as jplot

    r = np.random.default_rng(6)
    names = ["a", "b", "c", "d", "e"]
    snaps = {s: {"preds": r.standard_normal((16, 32, 5)).astype(np.float32),
                 "targets": r.standard_normal((16, 32, 5)).astype(np.float32)}
             for s in (20, 500)}
    snaps[20]["preds"][3, 4, 0] = np.nan
    got = plots.plot_snapshot_panels(snaps, names, str(tmp_path / "port" / "snapshots"))
    want = jplot(snaps, names, str(tmp_path / "jax" / "snapshots"))
    assert {k: os.path.relpath(v, tmp_path / "port") for k, v in got.items()} == \
        {k: os.path.relpath(v, tmp_path / "jax") for k, v in want.items()}
    for step, path in got.items():
        img = np.asarray(Image.open(path))
        assert img.shape == (4 * 16, 3 * 32, 4)
        assert np.array_equal(img, plots.read_png(path))
        p, t = snaps[step]["preds"].astype(np.float64), snaps[step]["targets"].astype(np.float64)
        want_img = np.concatenate([_mpl_row(p[..., i], t[..., i]) for i in range(4)], axis=0)
        assert np.array_equal(img, want_img), step
    assert tuple(plots.read_png(got[20])[3, 4]) == (0, 0, 0, 0)


def test_zonal_mean_hovmoeller_matches_matplotlib(tmp_path):
    from PIL import Image

    from spherical_dyffusion_tpu.evaluation.plots import plot_zonal_mean_hovmoeller as jplot

    r = np.random.default_rng(7)
    pz, tz = (r.standard_normal((11, 16, 3)).astype(np.float32) for _ in range(2))
    got = plots.plot_zonal_mean_hovmoeller(pz, tz, ["u", "v", "w"], str(tmp_path / "port"),
                                           max_vars=2)
    want = jplot(pz, tz, ["u", "v", "w"], str(tmp_path / "jax"), max_vars=2)
    assert {k: os.path.basename(v) for k, v in got.items()} == \
        {k: os.path.basename(v) for k, v in want.items()}
    for i, (name, path) in enumerate(got.items()):
        img = np.asarray(Image.open(path))
        assert np.array_equal(img, _mpl_row(pz[..., i].T.astype(np.float64),
                                            tz[..., i].T.astype(np.float64))), name


def test_command_line_media_writes_the_plots(tmp_path):
    """The inference command lines' ``_save_media`` writes the snapshot and
    zonal-mean PNGs of the aggregator (and its video)."""
    from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
    from spherical_dyffusion_tpu_torch.run_inference import _save_media

    names = ["a", "b"]
    agg = InferenceAggregator(names, torch.ones(8, 16) / 128, snapshot_steps=[0, 3],
                              log_video=True)
    g = torch.Generator().manual_seed(0)
    preds, targets = torch.randn(2, 5, 8, 16, 2, generator=g), torch.randn(5, 8, 16, 2,
                                                                           generator=g)
    agg.record_batch(preds, targets, host=(preds.numpy(), targets.numpy()))
    _save_media(agg, names, str(tmp_path))
    assert sorted(os.listdir(tmp_path / "snapshots")) == ["snapshot_t0.png", "snapshot_t3.png"]
    assert sorted(os.listdir(tmp_path / "zonal_means")) == ["zonal_mean_a.png",
                                                             "zonal_mean_b.png"]
    assert (tmp_path / "videos.nc").exists()
    snap = agg.snapshots.snapshots[3]
    want = np.concatenate([_mpl_row(snap["preds"][..., i].astype(np.float64),
                                    snap["targets"][..., i].astype(np.float64))
                           for i in range(2)], axis=0)
    assert np.array_equal(plots.read_png(str(tmp_path / "snapshots" / "snapshot_t3.png")), want)
