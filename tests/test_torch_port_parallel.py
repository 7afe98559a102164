"""The port's multi-GPU layer (``parallel/``, the trainer's data parallelism,
the stepper's rows) against the JAX package and against one process, on
the CPU.

In this process: ``make_mesh``'s layouts and errors against JAX's,
``parse_multihost_env`` on the JAX tests' environments, what
``maybe_init_multihost`` asks ``init_process_group`` for, and the
refusals of a model-parallel mesh. On gloo with 2 and 4 spawned processes
(``test_torch_port_parallel_workers.py``, which imports no JAX; a
``file://`` rendezvous under the test's temporary directory):

* ``distributed_sht``/``isht``/``dhconv`` (scatter on and off) on their
  blocks, gathered, against the single-device transforms of both packages
  (2e-5 absolute, as ``tests/test_parallel.py``);
* data-parallel training of a debug SFNO (dropout off, timesteps pinned)
  against one process on the global batch (losses 1e-6 relative, parameters
  1e-6 absolute after the Adam updates, the validation after them 1e-5) and
  against JAX's step on a 2-device mesh (losses 1e-5; parameters as
  ``_assert_params`` states);
* ``grad_reduce_dtype="bfloat16"``: the reduction on seeded terms (a bf16
  sum, within the rounding of its additions, exact on two ranks), and the
  bf16 step on two ranks against JAX's ``shard_map`` step (each parameter's
  change within a quarter of JAX's float32-to-bf16 gap, and nearer JAX's
  bf16 step than its float32 one);
* ZeRO-1 (``zero_shard_opt_state``): at least one moment sharded, and its
  checkpoint equal to the unsharded run's, bit for bit;
* the stepper's rows over the world against the one-process window (1e-6);
* spatial model parallelism on h=2 and w=2 (two ranks), h=2, w=2 and
  data=2, h=2 (four): the SFNO forward (K3, K2, the exact instance norm,
  the layer norm) with its dropout live, gathered, against the one-process
  forward (1e-5 of its largest value: the masks are the same, the sums over
  ranks reorder float32 additions), and with dropout off against JAX's SFNO
  jitted on the same mesh layout of the virtual CPU devices (2e-5 abs, 1e-4
  rel, as ``tests/test_parallel.py``); the main path's window (K3 and K2
  paths, SST mask and forcings) with the interpolator's dropout live against
  the one-process window (1e-5 of its largest value; rows split over "data"
  against the one-process window of each data index's rows with its folded
  generator), and with dropout off against JAX's sharded
  ``DYffusionStepper`` (1e-5); on four ranks a training step on
  ``make_mesh(data=2, h=2)`` against JAX's ``Trainer`` on that mesh.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_parallel_workers as workers
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.data.normalization import StandardNormalizer as JNormalizer
from spherical_dyffusion_tpu.data.packer import Packer as JPacker
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.inference.prescriber import PrescriberConfig as JPrescriberConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.ops import InverseRealSHT as JISHT
from spherical_dyffusion_tpu.ops import RealSHT as JSHT
from spherical_dyffusion_tpu.ops.contractions import contract_dhconv as jcontract
from spherical_dyffusion_tpu.parallel import batch_sharding as jbatch_sharding
from spherical_dyffusion_tpu.parallel import make_mesh as jmake_mesh
from spherical_dyffusion_tpu.parallel import multihost as jmultihost
from spherical_dyffusion_tpu.parallel import shard_batch as jshard_batch
from spherical_dyffusion_tpu.training import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.models.modules import fold_generator
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
from spherical_dyffusion_tpu_torch.parallel import multihost
from spherical_dyffusion_tpu_torch.parallel.mesh import make_mesh
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig, zero_axis
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)


# ------------------------------------------------------------ one process

def test_make_mesh_layouts_and_errors_match_jax():
    for kw in ({}, dict(data=2, h=2, w=2), dict(data=4, h=2), dict(data=-1, w=4)):
        want = jmake_mesh(**kw)
        got = make_mesh(ranks=range(8), **kw)
        assert got.axis_names == want.axis_names
        assert got.shape == dict(zip(want.axis_names, want.devices.shape)) and got.size == 8
        assert all(g is None for g in got.groups.values())  # a layout, no process group
    assert make_mesh().size == 1  # one process without a group
    for kw in (dict(data=3, h=2), dict(h=3)):
        with pytest.raises(ValueError) as jerr:
            jmake_mesh(**kw)
        with pytest.raises(ValueError) as err:
            make_mesh(ranks=range(8), **kw)
        assert str(err.value) == str(jerr.value)


ENVS = [
    {}, {"WORLD_SIZE": "8", "RANK": "0"}, {"SPHDY_MULTIHOST": "1"},
    {"SPHDY_COORDINATOR": "10.0.0.2:8476", "SPHDY_NUM_PROCESSES": "4",
     "SPHDY_PROCESS_ID": "1"},
    {"SPHDY_COORDINATOR": "host:1234"},
    {"SPHDY_COORDINATOR": "no-port"},
    {"SPHDY_COORDINATOR": "h:12", "SPHDY_NUM_PROCESSES": "two", "SPHDY_PROCESS_ID": "0"},
    {"SPHDY_COORDINATOR": "h:12", "SPHDY_NUM_PROCESSES": "2"},
]


@pytest.mark.parametrize("env", ENVS)
def test_parse_multihost_env_matches_jax(env):
    try:
        want = jmultihost.parse_multihost_env(env)
    except ValueError as jerr:
        with pytest.raises(ValueError) as err:
            multihost.parse_multihost_env(env)
        assert str(err.value) == str(jerr)
        return
    got = multihost.parse_multihost_env(env)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_maybe_init_multihost_maps_the_spec_to_a_process_group(monkeypatch):
    calls = []
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(multihost.dist, "get_backend", lambda: "gloo")
    assert multihost.maybe_init_multihost(env={}) is None and not calls
    env = {"SPHDY_COORDINATOR": "10.0.0.2:8476", "SPHDY_NUM_PROCESSES": "2",
           "SPHDY_PROCESS_ID": "1"}
    spec = multihost.maybe_init_multihost(env=env, backend="gloo")
    assert spec == multihost.MultihostSpec("10.0.0.2:8476", 2, 1)
    assert calls == [("gloo", dict(init_method="tcp://10.0.0.2:8476", world_size=2, rank=1))]
    multihost.maybe_init_multihost(env=env, backend="gloo")  # idempotent
    assert len(calls) == 1
    calls.clear()
    multihost.maybe_init_multihost(env={"SPHDY_MULTIHOST": "1"}, backend="gloo")
    assert calls == [("gloo", dict(init_method="env://", world_size=-1, rank=-1))]
    calls.clear()
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.maybe_init_multihost(env={"SPHDY_COORDINATOR": "h:1"}, backend="gloo")
    multihost.maybe_init_multihost(env={"SPHDY_COORDINATOR": "h:1", "WORLD_SIZE": "4",
                                        "RANK": "3"}, backend="gloo")
    assert calls == [("gloo", dict(init_method="tcp://h:1", world_size=4, rank=3))]
    calls.clear()
    if not torch.cuda.is_available():  # NCCL never falls back to gloo
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.maybe_init_multihost(env=env)
        assert not calls


SPLIT_GRID_REFUSALS = {
    "fold": dict(sht_fold_symmetry=True),
    "fft_transform": dict(spectral_transform="fft"),
}


@pytest.mark.parametrize("option", sorted(SPLIT_GRID_REFUSALS))
@pytest.mark.parametrize("mesh_kw", [dict(data=1, h=2, w=2), dict(data=2, w=2)])
def test_model_parallel_mesh_refusals(option, mesh_kw):
    """The folded Legendre stage and the planar FFT transform, which raised
    on a split grid until they had a route, are taken by ``set_mesh`` on a
    grid split over "h" and "w" and over "w" alone (their forwards on the
    ranks: ``tests/test_torch_port_spatial_options.py``), and so is the
    whole grid; the refusal that stays is the trainer's: JAX's explicit bf16
    step needs a pure data-parallel mesh (``tests/test_parallel.py:172``),
    which the model axes break."""
    mesh = make_mesh(ranks=range(4), **mesh_kw)
    kw = dict(img_shape=(16, 32), in_chans=3, out_chans=3, embed_dim=8, num_layers=2)
    model = SFNO(SFNOConfig(**kw, **SPLIT_GRID_REFUSALS[option]))
    model.set_mesh(mesh)
    assert all(b.filter._mesh is mesh for b in model.blocks)
    if option == "fold":
        assert all(t.folded for t in (model.trans_down, model.itrans_up, model.trans,
                                      model.itrans))
    model.set_mesh(make_mesh(data=4, ranks=range(4)))  # the whole grid
    model.set_mesh(None)
    assert all(b.filter._mesh is None for b in model.blocks)
    tr = workers.interpolation_trainer(mesh, grad_reduce_dtype="bfloat16")
    with pytest.raises(ValueError, match="data-parallel mesh"):
        tr.init_state()


def test_split_grid_refusals_of_the_stepper_and_the_modules():
    """The stepper checks both networks when it is built (a UNet backbone
    builds on "h" = 2 and refuses autograd there: forwards only); autograd,
    a grid that does not divide and a rank pipeline whose rank does not
    split over "w" raise too; ``TrainerConfig`` checks the reduction
    dtype."""
    mesh = make_mesh(data=1, h=2, ranks=range(2))
    st = main_path.build_unet(img_shape=(16, 32), n_state=3, dim=8, dim_mults=(1, 2),
                              upsample_dims=None, device="cpu")
    DYffusionStepper(st.exp, mesh=mesh)
    unet = st.exp.model
    unet.set_mesh(mesh)
    with pytest.raises(NotImplementedError, match="forwards only"):
        unet(torch.zeros(1, 8, 32, 3), static_condition=torch.zeros(1, 8, 32, 2),
             time=torch.ones(1))
    unet.set_mesh(None)
    with pytest.raises(ValueError, match="must split"):
        DYffusionStepper(st.exp, mesh=make_mesh(data=1, h=3, ranks=range(3)))
    cp = SFNO(SFNOConfig(img_shape=(16, 32), in_chans=3, out_chans=3, embed_dim=12,
                         num_layers=3, factorization="cp", rank=0.25))  # R = 3
    with pytest.raises(ValueError, match="rank 3 must split over w=2"):
        cp.set_mesh(make_mesh(data=1, w=2, ranks=range(2)))
    cp.set_mesh(make_mesh(data=1, h=2, ranks=range(2)))  # "h" alone: any rank
    cp.set_mesh(None)
    model = workers.spatial_sfno("k3")
    model.set_mesh(mesh)
    with pytest.raises(NotImplementedError, match="forwards only"):
        model(torch.zeros(1, 8, 32, workers.IN), time=torch.ones(1))
    with pytest.raises(ValueError, match="must split"):
        model.set_mesh(make_mesh(data=1, w=3, ranks=range(3)))
    with pytest.raises(ValueError, match="floating dtype"):
        TrainerConfig(grad_reduce_dtype="int8")


def test_zero_axis_is_jax_zero_sharding_rule():
    assert zero_axis((), 2) is None and zero_axis((8, 8), 1) is None
    assert zero_axis((3, 8, 6), 2) == 1 and zero_axis((6, 8, 8), 4) == 1
    assert zero_axis((3, 5), 2) is None and zero_axis((16, 3), 4) == 0


# --------------------------------------------------------- over processes

@pytest.fixture(scope="module")
def out_dirs(tmp_path_factory):
    return {n: str(tmp_path_factory.mktemp(f"world{n}")) for n in (2, 4)}


@pytest.fixture(scope="module")
def all_runs(out_dirs):
    """Both worlds' processes start first; while they run, this process
    computes the one-process references and JAX's steps. Returns
    ``(runs by world, one process, JAX)``."""
    ctxs = {n: workers.start(n, d) for n, d in out_dirs.items()}
    one = dict(dp=workers.train(workers.interpolation_trainer()),
               window=workers.window(workers.window_stepper()), spatial=_spatial_one_process())
    with pytest.MonkeyPatch.context() as mp:
        jax_out = _jax_steps(mp)
    jax_out["spatial"] = _jax_spatial()
    return {n: workers.results(c, n, out_dirs[n]) for n, c in ctxs.items()}, one, jax_out


@pytest.fixture(scope="module")
def runs(all_runs):
    return all_runs[0]


@pytest.fixture(scope="module")
def one_process(all_runs):
    return all_runs[1]


@pytest.fixture(scope="module")
def jax_steps(all_runs):
    return all_runs[2]


def _assemble(ranks, key, lat_axis=None, chan_axis=None):
    """Join the ranks' blocks: by their (h, w) coordinates along
    ``lat_axis`` and ``chan_axis`` (w's blocks), duplicates dropped."""
    blocks = {r["coords"]: r[key] for r in ranks}
    nh = 1 + max(c[0] for c in blocks)
    nw = 1 + max(c[1] for c in blocks)
    rows = []
    for hi in range(nh if lat_axis is not None else 1):
        parts = [blocks[(hi, wi)] for wi in range(nw)]
        rows.append(torch.cat(parts, dim=chan_axis) if chan_axis is not None else parts[0])
    return torch.cat(rows, dim=lat_axis) if lat_axis is not None else rows[0]


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_transforms_match_single_device(runs, world):
    ranks = runs[world]
    x, w = workers.transform_inputs()
    sht, isht = workers.transforms()
    want = sht(x)
    jwant = JSHT.create(workers.H, workers.W, grid="legendre-gauss")(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(want[..., 0].numpy(), np.asarray(jwant.real), atol=2e-5)
    np.testing.assert_allclose(want[..., 1].numpy(), np.asarray(jwant.imag), atol=2e-5)

    def close(got, ref):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 2e-5

    spec = _assemble(ranks, "spec", chan_axis=-2)  # whole in (l, m), channels over w
    close(spec, want)
    back = _assemble(ranks, "back", lat_axis=1, chan_axis=2)
    close(back, isht(want))
    conv_want = contract_dhconv(want, w)
    jconv = jcontract(jwant, jnp.asarray(w.numpy()))
    np.testing.assert_allclose(conv_want[..., 0].numpy(), np.asarray(jconv.real), atol=2e-5)
    close(_assemble(ranks, "conv", chan_axis=-2), conv_want)
    for r in ranks:  # scatter off: every rank holds the whole output
        close(r["conv_rep"], conv_want)
    close(_assemble(ranks, "pipe", lat_axis=1, chan_axis=2), isht(conv_want))
    jisht = JISHT.create(workers.H, workers.W, grid="legendre-gauss")
    np.testing.assert_allclose(isht(conv_want).numpy(), np.asarray(jisht(jconv)), atol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_training_equals_one_process(runs, one_process, world):
    want = one_process["dp"]
    for r in runs[world]:  # every rank holds the same state and validates alike
        got = r["dp"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        assert got["val"].keys() == want["val"].keys() and want["val"]
        for k, v in want["val"].items():
            np.testing.assert_allclose(got["val"][k], v, rtol=1e-5)
        for k, v in want["params"].items():
            assert float((got["params"][k] - v).abs().max()) <= 1e-6, k


@pytest.mark.parametrize("world", [2, 4])
def test_zero_sharded_optimizer_trains_and_checkpoints_as_unsharded(runs, out_dirs, world):
    ranks = runs[world]
    assert ranks[0]["zero"]["opt_sharded"]  # at least one moment lives in slices
    for r in ranks:
        assert np.isfinite(r["zero"]["losses"]).all()
        assert r["zero"]["losses"] == r["dp"]["losses"]
        for k, v in r["dp"]["params"].items():
            assert torch.equal(r["zero"]["params"][k], v), k
    zero = torch.load(os.path.join(out_dirs[world], "zero.ckpt"), weights_only=True)
    dp = torch.load(os.path.join(out_dirs[world], "dp.ckpt"), weights_only=True)
    for key in ("params", "ema_params"):
        assert zero[key].keys() == dp[key].keys()
        assert all(torch.equal(zero[key][k], dp[key][k]) for k in dp[key])
    for m in ("exp_avg", "exp_avg_sq"):
        for k, v in dp["opt_state"][m].items():
            assert zero["opt_state"][m][k].shape == v.shape and torch.equal(
                zero["opt_state"][m][k], v), (m, k)
    assert zero["opt_state"]["updates"] == dp["opt_state"]["updates"] == workers.TRAIN_STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_stepper_rows_over_ranks_equal_one_process(runs, one_process, world):
    x1, p1 = one_process["window"]
    for r in runs[world]:
        x, p = r["window"]
        assert p.shape == p1.shape == (4, 6, 8, 16, 3)
        assert float((p - p1).abs().max()) <= 1e-6 and float((x - x1).abs().max()) <= 1e-6


# ------------------------------------------------- spatial model parallelism

def _data_rows(key):
    """The row blocks of the batch of 2 over the mesh's "data" axis."""
    return [slice(0, 1), slice(1, 2)] if workers.MESHES[key]["data"] == 2 else [slice(None)]


def _spatial_one_process():
    """The one-process references of ``workers.spatial``, by data split (1
    or 2): the SFNO forwards (each data index's rows with the same seed, as
    every rank gets it) and the windows (each data index's rows with the
    generator folded with that index, as the stepper folds it)."""
    x, t = workers.sfno_inputs()
    out = {}
    for split, rows in ((1, [slice(None)]), (2, [slice(0, 1), slice(1, 2)])):
        sfno = {o: torch.cat([workers.sfno_forward(workers.spatial_sfno(o), x[r], t[r])
                              for r in rows]) for o in workers.SFNO_OPTS}
        windows = {}
        for p in workers.WINDOW_PATHS:
            st = workers.spatial_window_stepper(p, True)
            parts = [workers.spatial_window(st, r, None if split == 1 else fold_generator(
                torch.Generator().manual_seed(0), d)) for d, r in enumerate(rows)]
            windows[p] = tuple(torch.cat([q[i] for q in parts]) for i in range(2))
        out[split] = dict(sfno=sfno, window=windows)
    out["sfno_det"] = {o: workers.sfno_forward(workers.spatial_sfno(o, dropout=False), x, t)
                       for o in ("k3", "k2")}
    out["window_det"] = workers.spatial_window(workers.spatial_window_stepper("k3", False))
    return out


def _jax_variables(model, params, *args, **kwargs):
    """The JAX SFNO's variables for ``params``, its "constants" (the SHT
    matrices) from a jitted apply that returns only them."""
    consts = jax.jit(lambda p, *a, **k: model.apply({"params": p}, *a, mutable=["constants"],
                                                    **k)[1])(params, *args, **kwargs)
    return {"params": params, **consts}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_spatial():
    """JAX on each mesh layout of ``workers.MESHES`` (the virtual CPU
    devices), dropout off, from the port's weights: the SFNO forward jitted
    with the input sharded ``P("data", "h", "w", None)`` and the window of
    ``DYffusionStepper(..., mesh=...)`` (the XLA paths, no Pallas kernel:
    the same math as the port's K3 and K2 routes)."""
    x, t = workers.sfno_inputs()
    port = workers.spatial_sfno("k3", dropout=False)
    kw = dict(img_shape=workers.GRID, in_chans=workers.IN, out_chans=workers.OUT, embed_dim=8,
              num_layers=2, with_time_emb=True)
    model = JSFNO(JSFNOConfig(**kw))
    xj, tj = jnp.asarray(x.numpy()), jnp.asarray(t.numpy())
    variables = _jax_variables(model, state_dict_to_flax(port.state_dict())["params"], xj[:1],
                               time=tj[:1])
    fwd = jax.jit(lambda v, x, t: model.apply(v, x, time=t))

    # the window: bench.py:build() at the workers' size, the port's weights
    st = workers.spatial_window_stepper("k3", False)
    names = main_path.state_names(workers.STATE)
    forcing = list(main_path.FORCING_NAMES)
    norm = JNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names}, names)
    fnorm = JNormalizer.from_dicts({n: 0.0 for n in forcing}, {n: 1.0 for n in forcing},
                                   forcing)
    packer = JPacker(names)
    icfg, fcfg = main_path.sfno_configs(8, 2, "float32", workers.GRID, 3, workers.STATE,
                                        use_pallas=False, fused_mlp=False)
    imodel, fmodel = JSFNO(JSFNOConfig(**_fields(icfg))), JSFNO(JSFNOConfig(**_fields(fcfg)))
    g = (1,) + workers.GRID
    cond = dict(time=jnp.ones((1,)), static_condition=jnp.zeros(g + (2,)))
    ip = _jax_variables(imodel, state_dict_to_flax(
        st.exp.interpolator.model.state_dict())["params"], jnp.zeros(g + (2 * workers.STATE,)),
        **cond)
    fp = _jax_variables(fmodel, state_dict_to_flax(st.exp.model.state_dict())["params"],
                        jnp.zeros(g + (workers.STATE,)), **cond)
    interp = JInterp(imodel, JExperimentConfig(horizon=3, window=1, enable_inference_dropout=True),
                     packer, packer, norm)
    dcfg = JDYffusionConfig(timesteps=3, forward_conditioning="none", time_encoding="dynamics",
                            enable_interpolator_dropout=False)
    exp = JForecasting(fmodel, interp, ip, dcfg, JExperimentConfig(horizon=3), packer, packer,
                       norm, forcing_names=forcing, forcing_normalizer=fnorm)
    prescriber = JPrescriberConfig("surface_temperature", main_path.MASK_NAME, 1).build(names)
    inp = main_path.window_inputs(workers.WINDOW_STEPS, workers.GRID, workers.STATE, batch=2,
                                  seed=3, device="cpu")
    out = {}
    for key, kw in workers.MESHES.items():
        mesh = jmake_mesh(**kw, devices=jax.devices()[:4 if key in ("h2w2", "d2h2") else 2])
        y = fwd(jax.device_put(variables, NamedSharding(mesh, P())),
                jax.device_put(xj, jbatch_sharding(mesh, 4, spatial=True)),
                jax.device_put(tj, NamedSharding(mesh, P("data"))))
        jx, jp = JStepper(exp, fp, prescriber=prescriber, mesh=mesh).run_window(
            *(jnp.asarray(inp[k].numpy()) for k in ("x0", "forcing", "sst", "mask")),
            jax.random.PRNGKey(0), workers.WINDOW_STEPS)
        out[key] = dict(sfno=np.asarray(y), window=(np.asarray(jx), np.asarray(jp)))
    return out


def _spatial_ranks(runs, key):
    world = next(w for w, keys in workers.SPATIAL_MESHES.items() if key in keys)
    return [r["spatial"][key] for r in runs[world]]


MESH_KEYS = [k for keys in workers.SPATIAL_MESHES.values() for k in keys]


def _close(got, want, tol):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("key", MESH_KEYS)
@pytest.mark.parametrize("opts", sorted(workers.SFNO_OPTS))
def test_spatial_sfno_with_dropout_equals_one_process(runs, one_process, key, opts):
    """Every rank's gathered output: the one-process forward of its data
    index's rows, within 1e-5 of the largest value (K3's and K2's masks at
    each pixel's global row, ``QuantizedDropout``'s from the whole grid's
    bits, the norms' sums over "h" and "w")."""
    want = one_process["spatial"][len(_data_rows(key))]["sfno"][opts]
    if opts in one_process["spatial"]["sfno_det"]:  # the dropout did run
        assert not torch.allclose(want, one_process["spatial"]["sfno_det"][opts])
    for r in _spatial_ranks(runs, key):
        _close(r["sfno"][opts], want, 1e-5)


@pytest.mark.parametrize("key", MESH_KEYS)
@pytest.mark.parametrize("opts", ["k3", "k2"])
def test_spatial_sfno_without_dropout_matches_jax_on_the_mesh(runs, one_process, jax_steps,
                                                             key, opts):
    want = jax_steps["spatial"][key]["sfno"]
    for r in _spatial_ranks(runs, key):
        np.testing.assert_allclose(r["sfno_det"][opts].numpy(), want, atol=2e-5, rtol=1e-4)
    _close(_spatial_ranks(runs, key)[0]["sfno_det"][opts], one_process["spatial"]["sfno_det"][opts],
           1e-5)


@pytest.mark.parametrize("key", MESH_KEYS)
@pytest.mark.parametrize("path", sorted(workers.WINDOW_PATHS))
def test_spatial_window_with_dropout_equals_one_process(runs, one_process, key, path):
    """The main path's window with the SST mask, the forcings and the
    interpolator's dropout live: the final state and the predictions of
    every rank, gathered, within 1e-5 of the largest prediction."""
    x1, p1 = one_process["spatial"][len(_data_rows(key))]["window"][path]
    assert p1.shape == (2, workers.WINDOW_STEPS) + workers.GRID + (workers.STATE,)
    assert not torch.allclose(p1, one_process["spatial"]["window_det"][1])  # dropout ran
    for r in _spatial_ranks(runs, key):
        x, p = r["window"][path]
        _close(p, p1, 1e-5)
        assert float((x - x1).abs().max()) <= 1e-5 * float(p1.abs().max())


@pytest.mark.parametrize("key", MESH_KEYS)
def test_spatial_window_without_dropout_matches_jax_sharded_stepper(runs, one_process,
                                                                    jax_steps, key):
    """With dropout off the sharded window (K3 path, peeled sampler) equals
    JAX's ``DYffusionStepper(..., mesh=make_mesh(...))`` on that layout
    (1e-5 of the largest prediction), and the one-process window."""
    jx, jp = jax_steps["spatial"][key]["window"]
    scale = np.abs(jp).max()
    for r in _spatial_ranks(runs, key):
        x, p = r["window_det"]
        assert np.abs(p.numpy() - jp).max() <= 1e-5 * scale
        assert np.abs(x.numpy() - jx).max() <= 1e-5 * scale
        _close(p, one_process["spatial"]["window_det"][1], 1e-5)


def test_stepper_rows_and_latitudes_over_the_mesh_match_unsharded(runs, one_process):
    """The counterpart of ``tests/test_inference.py:343`` (rows over "data"
    and latitudes over "h" on ``make_mesh(data=4, h=2)``) on the four ranks
    of ``make_mesh(data=2, h=2)``: with dropout off the gathered window is
    the unsharded one, on every rank."""
    x1, p1 = one_process["spatial"]["window_det"]
    for r in _spatial_ranks(runs, "d2h2"):
        x, p = r["window_det"]
        _close(p, p1, 1e-5)
        _close(x, x1, 1e-5)


# ------------------------------------------------------------- against JAX

def _flat(params) -> dict:
    return {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax.device_get(params))}


def _jax_steps(monkeypatch):
    """JAX's pjit step and its bf16 ``shard_map`` step on a 2-device mesh,
    from the port's initial weights, each sample's timestep pinned to its
    row of ``TIMESTEPS`` as the workers pin them (inside ``shard_map`` a
    device draws for its own rows: its block, by its "data" index): per
    step the loss, the parameters after the steps, and (``"init"``) the
    initial parameters."""
    ts = jnp.asarray(np.asarray(workers.TIMESTEPS), jnp.int32)

    def pinned(key, shape, minval, maxval, *a, **k):
        n = shape[0]
        if n == ts.shape[0]:
            return ts
        return jax.lax.dynamic_slice(ts, (jax.lax.axis_index("data") * n,), (n,))

    monkeypatch.setattr(jax.random, "randint", pinned)
    port = workers.interpolation_trainer()
    dm = JDebugDataModule(channels=2, height=8, width=16, horizon=3, batch_size=4,
                          n_timesteps=24)
    model = JSFNO(JSFNOConfig(img_shape=(8, 16), in_chans=4, out_chans=2, embed_dim=8,
                              num_layers=1, with_time_emb=True, min_time=1, max_time=2))
    exp = JInterp(model, JExperimentConfig(horizon=3), dm.in_packer, dm.out_packer,
                  dm.normalizer)
    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    batches = [b for _, b in zip(range(workers.TRAIN_STEPS), dm.train_batches(seed=0))]
    out, state0, tx = {}, None, None
    for rd in (None, "bfloat16"):
        tr = JTrainer(exp, dm, JTrainerConfig(epochs=1, steps_per_epoch=workers.TRAIN_STEPS,
                                              warmup_steps=1, grad_reduce_dtype=rd),
                      mesh=mesh)
        if state0 is None:  # one initial state (one compiled init) for both steps
            tr.restore_payload = {"params": state_dict_to_flax(port.exp.model.state_dict())}
            state0, tx = tr.init_state(batches[0]), tr.tx
            out["init"] = _flat(state0.params["params"])
        tr.tx, state = tx, state0
        step = tr._make_train_step()
        losses = []
        for i, b in enumerate(batches):
            state, metrics = step(state, jshard_batch(mesh, b["dynamics"]), None,
                                  jax.random.PRNGKey(i), None)
            losses.append(float(metrics["loss"]))
        out[rd or "float32"] = dict(losses=losses, params=_flat(state.params["params"]))
    # the pjit step on a mesh with a model axis: the batch over "data" alone
    mesh4 = jmake_mesh(data=2, h=2, devices=jax.devices()[:4])
    tr = JTrainer(exp, dm, JTrainerConfig(epochs=1, steps_per_epoch=workers.TRAIN_STEPS,
                                          warmup_steps=1), mesh=mesh4)
    tr.tx = tx
    state = jax.device_put(state0, NamedSharding(mesh4, P()))
    step = tr._make_train_step()
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, jshard_batch(mesh4, b["dynamics"]), None,
                              jax.random.PRNGKey(i), None)
        losses.append(float(metrics["loss"]))
    out["model_mesh"] = dict(losses=losses, params=_flat(state.params["params"]))
    return out


def _assert_params(got, want, lr_atol):
    for k, v in want.items():
        err = float(np.abs(got[k].numpy() - v).max())
        assert err <= 1e-6 * max(float(np.abs(v).max()), 1.0) + lr_atol, (k, err)


def test_data_parallel_step_matches_jax_two_device_mesh(runs, jax_steps):
    """The parameters differ by optax's float32 bias correction and, where
    a gradient entry is near Adam's eps, by a fraction of an update: within
    1e-6 of the largest entry plus 1e-2 of the learning rate (4e-6)."""
    want = jax_steps["float32"]
    for r in runs[2]:
        np.testing.assert_allclose(r["dp"]["losses"], want["losses"], rtol=1e-5)
        _assert_params(r["dp"]["params"], want["params"], 1e-2 * 4e-4)


def test_model_axis_step_matches_jax_trainer_on_the_mesh(runs, jax_steps):
    """On ``make_mesh(data=2, h=2)`` the ranks of one data index run the
    same rows with the same generator (the step replicated over "h", as
    JAX's pjit step shards the batch over "data" alone): every rank's
    losses and parameters match JAX's ``Trainer`` on that mesh, at
    ``test_data_parallel_step_matches_jax_two_device_mesh``'s tolerance."""
    want = jax_steps["model_mesh"]
    for r in runs[4]:
        np.testing.assert_allclose(r["mp"]["losses"], want["losses"], rtol=1e-5)
        _assert_params(r["mp"]["params"], want["params"], 1e-2 * 4e-4)


def test_bf16_gradient_mean_matches_jax_shard_map_step(runs, jax_steps):
    """On two ranks a bf16 sum of two terms rounds once, in gloo as in XLA,
    so the port's bf16 step is held to JAX's: each parameter's change over
    the steps (parameters minus initial ones) within a quarter of the
    largest gap between JAX's float32 and bf16 changes (the bf16 mean's own
    effect), and nearer JAX's bf16 change than JAX's float32 one; the bf16
    run's parameters differ from the port's float32 run's. On four ranks
    gloo's ring rounds each partial sum to bf16 where XLA's CPU all-reduce
    rounds the whole sum once, an order the collective defines, so there
    the ranks are held to one another and to their float32 run, and
    ``test_bf16_gradient_mean_rounds_a_bf16_sum`` holds the reduction
    itself."""
    init, f32, want = jax_steps["init"], jax_steps["float32"], jax_steps["bfloat16"]

    def change(params, k):
        v = params[k]
        return (v.numpy() if isinstance(v, torch.Tensor) else v) - init[k]

    def gap(a, b):
        return max(float(np.abs(change(a, k) - change(b, k)).max()) for k in init)

    bf16_effect = gap(want["params"], f32["params"])
    assert bf16_effect > 1e-6  # the bf16 mean moves JAX's parameters
    for r in runs[2]:
        np.testing.assert_allclose(r["bf16"]["losses"], want["losses"], rtol=1e-5)
        err = gap(r["bf16"]["params"], want["params"])
        assert err <= bf16_effect / 4, (err, bf16_effect)
        assert err < gap(r["bf16"]["params"], f32["params"])
    for world in (2, 4):
        ranks = runs[world]
        for r in ranks:
            assert np.isfinite(r["bf16"]["losses"]).all()
            assert not all(torch.equal(v, r["dp"]["params"][k])
                           for k, v in r["bf16"]["params"].items())
            for k, v in ranks[0]["bf16"]["params"].items():
                assert torch.equal(r["bf16"]["params"][k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_gradient_mean_rounds_a_bf16_sum(runs, world):
    """``Trainer._mean_over_data`` on seeded terms, one per rank: in float32
    the mean (1e-6); in bf16 a value of bf16 (so the sum did run in bf16),
    within the rounding of ``world - 1`` bf16 additions (2**-8 of the
    terms' absolute sum each) of the exact mean of the terms cast to bf16,
    and on two ranks that sum rounded once, exactly."""
    terms = workers.reduce_inputs(world)
    cast = terms.bfloat16().float()
    exact = cast.sum(0) / world
    bound = (world - 1) * 2.0 ** -8 * cast.abs().sum(0) / world
    for r in runs[world]:
        got32, got16 = r["mean"]["None"], r["mean"]["bfloat16"]
        assert got16.dtype == got32.dtype == torch.float32
        assert float((got32 - terms.mean(0)).abs().max()) <= 1e-6
        assert torch.equal(got16, got16.bfloat16().float())
        assert not torch.equal(got16, got32)
        assert bool(((got16 - exact).abs() <= bound).all())
        if world == 2:
            assert torch.equal(got16, (cast[0] + cast[1]).bfloat16().float() / 2)
