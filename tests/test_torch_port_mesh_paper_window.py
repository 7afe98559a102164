"""The port's ``scripts/mesh_paper_window.py`` on the CPU, at debug size.

The script's program is ``bench.build``'s window (two SFNOs, horizon 6, the
uniform sampler, the SST prescriber, float32) at embed 16 x 2 layers on a
16 x 32 grid, 12 steps, with the interpolator's dropout off, split over
data 2 x h 2 x w 2:

* its gloo mode, 8 spawned processes with real collectives (spawned once
  for the module by ``test_torch_port_parallel_workers.py``'s spawner,
  over a ``file://`` rendezvous under the test's temporary directory):
  the gathered window against the port's one-process window (1e-5 of the
  largest prediction) and against JAX's
  ``DYffusionStepper(mesh=make_mesh(data=2, h=2, w=2))`` on the conftest's 8
  virtual CPU devices with the same weights (1e-5 of the largest
  prediction, as ``test_spatial_window_without_dropout_matches_jax_sharded_stepper``
  holds the split window);
* its fake mode on the CPU (``--device cpu``), every rank in this process
  over PyTorch's fake process group: each rank's argument and output bytes
  equal to those of its blocks' shapes, its blocks and its collectives by
  kind (calls and bytes) equal to the gloo rank's at the same coordinates,
  no finiteness reported, the JAX script's keys in ``stats.json``;
* its refusals: a mesh larger than ``--devices``, no CUDA without
  ``--device cpu``, no fake process group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_port_parallel_workers as workers
from test_torch_port_parallel import _fields, _jax_variables
from spherical_dyffusion_tpu.data.normalization import StandardNormalizer as JNormalizer
from spherical_dyffusion_tpu.data.packer import Packer as JPacker
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.inference.prescriber import PrescriberConfig as JPrescriberConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.parallel import make_mesh as jmake_mesh
from spherical_dyffusion_tpu.training import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.scripts import mesh_paper_window as mpw
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)

EMBED, LAYERS, GRID, STEPS, HORIZON = 16, 2, (16, 32), 12, 6
DATA, NH, NW = 2, 2, 2
SIZE = ["--embed", str(EMBED), "--layers", str(LAYERS), "--img-shape", *map(str, GRID),
        "--window", str(STEPS), "--data", str(DATA), "--h", str(NH), "--w", str(NW),
        "--device", "cpu", "--no-interpolator-dropout"]
JAX_KEYS = {"mesh", "program", "build_s", "argument_mb", "output_mb", "temp_mb"}


def _jax_window(program, inputs):
    """JAX's stepper on ``make_mesh(data=2, h=2, w=2)`` over the 8 virtual
    devices, ``bench.build``'s configuration at the debug size with the
    port program's weights and the interpolator's dropout off: the window
    (final state, predictions)."""
    names = main_path.state_names()
    forcing = list(main_path.FORCING_NAMES)
    norm = JNormalizer.from_dicts({n: 0.0 for n in names}, {n: 1.0 for n in names}, names)
    fnorm = JNormalizer.from_dicts({n: 0.0 for n in forcing}, {n: 1.0 for n in forcing},
                                   forcing)
    packer = JPacker(names)
    icfg, fcfg = main_path.sfno_configs(EMBED, LAYERS, "float32", GRID, HORIZON,
                                        use_pallas=False, fused_mlp=False)
    imodel, fmodel = JSFNO(JSFNOConfig(**_fields(icfg))), JSFNO(JSFNOConfig(**_fields(fcfg)))
    g = (1,) + GRID
    cond = dict(time=jnp.ones((1,)), static_condition=jnp.zeros(g + (len(forcing),)))
    exp = program.exp
    ip = _jax_variables(imodel, state_dict_to_flax(
        exp.interpolator.model.state_dict())["params"], jnp.zeros(g + (2 * len(names),)),
        **cond)
    fp = _jax_variables(fmodel, state_dict_to_flax(exp.model.state_dict())["params"],
                        jnp.zeros(g + (len(names),)), **cond)
    interp = JInterp(imodel, JExperimentConfig(horizon=HORIZON, window=1,
                                               enable_inference_dropout=True),
                     packer, packer, norm)
    dcfg = JDYffusionConfig(timesteps=HORIZON, forward_conditioning="none",
                            time_encoding="dynamics", enable_interpolator_dropout=False)
    jexp = JForecasting(fmodel, interp, ip, dcfg, JExperimentConfig(horizon=HORIZON), packer,
                        packer, norm, forcing_names=forcing, forcing_normalizer=fnorm)
    prescriber = JPrescriberConfig("surface_temperature", main_path.MASK_NAME, 1).build(names)
    mesh = jmake_mesh(data=DATA, h=NH, w=NW, devices=jax.devices()[:DATA * NH * NW])
    jx, jp = JStepper(jexp, fp, prescriber=prescriber, mesh=mesh).run_window(
        *(jnp.asarray(inputs[k].numpy()) for k in ("x0", "forcing", "targets", "mask")),
        jax.random.PRNGKey(0), STEPS)
    return np.asarray(jx), np.asarray(jp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks start first; while they run, this process computes the
    one-process window, JAX's sharded window and the fake mode's stats."""
    out = str(tmp_path_factory.mktemp("mesh_paper_window_gloo"))
    mpw.write_worker_args(out, ["--backend", "gloo", "--execute", *SIZE])
    ctx = workers.start(DATA * NH * NW, out, mpw.gloo_worker)
    args = mpw.parse_args(SIZE)
    program = mpw.build_program(args, "cpu")
    inputs = mpw.window_inputs(args, program, "cpu")
    one = program.run_window(inputs["x0"], inputs["forcing"], inputs["targets"],
                             inputs["mask"], torch.Generator().manual_seed(0), STEPS)
    jax_out = _jax_window(program, inputs)
    fake_out = str(tmp_path_factory.mktemp("mesh_paper_window_fake"))
    fake = mpw.main(["--backend", "fake", "--out", fake_out, *SIZE])
    gloo = workers.results(ctx, DATA * NH * NW, out, timeout_s=120.0)
    return dict(gloo=gloo, one=one, jax=jax_out, fake=fake, program=program, args=args)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def test_gloo_window_matches_one_process_and_jax_sharded_stepper(runs):
    """The gloo mode's gathered window (every rank finite; rank 0 keeps it)
    against the one-process window and JAX's sharded stepper: final state
    and predictions within 1e-5 of the largest prediction."""
    ranks = runs["gloo"]
    assert all(r["finite"] for r in ranks)
    x, p = ranks[0]["state"], ranks[0]["preds"]
    assert tuple(p.shape) == (DATA, STEPS) + GRID + (35,)
    x1, p1 = runs["one"]
    jx, jp = runs["jax"]
    scale = float(np.abs(jp).max())
    _close(p.numpy(), p1.numpy(), 1e-5)
    assert float((x - x1).abs().max()) <= 1e-5 * float(p1.abs().max())
    assert np.abs(p.numpy() - jp).max() <= 1e-5 * scale
    assert np.abs(x.numpy() - jx).max() <= 1e-5 * scale


def _coords(rec):
    return tuple(rec["coords"][a] for a in ("data", "h", "w"))


def _expected_bytes(program):
    """(parameters and buffers of both networks, this rank's input blocks,
    its output blocks) from the shapes: one row of B = 2 over "data", an 8
    x 16 block of the 16 x 32 grid over h and w, float32."""
    exp = program.exp
    params = sum(t.numel() * 4 for net in (exp.model, exp.interpolator.model)
                 for t in (*net.parameters(), *net.buffers()))
    C, CF, T = 35, 2, STEPS + 1
    hl, wl = GRID[0] // NH, GRID[1] // NW
    ins = 4 * (hl * wl * C + T * hl * wl * CF + 2 * T * hl * wl)
    outs = 4 * (hl * wl * C + STEPS * hl * wl * C)
    return params, ins, outs


@pytest.mark.parametrize("rank", range(DATA * NH * NW))
def test_fake_rank_bytes_blocks_and_collectives_equal_gloo_rank(runs, rank):
    """Each fake rank: its argument bytes (parameters and input blocks) and
    output bytes equal those of the shapes; its blocks and its collectives,
    by kind, calls and bytes, equal the gloo rank's at the same
    coordinates (the fake group calls every collective a real group does,
    and moves nothing); no memory figure on the CPU and no finiteness."""
    rec = runs["fake"]["per_rank"][rank]
    assert rec["rank"] == rank
    params, ins, outs = _expected_bytes(runs["program"])
    assert (rec["params_bytes"], rec["inputs_bytes"], rec["output_bytes"]) == (params, ins, outs)
    assert rec["argument_bytes"] == params + ins
    assert rec["argument_mb"] == (params + ins) / 1e6 and rec["output_mb"] == outs / 1e6
    assert rec["temp_mb"] is None and "finite" not in rec
    gloo = {_coords(r): r for r in runs["gloo"]}[_coords(rec)]
    assert rec["blocks"] == gloo["blocks"]
    assert rec["collectives"] == gloo["collectives"]
    assert sum(c["calls"] for c in rec["collectives"].values()) > 0


def test_fake_stats_keep_jax_keys_and_report_no_values(runs):
    """``stats.json`` of the fake mode: the JAX script's keys, the mesh,
    every rank once with its coordinates, the top-level figures the
    largest over the ranks, "not performed" collectives and no finiteness."""
    stats = runs["fake"]
    assert JAX_KEYS <= set(stats)
    assert stats["mesh"] == {"data": DATA, "h": NH, "w": NW}
    assert stats["backend"] == "fake" and stats["collectives"] == "not performed"
    assert stats["finite"].startswith("not reported")
    ranks = stats["per_rank"]
    assert [r["rank"] for r in ranks] == list(range(DATA * NH * NW))
    assert sorted(_coords(r) for r in ranks) == [(d, h, w) for d in range(DATA)
                                                for h in range(NH) for w in range(NW)]
    assert stats["argument_mb"] == max(r["argument_mb"] for r in ranks)
    assert stats["output_mb"] == max(r["output_mb"] for r in ranks)
    assert stats["temp_mb"] is None and stats["card"] is None


def test_fake_ranks_leave_no_group_and_no_mesh(runs):
    """Between and after the fake ranks nothing keeps a rank's group or
    block: no process group is up, and both networks are off the mesh."""
    args, program = runs["args"], runs["program"]
    inputs = mpw.window_inputs(args, program, "cpu")
    recs = mpw.fake_ranks(args, program, inputs, ranks=[0, 7], warmup=False)
    assert [_coords(r) for r in recs] == [(0, 0, 0), (1, 1, 1)]
    assert not dist.is_initialized()
    for net in (program.exp.model, program.exp.interpolator.model):
        assert all(getattr(m, "_mesh", None) is None for m in net.modules())


def test_refusals(monkeypatch, tmp_path):
    """A mesh larger than ``--devices`` raises (JAX's assert); without CUDA
    the default device raises; without PyTorch's fake process group the
    fake mode raises, with no fallback."""
    out = ["--out", str(tmp_path)]
    with pytest.raises(ValueError, match="more than --devices 4"):
        mpw.main([*SIZE, "--devices", "4", *out])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_cpu = [a for a in SIZE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mpw.main([*no_cpu, *out])
    with pytest.raises(ValueError, match="gloo backend runs its ranks on the CPU"):
        mpw.main([*no_cpu, "--backend", "gloo", "--device", "meta", *out])
    monkeypatch.setattr(dist.Backend, "backend_list", [b for b in dist.Backend.backend_list
                                                       if b != "fake"])
    with pytest.raises(RuntimeError, match="fake process group"):
        mpw.main([*SIZE, *out])
