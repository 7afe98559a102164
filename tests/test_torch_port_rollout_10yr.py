"""The port's 10-year rollout script against the JAX package's, on the CPU.

``spherical_dyffusion_tpu_torch/scripts/rollout_10yr.py`` against
``scripts/rollout_10yr.py`` at debug width on the full grid: embed 16 x 2
layers on 180 x 360, 4 steps in windows of 2, float32 compute and
predictions, scan and peel on (the defaults of both scripts). The JAX script
runs once in a module fixture, with ``bench.build`` wrapped to capture its
weights and to turn the interpolator's dropout off (its TPU random bits
cannot be reproduced); the port's ``rollout_artifact`` then runs a stepper
holding those weights, dropout off too.

Both write ``rollout_10yr.json`` and ``metrics_full.json``. The files have
the same keys (the port's configuration adds its own); every log in
``metrics_full.json`` agrees within ``LOG_REL`` (1e-5 relative to the value,
or to 1 where it is smaller, as ``tests/test_torch_port_inference.py``
holds the aggregator's logs: float32 on both sides, summed in other
orders). The throughput and host fractions are timings and are compared by
key only.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.scripts import rollout_10yr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--embed", "16", "--layers", "2", "--steps", "4", "--window", "2",
        "--dtype", "float32", "--preds-dtype", "float32"]
LOG_REL = 1e-5


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_rollout_10yr",
                                                  REPO / "scripts" / "rollout_10yr.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script's files (with ``--writer``) and the weights that its
    ``bench.build`` drew, run once for the module."""
    import bench

    out = tmp_path_factory.mktemp("jax")
    real, captured = bench.build, {}

    def build(*args, **kwargs):
        stepper, in_names, forcing_names = real(*args, **kwargs)
        exp = stepper.exp
        exp.diffusion_cfg = dataclasses.replace(exp.diffusion_cfg,
                                                enable_interpolator_dropout=False)
        captured.update(interpolator=stepper.params["interpolator"],
                        forecaster=stepper.params["forecaster"], kwargs=kwargs)
        return stepper, in_names, forcing_names

    bench.build = build
    try:
        _load_jax_script().main(ARGV + ["--out", str(out), "--writer"])
    finally:
        bench.build = real
    with open(out / "rollout_10yr.json") as f:
        artifact = json.load(f)
    with open(out / "metrics_full.json") as f:
        metrics = json.load(f)
    return dict(out=out, artifact=artifact, metrics=metrics, params=captured)


def _port_run(jax_run, out, extra=()):
    args = rollout_10yr.parse_args(ARGV + ["--device", "cpu", "--out", str(out), *extra])
    params = jax_run["params"]
    stepper = main_path.build(args.embed, args.layers, args.dtype, use_pallas=args.use_pallas,
                              fused_mlp=False, fused_tail=args.fused_tail, peel=args.peel,
                              scan_layers=args.scan_layers, preds_dtype=args.preds_dtype,
                              device="cpu", enable_interpolator_dropout=False,
                              flax_params={"interpolator": params["interpolator"],
                                           "forecaster": params["forecaster"]})
    return rollout_10yr.rollout_artifact(stepper, args, verbose=False)


def test_rollout_artifact_matches_jax_script(jax_run, tmp_path):
    """The same configuration as the JAX script's build (its keyword
    arguments), the same keys in ``rollout_10yr.json`` (the port's
    configuration a superset), every step's RMSE row finite and
    ``metrics_full.json`` within ``LOG_REL``; the predictions written with
    ``--writer`` read back as JAX's file holds them."""
    kw = jax_run["params"]["kwargs"]
    assert (kw["scan_layers"], kw["peel"], kw["preds_dtype"]) == (True, True, "float32")
    got = _port_run(jax_run, tmp_path, ["--writer"])
    want = jax_run["artifact"]
    assert set(got) == set(want)
    for k in ("throughput", "host_fractions", "numerics", "time_mean_logs"):
        assert set(got[k]) == set(want[k]), k
    assert set(want["config"]) <= set(got["config"])
    for k in want["config"]:
        if k != "note":
            assert got["config"][k] == want["config"][k], k
    assert got["numerics"]["all_steps_finite"] and want["numerics"]["all_steps_finite"]
    assert got["numerics"]["n_metric_rows"] == want["numerics"]["n_metric_rows"] == 4
    assert got["throughput"]["total_steps"] == want["throughput"]["total_steps"] == 4
    with open(tmp_path / "metrics_full.json") as f:
        metrics = json.load(f)
    assert set(metrics) == set(jax_run["metrics"])
    for k, w in jax_run["metrics"].items():
        assert abs(metrics[k] - w) <= LOG_REL * max(abs(w), 1.0), (k, metrics[k], w)
    with h5py.File(tmp_path / "autoregressive_predictions.nc", "r") as g, \
            h5py.File(jax_run["out"] / "autoregressive_predictions.nc", "r") as w:
        names = main_path.state_names(35)
        for n in names:
            a, b = g[n][()], w[n][()]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (1, 4, 180, 360)
            assert np.abs(a - b).max() <= LOG_REL * max(np.abs(b).max(), 1.0), n


def test_rollout_script_flags_follow_jax():
    """The JAX script's flags and defaults, with the port's departures:
    ``--device`` (cuda) for ``--platform``, ``--out`` under
    ``results/torch_rollout_10yr``, ``--use-pallas`` and ``--fused-tail``
    off; ``--no-peel`` is required with ``--no-scan-layers``, as in JAX."""
    jax_script = _load_jax_script()
    args = rollout_10yr.parse_args([])
    assert (args.steps, args.window, args.embed, args.layers) == (14600, 96, 256, 8)
    assert (args.dtype, args.preds_dtype, args.targets_dtype) == ("bfloat16", "bfloat16",
                                                                   "float32")
    assert (args.params_dtype, args.writer, args.fast) == (None, False, False)
    assert args.scan_layers and args.peel and not args.use_pallas and not args.fused_tail
    assert (args.device, args.out) == ("cuda", "results/torch_rollout_10yr")
    with pytest.raises(SystemExit):
        rollout_10yr.parse_args(["--no-scan-layers"])
    rollout_10yr.parse_args(["--no-scan-layers", "--no-peel"])
    src = Path(jax_script.__file__).read_text()
    for flag in ("--steps", "--window", "--embed", "--layers", "--writer", "--dtype",
                 "--params-dtype", "--preds-dtype", "--no-scan-layers", "--no-peel", "--fast",
                 "--targets-dtype"):
        assert f'"{flag}"' in src


@pytest.mark.parametrize("dtype,fused_rank", [("bfloat16", True), ("float16", False),
                                              ("float32", False)])
def test_fast_takes_k4_where_its_pair_has_an_instance(dtype, fused_rank):
    """``--fast`` is the JAX script's compose (CP rank 0.25, truncation 0.8,
    bf16 spectral IO); K4 routes the rank pipeline's middle where (``--dtype``,
    bf16) is one of its pairs, and the stepper builds either way: with
    ``--dtype float16`` the unfused pipeline that JAX's SFNO computes."""
    args = rollout_10yr.parse_args(["--fast", "--dtype", dtype, "--device", "cpu",
                                    "--embed", "16", "--layers", "3"])
    opts = rollout_10yr.fast_options(args)
    assert {k: opts[k] for k in rollout_10yr.FAST} == rollout_10yr.FAST
    assert opts["fused_rank"] == fused_rank
    st = main_path.build(args.embed, args.layers, args.dtype, img_shape=(16, 32), n_state=5,
                         horizon=3, use_pallas=False, fused_mlp=False, device="cpu", **opts)
    assert [b.filter.fused_rank for b in st.exp.model.blocks] == [False, fused_rank, False]
    assert rollout_10yr.fast_options(rollout_10yr.parse_args([])) == {}


def test_rollout_script_raises_without_a_card(monkeypatch):
    """The default device is the card; without one the script raises
    rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rollout_10yr.main(["--steps", "2", "--window", "2"])
