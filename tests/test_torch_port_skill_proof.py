"""The port's skill study (``spherical_dyffusion_tpu_torch/scripts/skill_proof.py``)
against the JAX package's ``scripts/skill_proof.py``, on the CPU at the mini
preset.

* ``conditional_forecast_std`` against JAX's (1e-12 relative);
* the deterministic parts of the study, from the same seeded weights carried
  to JAX (``utils/convert.py:state_dict_to_flax``, the SFNO's SHT matrices
  from a jitted ``apply`` that returns only them), with dropout and the
  inputs noise off and an ensemble of 2: the climatology field, the
  interpolation baselines, the per-horizon table's ``rmse``,
  ``rmse_persistence`` and ``rmse_climatology`` (JAX's computed here from
  ``evaluation.metrics`` and its experiment's ``predict``, as its script
  does), and the rollout stage's ``max_abs_normalized`` and
  ``final_state_rmse_vs_climatology``: 1e-5 relative (float32 on both
  sides; the port's dhconv through K1's wrapper, whose CPU form is the plain
  contraction, JAX's through its einsum: the same function);
* the port learns: ``skill_proof.main`` on ``tests/test_skill.py``'s
  arguments, the OU run and the chaotic calibrated recipe, each once per
  module, held to the same assertions as ``tests/test_skill.py``;
* reruns repeat bit for bit (``--reuse`` on the run's own weights), the
  weight files are flax's msgpack (read by flax), ``metrics.json`` holds the
  JAX script's keys, ``skill_report`` writes its report, and the script
  raises without a card unless ``--platform=cpu`` is given.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from spherical_dyffusion_tpu.data import StochasticDataModule as JStochasticDataModule
from spherical_dyffusion_tpu.data.datasets import (
    StochasticModalTimeSeries as JStochasticModalTimeSeries,
)
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.evaluation import metrics as JM
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecasting,
)
from spherical_dyffusion_tpu.training.experiments import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training.experiments import (
    InterpolationExperiment as JInterpolation,
)
from spherical_dyffusion_tpu.training.experiments import _stack_window
from spherical_dyffusion_tpu.training.trainer import chunked_vmap
from spherical_dyffusion_tpu_torch.data.datasets import StochasticModalTimeSeries
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.sfno import SFNO
from spherical_dyffusion_tpu_torch.scripts import skill_proof, skill_report
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.utils import flax_msgpack
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(1)  # the mini runs are fastest on one thread

REL = 1e-5  # float32 on both sides
E = 2  # members of the deterministic table (dropout off: equal members)
ROLLOUT_STEPS = 16

# tests/test_skill.py's arguments (its fixtures skill_report and chaotic_report)
SKILL_ARGS = ["--preset=mini", "--platform=cpu", "--ensemble=4", "--rollout-steps=16",
              "--epochs-interp=8", "--epochs-fc=2", "--steps-per-epoch=40"]
CHAOTIC_ARGS = SKILL_ARGS[:3] + ["--system=chaotic"] + SKILL_ARGS[3:] + [
    "--dropout", "0.5", "--inputs-noise", "0.2"]


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


# ------------------------------------------------------------ analytic spread

def test_conditional_forecast_std_matches_jax():
    names = ["var_0", "var_1"]
    for rho, sigma in ((0.9, 0.35), (0.7, 1.3)):
        port = StochasticModalTimeSeries(names, n_timesteps=8, spatial_shape=(4, 8), rho=rho,
                                         sigma=sigma)
        ref = JStochasticModalTimeSeries(names, n_timesteps=8, spatial_shape=(4, 8), rho=rho,
                                         sigma=sigma)
        for h in range(1, 7):
            assert _rel(port.conditional_forecast_std(h), ref.conditional_forecast_std(h)) \
                <= 1e-12, (rho, sigma, h)


# ------------------------------------------------- the deterministic parts

def _jax_variables(model, params, *args, **kwargs):
    """The JAX SFNO's variables for ``params``, its "constants" (the SHT
    matrices) from a jitted apply that returns only them."""
    consts = jax.jit(lambda p, a, k: model.apply({"params": p}, *a, mutable=["constants"],
                                                 **k)[1])(params, args, kwargs)
    return {"params": params, **consts}


def _jax_sfno_config(cfg):
    keep = ("img_shape", "in_chans", "out_chans", "embed_dim", "num_layers", "with_time_emb",
            "dropout_mlp", "min_time", "max_time")
    return JSFNOConfig(**{k: getattr(cfg, k) for k in keep})


@pytest.fixture(scope="module")
def pair():
    """Both packages' mini study with the same seeded weights, dropout off:
    ``{"P", "port": {dm, interp, fexp, normalizer, w, clim}, "jax": {dm,
    fexp, fparams}}``."""
    args = skill_proof.parser().parse_args(["--preset=mini", "--platform=cpu", "--dropout=0"])
    P = skill_proof.preset(args)
    H, C = P["horizon"], P["channels"]
    dm = skill_proof.datamodule(P, "ou")
    icfg = skill_proof.sfno_config(P, args, interpolator=True)
    fcfg = skill_proof.sfno_config(P, args, interpolator=False)
    imodel, fmodel = SFNO(icfg), SFNO(fcfg)
    imodel.init_weights(torch.Generator().manual_seed(0))
    fmodel.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():  # spectral weights large enough that the filters show
        for m in (imodel, fmodel):
            for name, p in m.named_parameters():
                if name.endswith("filter.weight"):
                    p.mul_(30.0)
    interp = InterpolationExperiment(
        imodel, ExperimentConfig(horizon=H, window=1, loss_function="l1", num_predictions=E,
                                 enable_inference_dropout=True),
        dm.in_packer, dm.out_packer, dm.normalizer)
    dcfg = DYffusionConfig(timesteps=H, forward_conditioning="data", lambda_reconstruction=1.0)
    ecfg = ExperimentConfig(horizon=H, loss_function="l1", num_predictions=E)
    fexp = DYffusionForecastingExperiment(fmodel, interp, dcfg, ecfg, dm.in_packer,
                                          dm.out_packer, dm.normalizer)

    jdm = JStochasticDataModule(
        system="ou", channels=C, height=P["height"], width=P["width"], horizon=H,
        n_timesteps=P["n_timesteps"], n_val_timesteps=P["n_val_timesteps"],
        batch_size=P["batch"], eval_batch_size=P["eval_bs"],
        max_val_samples=P["eval_batches"] * P["eval_bs"],
        max_train_samples=P["steps_per_epoch"] * P["batch"])
    jimodel, jfmodel = JSFNO(_jax_sfno_config(icfg)), JSFNO(_jax_sfno_config(fcfg))
    x = jnp.zeros((1, P["height"], P["width"], 2 * C))
    t = jnp.ones((1,))
    ivars = _jax_variables(jimodel, state_dict_to_flax(imodel.state_dict())["params"], x, time=t)
    fvars = _jax_variables(jfmodel, state_dict_to_flax(fmodel.state_dict())["params"], x, time=t)
    jinterp = JInterpolation(
        jimodel, JExperimentConfig(horizon=H, window=1, loss_function="l1", num_predictions=E,
                                   enable_inference_dropout=True),
        jdm.in_packer, jdm.out_packer, jdm.normalizer)
    jfexp = JForecasting(
        jfmodel, jinterp, ivars,
        JDYffusionConfig(timesteps=H, forward_conditioning="data", lambda_reconstruction=1.0),
        JExperimentConfig(horizon=H, loss_function="l1", num_predictions=E),
        jdm.in_packer, jdm.out_packer, jdm.normalizer)
    names = list(dm.cfg.in_names)
    port = dict(dm=dm, fexp=fexp, normalizer=dm.normalizer,
                w=dm.grid.horizontal.area_weights(),
                clim=skill_proof.climatology_field(dm._train_src, names, 256, "cpu"))
    return dict(P=P, port=port, jax=dict(dm=jdm, fexp=jfexp, fvars=fvars))


def _jax_clim(jdm, P):
    names = jdm.cfg.in_names
    sample = jdm._train_src.read_window(0, min(256, P["n_timesteps"]), names)
    return jnp.asarray(np.stack([sample[n].mean(0) for n in names], axis=-1))


def test_climatology_and_interpolation_baselines_match_jax(pair):
    """The JAX script's ``interp_baselines`` (its lines computed here with
    JAX's metrics) against the port's, batch by batch."""
    P, port, jx = pair["P"], pair["port"], pair["jax"]
    H = P["horizon"]
    clim = _jax_clim(jx["dm"], P)
    np.testing.assert_allclose(port["clim"].numpy(), np.asarray(clim), rtol=REL, atol=0)
    w = jnp.asarray(jx["dm"].grid.horizontal.area_weights())

    def jax_baselines(dyn):
        rc, rl = [], []
        for t in range(1, H):
            target = dyn[:, t]
            lin = dyn[:, 0] + (dyn[:, -1] - dyn[:, 0]) * (t / H)
            rc.append(jnp.mean(JM.root_mean_squared_error(
                target, jnp.broadcast_to(clim, target.shape), w[..., None], dim=(-3, -2, -1))))
            rl.append(jnp.mean(JM.root_mean_squared_error(target, lin, w[..., None],
                                                          dim=(-3, -2, -1))))
        return float(jnp.mean(jnp.stack(rc))), float(jnp.mean(jnp.stack(rl)))

    n = 0
    for pb, jb in zip(port["dm"].val_batches(horizon=H), jx["dm"].val_batches(horizon=H)):
        got = skill_proof.interp_baselines(pb["dynamics"], port["clim"], port["w"], H)
        want = jax_baselines(jnp.asarray(jb["dynamics"]))
        for g, wv in zip(got, want):
            assert _rel(g, wv) <= REL, (g, wv)
        n += 1
    assert n == P["eval_batches"]


def test_horizon_table_matches_jax(pair):
    """The per-horizon table over the evaluation batches (JAX's
    ``make_eval``/``run_eval`` as the script writes them)."""
    P, port, jx = pair["P"], pair["port"], pair["jax"]
    H = P["horizon"]
    got = skill_proof.run_eval(port["fexp"], port["dm"], port["normalizer"], E, P, 0.0,
                               port["w"], port["clim"], torch.device("cpu"))
    jdm, jfexp = jx["dm"], jx["fexp"]
    w = jnp.asarray(jdm.grid.horizontal.area_weights())[..., None]
    clim = _jax_clim(jdm, P)
    norm = jdm.normalizer

    @jax.jit
    def eval_fn(params, aux, dyn, rng):
        init = _stack_window(norm.normalize(dyn)[:, :1])

        def member(key):
            out = jfexp.predict(params, init, key, aux_params=aux)
            return {h: out.preds[h] for h in range(1, H + 1) if h in out.preds}

        def rm(a, b):
            return jnp.mean(JM.root_mean_squared_error(a, b, w, dim=(-3, -2, -1)))

        preds = chunked_vmap(member, jax.random.split(rng, E), P["ens_chunk"])
        table = {}
        for h in preds:
            pe = norm.denormalize(preds[h])
            target = dyn[:, h]
            table[f"h{h}/rmse"] = rm(target, jnp.mean(pe, 0))
            table[f"h{h}/rmse_persistence"] = rm(target, dyn[:, 0])
            table[f"h{h}/rmse_climatology"] = rm(target, jnp.broadcast_to(clim, target.shape))
        return table

    tables = []
    for i, batch in enumerate(jdm.val_batches(horizon=H)):
        t = eval_fn(jx["fvars"], jfexp.aux_params, jnp.asarray(batch["dynamics"]),
                    jax.random.PRNGKey(i))
        tables.append({k: float(v) for k, v in t.items()})
        if len(tables) >= P["eval_batches"]:
            break
    want = {k: float(np.mean([t[k] for t in tables])) for k in tables[0]}
    assert set(want) <= set(got)
    bad = {k: (got[k], v) for k, v in want.items() if _rel(got[k], v) > REL}
    assert not bad, bad
    assert set(got) == {f"h{h}/{m}" for h in range(1, H + 1)
                        for m in ("rmse", "crps", "ssr", "rmse_persistence",
                                  "rmse_climatology")}


def test_rollout_stage_matches_jax(pair):
    """The rollout stage of ``ROLLOUT_STEPS`` steps from the first
    validation frame (the JAX script's loop, its stepper's window)."""
    P, port, jx = pair["P"], pair["port"], pair["jax"]
    H = P["horizon"]
    got = skill_proof.rollout_stability(DYffusionStepper(port["fexp"]), port["dm"],
                                        port["normalizer"], ROLLOUT_STEPS, H, port["w"],
                                        port["clim"], torch.device("cpu"))
    jdm = jx["dm"]
    names = jdm.cfg.in_names
    stepper = JStepper(jx["fexp"], jx["fvars"])
    frame0 = jdm._val_src.read_window(0, 1, names)
    x = jdm.normalizer.normalize(jnp.asarray(np.stack([frame0[n][0] for n in names], -1))[None])
    _, preds = stepper.run_window(x, None, None, None, jax.random.PRNGKey(123), ROLLOUT_STEPS,
                                  apply_inputs_noise=True)
    final = jdm.normalizer.denormalize(preds[:, -1])
    w = jnp.asarray(jdm.grid.horizontal.area_weights())
    clim = _jax_clim(jdm, P)
    want_max = float(jnp.max(jnp.abs(preds)))
    want_rmse = float(jnp.mean(JM.root_mean_squared_error(
        jnp.broadcast_to(clim, final.shape), final, w[..., None], dim=(-3, -2, -1))))
    assert _rel(got["max_abs_normalized"], want_max) <= REL, (got, want_max)
    assert _rel(got["final_state_rmse_vs_climatology"], want_rmse) <= REL, (got, want_rmse)
    assert got["max_abs_normalized_per_window"] == [got["max_abs_normalized"]]
    data = jdm._val_src.read_window(0, 256 if jdm._val_src.n_timesteps >= 256
                                    else jdm._val_src.n_timesteps, names)
    data_max = float(jnp.max(jnp.abs(jdm.normalizer.normalize(
        jnp.asarray(np.stack([data[n] for n in names], -1))))))
    assert _rel(got["data_max_abs_normalized"], data_max) <= REL


# ------------------------------------------------------------ the port learns

@pytest.fixture(scope="module")
def skill_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_skill"))
    return out, skill_proof.main(SKILL_ARGS + [f"--out={out}"])


@pytest.fixture(scope="module")
def chaotic_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_skill_chaotic"))
    return out, skill_proof.main(CHAOTIC_ARGS + [f"--out={out}"])


def test_interpolator_beats_climatology(skill_run):
    i = skill_run[1]["interpolator"]
    assert i["val_rmse"] < 0.6 * i["baseline_rmse_climatology"], i
    assert i["train_loss"][-1] < 0.8 * i["train_loss"][0]


def test_forecaster_has_skill_and_spread(skill_run):
    c = skill_run[1]["cold_sampling"]
    assert c["h1/rmse"] < 0.8 * c["h1/rmse_climatology"], c
    for k, v in c.items():
        assert np.isfinite(v), (k, v)
    assert c["h1/ssr"] > 0.0
    assert c["h1/crps"] < c["h1/rmse"]


def test_cold_sampling_not_worse_than_naive(skill_run):
    c, n = skill_run[1]["cold_sampling"], skill_run[1]["naive_sampling"]
    cold = np.mean([c[f"h{h}/crps"] for h in (1, 2, 3, 4)])
    naive = np.mean([n[f"h{h}/crps"] for h in (1, 2, 3, 4)])
    assert cold <= 1.05 * naive, (cold, naive)


def test_rollout_bounded(skill_run):
    ro = skill_run[1]["rollout"]
    assert np.isfinite(ro["max_abs_normalized"])
    assert ro["max_abs_normalized"] < 3.0 * ro["data_max_abs_normalized"], ro


def test_chaotic_system_learnable_and_finite(chaotic_run):
    r = chaotic_run[1]
    i = r["interpolator"]
    assert i["val_rmse"] < 0.7 * i["baseline_rmse_climatology"], i
    c = r["cold_sampling"]
    for k, v in c.items():
        assert np.isfinite(v), (k, v)
    assert c["h1/rmse"] < c["h1/rmse_climatology"], c
    g = r["perturbation_growth"]
    assert g[f"h{max(int(k[1:]) for k in g)}"] > 1.2, g
    assert r["rollout"]["stable"], r["rollout"]


def test_calibration_gate_emitted(chaotic_run):
    cal = chaotic_run[1]["calibration"]
    assert cal["ssr_bounds"] == [0.8, 1.15]
    horizon = max(int(k[1:]) for k in cal["cold_ssr"])
    assert set(cal["cold_ssr"]) == {f"h{h}" for h in range(1, horizon + 1)}
    assert all(np.isfinite(v) for v in cal["cold_ssr"].values())
    expected = all(0.8 <= v <= 1.15 for v in cal["cold_ssr"].values())
    assert cal["pass"] == expected


def test_calibration_canary_ssr_in_band(chaotic_run):
    c = chaotic_run[1]["cold_sampling"]
    horizon = max(int(k.split("/")[0][1:]) for k in c if k.endswith("/ssr"))
    ssr = [c[f"h{h}/ssr"] for h in range(1, horizon + 1)]
    assert all(0.25 <= v <= 1.5 for v in ssr), ssr


# ------------------------------------------------ files, reruns and the report

def test_metrics_and_report_have_the_jax_layout(skill_run):
    """``metrics.json`` holds every key of the JAX script's report (two
    committed JAX runs' files: ``skill_final`` and, which also has the
    calibration gate, ``skill_chaotic_calibrated``), section by section,
    and ``report.md`` its sections."""
    out, report = skill_run
    on_disk = json.load(open(os.path.join(out, "metrics.json")))
    results = os.path.join(os.path.dirname(__file__), "..", "results")
    for run in ("skill_final", "skill_chaotic_calibrated"):
        ref = json.load(open(os.path.join(results, run, "metrics.json")))
        missing = sorted(set(ref) - set(on_disk) - {"perturbation_growth"})
        assert not missing, (run, missing)
        for section in ("interpolator", "rollout", "calibration"):
            if section in ref:
                assert set(ref[section]) <= set(on_disk[section]), (run, section)
    H = report["params"]["horizon"]
    keys = {k.split("/", 1)[1] for k in ref["cold_sampling"]}
    assert set(on_disk["cold_sampling"]) == {f"h{h}/{k}" for h in range(1, H + 1) for k in keys}
    assert set(on_disk["analytic_spread"]) == {f"h{h}" for h in range(1, H + 1)}
    md = open(os.path.join(out, "report.md")).read()
    for head in ("## 1. Interpolator skill", "## 2. Forecaster", "## 3. Long-rollout stability"):
        assert head in md


def test_weights_are_flax_msgpack_and_rerun_repeats(skill_run, tmp_path):
    """flax reads the saved weights into the networks' trees; ``--reuse``
    of them repeats the evaluation and the rollout bit for bit (the
    generators are drawn per batch and per segment)."""
    out, report = skill_run
    for name in ("interpolator", "forecaster"):
        with open(os.path.join(out, f"{name}.msgpack"), "rb") as f:
            tree = serialization.msgpack_restore(f.read())
        sd = flax_to_state_dict(tree)
        assert sd and all(torch.isfinite(v).all() for v in sd.values())
    again = skill_proof.main(SKILL_ARGS + [f"--out={tmp_path}", f"--reuse={out}"])
    assert again["cold_sampling"] == report["cold_sampling"]
    assert again["naive_sampling"] == report["naive_sampling"]
    assert again["rollout"] == report["rollout"]
    assert again["interpolator"]["val_rmse"] == report["interpolator"]["val_rmse"]


def test_skill_report_gathers_the_runs(skill_run, chaotic_run, tmp_path):
    path = skill_report.main([f"--out={tmp_path}", f"--final={skill_run[0]}",
                              f"--chaotic={chaotic_run[0]}", f"--base={tmp_path}/none",
                              f"--sweep={tmp_path}/none*", f"--ace={tmp_path}/none"])
    text = open(path).read()
    assert f"{skill_run[1]['interpolator']['val_rmse']:.4f}" in text
    assert "## 5. The chaotic system" in text
    assert "STABLE" in text


def test_raises_without_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--platform=cuda"]):
        with pytest.raises(RuntimeError, match="--platform=cpu"):
            skill_proof.main(argv + [f"--out={tmp_path}", "--preset=mini"])
    assert not os.listdir(tmp_path)



def test_flax_msgpack_writer_matches_flax(monkeypatch):
    """``utils/flax_msgpack.py:serialize`` writes flax's
    ``msgpack_serialize`` bytes: nested dicts (flax writes them in sorted
    key order), float32/int64/bf16 arrays, numpy scalars, Python values of
    each msgpack width, and, above ``MAX_CHUNK_SIZE`` (made small here in
    both), chunked leaves; its reader restores the tree."""
    rng = np.random.default_rng(0)
    bf = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"params": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                       "a": {"c": np.arange(5, dtype=np.int64), "s": np.float32(2.5)}},
            "ints": [0, 127, 128, 70000, 2 ** 40, -1, -33, -200, -70000, -2 ** 40],
            "f": 1.5, "text": "x" * 40, "flag": True, "none": None,
            "many": {str(i): i for i in range(20)}, "bf": bf}
    want_tree = dict(tree, bf=jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    assert flax_msgpack.serialize(tree) == serialization.msgpack_serialize(want_tree)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = {"w": {"big": rng.standard_normal(50).astype(np.float32), "small": np.ones(3)}}
    data = flax_msgpack.serialize(big)
    assert data == serialization.msgpack_serialize(big)
    np.testing.assert_array_equal(flax_msgpack.restore(data)["w"]["big"], big["w"]["big"])
