"""The port's configs, flax msgpack reader, reference-conversion copy, train
command line, and the F7/F8 repairs, against the JAX package, on the CPU.

Debug sizes throughout (embed 8-16, 1-4 layers, 8 x 16 to 16 x 32). Every
command line runs with ``platform=cpu``; the checkpoints, logs and metrics
go to pytest's temporary directories.
"""

import json
import math
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import spherical_dyffusion_tpu.utils.torch_convert as jtc
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training.trainer import _wd_mask
from spherical_dyffusion_tpu.utils.config import load_config as jload_config
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch import train as ttrain
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.models.modules import MLP2d, QuantizedDropout, exact_dropout
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from spherical_dyffusion_tpu_torch.training.experiments import (
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig
from spherical_dyffusion_tpu_torch.utils import flax_msgpack
from spherical_dyffusion_tpu_torch.utils import torch_convert as ttc
from spherical_dyffusion_tpu_torch.utils.config import load_config, parse_scalar
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
JAX_CONFIGS = REPO / "spherical_dyffusion_tpu" / "configs"
PORT_CONFIGS = REPO / "spherical_dyffusion_tpu_torch" / "configs"


# ------------------------------------------------------------------ configs

def test_json_configs_are_the_yaml_tree():
    """Every JSON file equals yaml.safe_load of its YAML twin, file for file."""
    yamls = sorted(p.relative_to(JAX_CONFIGS).with_suffix("").as_posix()
                   for p in JAX_CONFIGS.rglob("*.yaml"))
    jsons = sorted(p.relative_to(PORT_CONFIGS).with_suffix("").as_posix()
                   for p in PORT_CONFIGS.rglob("*.json"))
    assert yamls == jsons and len(yamls) >= 14
    for name in yamls:
        want = yaml.safe_load((JAX_CONFIGS / f"{name}.yaml").read_text())
        assert json.loads((PORT_CONFIGS / f"{name}.json").read_text()) == want, name


def test_package_data_ships_the_json_configs():
    """Every JSON config is matched by the port's package data (setuptools
    globs with ``**`` matching any depth, the root included)."""
    import glob
    import tomllib

    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["spherical_dyffusion_tpu_torch"]
    pkg = PORT_CONFIGS.parent
    shipped = {os.path.relpath(f, pkg) for pat in patterns
               for f in glob.glob(str(pkg / pat), recursive=True)}
    files = {p.relative_to(pkg).as_posix() for p in PORT_CONFIGS.rglob("*.json")}
    assert "configs/main.json" in files and files <= shipped


_CONFIGS = ["main", "experiment/debug_interpolation", "experiment/debug_dyffusion",
            "experiment/fv3gfs_interpolation", "experiment/fv3gfs_dyffusion",
            "inference/debug", "inference/fv3gfs_10years"]
_TRAIN_OVERRIDES = ["model.embed_dim=16", "trainer.lr=4.0e-3", "trainer.weight_decay=1e-3",
                    "++model.scan_layers=yes", "datamodule.horizon=0x4", "seed=17",
                    "++new.key=[a, 2, 3.5, off]", "name='quoted name'", "verbose=Off"]
_INFERENCE_OVERRIDES = ["n_forward_steps=48", "use_ema=no", "++params_dtype=bfloat16",
                        "++overrides.diffusion.enable_interpolator_dropout=false",
                        "validation_loader.dataset.n_repeats=2", "n_ensemble=+2"]


@pytest.mark.parametrize("with_overrides", [False, True])
@pytest.mark.parametrize("name", _CONFIGS)
def test_load_config_matches_jax(name, with_overrides):
    over = []
    if with_overrides:
        over = _INFERENCE_OVERRIDES if name.startswith("inference") else _TRAIN_OVERRIDES
    want = jload_config(str(JAX_CONFIGS / f"{name}.yaml"), over)
    got = load_config(str(PORT_CONFIGS / f"{name}.json"), over)
    assert got == want


_SCALARS = ["1e-3", "4.0e-3", "4.0e3", "1.0e+5", "3.14159", ".5", "1.", "-2.5", "+5", "-1",
            "0", "08", "08.5", "0x10", "-0x1F", ".inf", "-.inf", "+.INF", ".NaN",
            "yes", "no", "on", "Off", "TRUE", "false", "y", "n", "null", "~", "NULL", "",
            "  7 ", "abc", "a b", "x,y", "a[0]", "-foo", "bfloat16", "checkpoints/a.ckpt",
            "/abs/p.json", "hf:org/repo/f.ckpt", "wandb:e/p/r:best", "${a.b}", "'quoted'",
            "'it''s'", '"dq"', "[1, 2]", "[a,b]", "[]", "[1.5, x, null, yes]"]


@pytest.mark.parametrize("raw", _SCALARS)
def test_parse_scalar_matches_yaml(raw):
    want = yaml.safe_load(raw)
    got = parse_scalar(raw)
    assert type(got) is type(want)
    if isinstance(want, list):
        assert got == want and [type(g) for g in got] == [type(w) for w in want]
    else:
        assert got == want or (isinstance(want, float) and math.isnan(want) and math.isnan(got))


@pytest.mark.parametrize("raw", ["a: b", "{a: 1}", "- x", "-", "#c", "a #c", "&x", "*x",
                                 "!!str x", "|", ">", "2001-12-14", "=", "<<", "[[1]]",
                                 "[a, {b: 1}]", "'x", '"a\\n"', "? x", "%x", "@x", "`x",
                                 ":x", "a\tb"])
def test_parse_scalar_refuses_other_forms(raw):
    with pytest.raises(ValueError):
        parse_scalar(raw)


@pytest.mark.parametrize("raw", ["010", "-0_7", "0b11", "+0b1", "1_000", "1_0.5", "1:30",
                                 "1:30.5", "0x1_0"])
def test_parse_scalar_refuses_numbers_the_configs_do_not_use(raw):
    """Binary, octal, sexagesimal and underscored numbers, which YAML reads
    as numbers, raise rather than be read."""
    assert isinstance(yaml.safe_load(raw), (int, float))
    with pytest.raises(ValueError, match="write it in decimal"):
        parse_scalar(raw)


def test_unknown_override_key_raises_as_in_jax():
    path = str(PORT_CONFIGS / "main.json")
    with pytest.raises(KeyError):
        load_config(path, ["model.no_such_key=1"])
    with pytest.raises(KeyError):
        jload_config(str(JAX_CONFIGS / "main.yaml"), ["model.no_such_key=1"])
    assert load_config(path, ["+model.no_such_key=1"])["model"]["no_such_key"] == 1


# ------------------------------------------------------------ msgpack reader

def _leaf_equal(want, got, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _leaf_equal(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            _leaf_equal(w, g, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes(), where
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert np.shape(got) == np.shape(want), where
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


def test_reader_matches_flax_on_a_built_tree():
    r = np.random.default_rng(0)
    tree = {
        "f32": r.standard_normal((3, 4)).astype(np.float32),
        "bf16": jnp.asarray(r.standard_normal((2, 5)), jnp.bfloat16),
        "i32": np.arange(7, dtype=np.int32),
        "bool": np.array([True, False, True]),
        "c64": (r.standard_normal(3) + 1j * r.standard_normal(3)).astype(np.complex64),
        "f64_scalar": np.float64(2.5), "i64_scalar": np.int64(-3), "f32_scalar": np.float32(1.5),
        "complex": 3 + 4j, "none": None, "str": "text", "ints": [0, 127, 128, 65536, 2**40,
                                                                   -1, -33, -70000, -2**40],
        "float": 0.1, "true": True,
        "nested": {"a": {"b": {"c": np.zeros((0,), np.float32)}}, "empty": {}},
        "long": np.ones((20, 20), np.float64), "scalar_array": np.asarray(7.0, np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    _leaf_equal(serialization.msgpack_restore(data), flax_msgpack.restore(data))


def test_reader_joins_chunked_leaves(monkeypatch):
    """Leaves above MAX_CHUNK_SIZE are written in chunks (forced here with a
    small limit on the JAX side); the reader joins them as flax does."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    r = np.random.default_rng(1)
    tree = {"big": r.standard_normal((9, 7)).astype(np.float32),
            "bf": jnp.asarray(r.standard_normal((50,)), jnp.bfloat16),
            "deep": {"x": np.arange(100, dtype=np.int32), "small": np.ones(3, np.float32)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _leaf_equal(serialization.msgpack_restore(data), flax_msgpack.restore(data))


def test_reader_matches_flax_on_skill_fast08():
    path = REPO / "results" / "skill_fast08" / "forecaster.msgpack"
    if not path.exists():
        pytest.skip(f"{path.relative_to(REPO)} is not in this checkout")
    data = path.read_bytes()
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    _leaf_equal(want, got)
    model = SFNO(SFNOConfig(img_shape=(64, 128), in_chans=4, out_chans=2, embed_dim=64,
                            num_layers=4, with_time_emb=True, min_time=0, max_time=5,
                            hard_thresholding_fraction=0.8, factorization="cp", rank=0.25))
    model.load_state_dict(flax_to_state_dict(got), strict=True)


@pytest.mark.parametrize("data,match", [(b"\xc1", "type byte"), (b"\xd4\x09\x00", "ext code"),
                                        (b"\x81\x01\x02", "map key"), (b"\x92\x01", "truncated"),
                                        (b"\x01\x02", "after the tree")])
def test_reader_raises_on_what_it_does_not_know(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.restore(data)


# ------------------------------------------------------- torch_convert copy

def _jax_sfno_params(dropout: float, layers: int = 2):
    cfg = JSFNOConfig(img_shape=(8, 16), in_chans=3, out_chans=3, embed_dim=8,
                      num_layers=layers, with_time_emb=True, dropout_mlp=dropout)
    v = JSFNO(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8, 16, 3)), time=jnp.ones((1,)))
    return jax.device_get(v)


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
        assert got.dtype == want.dtype, where
    else:
        assert got == want, where


@pytest.mark.parametrize("mlp_dropout", [False, True])
def test_torch_convert_copy_is_pinned_to_original(mlp_dropout):
    """The copy's functions return exactly the original's arrays and dicts,
    on a debug SFNO with and without MLP dropout (fc2 at index 3 or 2)."""
    params = _jax_sfno_params(0.1 if mlp_dropout else 0.0)
    sd = jtc.sfno_flax_to_torch(params, mlp_dropout=mlp_dropout)
    _same(ttc.sfno_flax_to_torch(params, mlp_dropout=mlp_dropout), sd)
    _same(ttc.sfno_torch_to_flax(sd, 2), jtc.sfno_torch_to_flax(sd, 2))
    _same(ttc.infer_sfno_architecture(sd), jtc.infer_sfno_architecture(sd))
    full = {**{f"model.model.{k}": v for k, v in sd.items()},
            **{f"model.interpolator.model.{k}": v + 1 for k, v in sd.items()},
            **{"model_ema." + ("model." + k).replace(".", ""): v * 2 for k, v in sd.items()}}
    for state in (full, {f"model.{k}": v for k, v in sd.items()}):
        want, got = jtc.split_reference_state_dict(state), ttc.split_reference_state_dict(state)
        _same(got, want)
        if want["ema"]:
            _same(ttc.ema_backbone_state_dict(want["backbone"], want["ema"], "model."),
                  jtc.ema_backbone_state_dict(want["backbone"], want["ema"], "model."))
    _same(ttc.strip_prefix(full, "model.model."), jtc.strip_prefix(full, "model.model."))


@pytest.mark.parametrize("hparams", [
    {},
    {"model_config": {"_target_": "src.models.sfno.sfnonet.SphericalFourierNeuralOperatorNet",
                      "_recursive_": False, "embed_dim": 16, "activation_function": "gelu",
                      "loss_function": "mse"},
     "datamodule_config": {"_target_": "x.FV3GFS", "horizon": 6, "in_names": ["a", "b"]},
     "diffusion_config": {"_target_": "src.diffusion.dyffusion.DYffusion", "timesteps": 6,
                          "interpolator_checkpoint_path": "x", "log_every_t": 2,
                          "loss_function": "l1", "forward_conditioning": "none"},
     "num_predictions": 5, "use_ema": True, "prediction_inputs_noise": 0.1},
    {"model_config": {"_target_": "src.models.unet.Unet", "dim": 32, "exact_dropout": False}},
])
def test_translate_reference_hparams_copy_is_pinned(hparams):
    assert ttc.translate_reference_hparams(hparams) == jtc.translate_reference_hparams(hparams)


def test_load_lightning_checkpoint_copy_is_pinned(tmp_path):
    sd = jtc.sfno_flax_to_torch(_jax_sfno_params(0.0))
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": {"num_predictions": 3}, "epoch": 1}, path)
    got, want = ttc.load_lightning_checkpoint(path), jtc.load_lightning_checkpoint(path)
    _same(got[0], want[0])
    assert got[1] == want[1]


# --------------------------------------------------------------- train CLI

def _cli(tmp_path, *extra, n_timesteps=12):
    return ["platform=cpu", f"ckpt_dir={tmp_path}", f"++log_dir={tmp_path / 'logs'}",
            "trainer.epochs=1", f"datamodule.n_timesteps={n_timesteps}", "verbose=false",
            *extra]


def _equal_state_dicts(a, b):
    assert set(a) == set(b)
    assert all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def test_train_cli_checkpoint_reloads_bit_for_bit(tmp_path):
    """Train the interpolator, then the forecaster; each checkpoint reloads
    (``load_experiment_checkpoint``) into networks equal to the trainer's,
    with its EMA; the rollout of the forecaster's checkpoint through the
    inference command line equals the rollout of the trained experiment
    before the save (dropout on: the same seeds give the same draws)."""
    ip = ttrain.run_model(None, ["experiment=debug_interpolation"] + _cli(tmp_path))
    fc = ttrain.run_model(None, ["experiment=debug_dyffusion",
                                 f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"]
                          + _cli(tmp_path))
    for run in (ip, fc):
        state = run["trainer"].state
        exp, params, ema, cfg = interface.load_experiment_checkpoint(run["ckpt_path"])
        _equal_state_dicts(params, state.model.state_dict())
        _equal_state_dicts(exp.model.state_dict(), state.model.state_dict())
        _equal_state_dicts(ema, state.ema.state_dict())
        assert cfg == run["config"] and cfg["platform"] == "cpu"
    from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
    from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
    from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
    from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries

    exp = fc["trainer"].exp
    names = list(exp.in_packer.names) + list(exp.forcing_names)
    src = SyntheticTimeSeries(names, n_timesteps=7, spatial_shape=(16, 32))
    agg = InferenceAggregator(list(exp.out_packer.names), src.horizontal.area_weights(),
                              log_zonal_mean_images=False,
                              normalizer=exp.normalizer.subset(list(exp.out_packer.names)))
    before = DYffusionStepper(exp, use_ema_params=True,
                              ema_params=fc["trainer"].state.ema.state_dict())
    run_inference(before, src, InferenceConfig(n_forward_steps=12, forward_steps_in_memory=6,
                                               n_repeats=12), aggregator=agg, verbose=False)
    out = main_from_config({"platform": "cpu", "checkpoint_path": fc["ckpt_path"],
                            "experiment_dir": str(tmp_path / "inf"), "n_forward_steps": 12,
                            "forward_steps_in_memory": 6, "log_zonal_mean_images": False,
                            "verbose": False})
    assert out["logs"] == agg.get_logs()
    metrics = json.loads((tmp_path / "inf" / "metrics.json").read_text())
    assert all(metrics[k] == v for k, v in out["logs"].items())
    rows = (tmp_path / "inf" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 + 12


def test_train_cli_resumes_and_resume_new_starts_over(tmp_path):
    """Two one-epoch runs of the command line (the second resuming from the
    first's checkpoint with ``trainer.epochs=2``) equal one two-epoch run;
    ``resume=new`` trains from scratch."""
    base = ["experiment=debug_interpolation"]
    a, b = tmp_path / "a", tmp_path / "b"
    whole = ttrain.run_model(None, base + _cli(a, "trainer.epochs=2", n_timesteps=16))
    ttrain.run_model(None, base + _cli(b, n_timesteps=16))
    resumed = ttrain.run_model(None, base + _cli(b, "trainer.epochs=2", n_timesteps=16))
    assert resumed["trainer"].state.step == whole["trainer"].state.step == 4
    assert resumed["history"]["step_losses"] == whole["history"]["step_losses"][2:]
    _equal_state_dicts(resumed["trainer"].state.model.state_dict(),
                       whole["trainer"].state.model.state_dict())
    fresh = ttrain.run_model(None, base + _cli(b, "trainer.epochs=2", "++resume=new",
                                               n_timesteps=16))
    assert fresh["trainer"].state.step == 4
    assert fresh["history"]["step_losses"] == whole["history"]["step_losses"]


def _raise_or_signal(monkeypatch, action):
    """make_logger's loggers, with ``action`` run at the first log call
    (``run_model`` imports ``make_logger`` when it runs)."""
    from spherical_dyffusion_tpu_torch.utils import loggers

    class Hook(loggers.MultiLogger):
        fired = False

        def log(self, metrics, step=None):
            if not Hook.fired:
                Hook.fired = True
                action()
            super().log(metrics, step)

    real = loggers.make_logger

    def make(cfg, out_dir="logs"):
        return Hook(real(cfg, out_dir).loggers)

    monkeypatch.setattr(loggers, "make_logger", make)


def test_melk_writes_a_checkpoint_on_sigusr1(tmp_path, monkeypatch):
    ckpt = tmp_path / "debug-ipol_last.ckpt"
    seen = {}

    def fire():
        os.kill(os.getpid(), signal.SIGUSR1)
        seen["exists"] = ckpt.exists()

    before = signal.getsignal(signal.SIGUSR1)
    _raise_or_signal(monkeypatch, fire)
    out = ttrain.run_model(None, ["experiment=debug_interpolation", "++trainer.log_every=1"]
                           + _cli(tmp_path))
    assert seen["exists"]
    assert signal.getsignal(signal.SIGUSR1) == before
    payload = Trainer.load_checkpoint(str(ckpt))
    assert payload["step"] == out["trainer"].state.step


def test_melk_writes_a_checkpoint_when_training_raises(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("boom")

    _raise_or_signal(monkeypatch, boom)
    with pytest.raises(RuntimeError, match="boom"):
        ttrain.run_model(None, ["experiment=debug_interpolation", "++trainer.log_every=1"]
                         + _cli(tmp_path))
    payload = Trainer.load_checkpoint(str(tmp_path / "debug-ipol_last.ckpt"))
    assert payload["step"] >= 1 and json.loads(payload["config_json"])["name"] == "debug-ipol"


# ---------------------------------------------------------- default device

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path):
    """Without ``platform: cpu`` every new entry point asks for the card,
    and without one raises rather than run on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interface.resolve_device({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run_model(None, ["experiment=debug_interpolation", f"ckpt_dir={tmp_path}"])
    ip = ttrain.run_model(None, ["experiment=debug_interpolation"] + _cli(tmp_path))
    payload = torch.load(ip["ckpt_path"], weights_only=True)
    cfg = json.loads(payload["config_json"])
    cfg.pop("platform")
    payload["config_json"] = json.dumps(cfg)
    torch.save(payload, str(tmp_path / "no_platform.ckpt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interface.load_experiment_checkpoint(str(tmp_path / "no_platform.ckpt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interface.get_experiment(cfg, interface.get_datamodule(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_from_config({"checkpoint_path": ip["ckpt_path"]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interface.get_model(cfg["model"], (8, 16), 3, 3, True)
    assert interface.resolve_device({"platform": "cpu"}) == torch.device("cpu")
    with pytest.raises(ValueError):
        interface.resolve_device({"platform": "tpu"})


def test_get_model_always_draws_its_weights():
    """Without a generator the weights are drawn from seed 0, as with an
    explicit one; never left as uninitialised memory."""
    cfg = {"kind": "sfno", "embed_dim": 8, "num_layers": 1}
    got = interface.get_model(cfg, (8, 16), 3, 3, True, device="cpu").state_dict()
    want = interface.get_model(cfg, (8, 16), 3, 3, True, device="cpu",
                               generator=torch.Generator().manual_seed(0)).state_dict()
    other = interface.get_model(cfg, (8, 16), 3, 3, True, device="cpu",
                                generator=torch.Generator().manual_seed(1)).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(not torch.equal(got[k], other[k]) for k in want)


@pytest.mark.parametrize("cfg,match", [
    ({"stepper_type": "ace", "log_video": True,
      "data_writer": {"save_raw_prediction_names": ["a"]}}, "save_raw_prediction_names"),
    ({"data_writer": {"save_raw_prediction_names": ["a"]}}, "save_raw_prediction_names"),
    ({"log_video": True, "data_writer": {"save_histogram_files": True,
                                         "save_raw_prediction_names": []}},
     "save_prediction_files is False")])
def test_run_inference_refuses_unported_options(cfg, match):
    """The writers and ``log_video`` are ported (Queue 1 item 8b): the
    options that remain refused are JAX's ``DataWriterConfig`` errors, which
    both paths raise before any checkpoint is read."""
    with pytest.raises(ValueError, match=match):
        main_from_config({"platform": "cpu", "checkpoint_path": "unused", **cfg})


def test_unported_kinds_and_channels_name_their_item(tmp_path, monkeypatch):
    import urllib.error

    from spherical_dyffusion_tpu_torch.utils.checkpointing import resolve_checkpoint_path
    from spherical_dyffusion_tpu_torch.utils.loggers import WandbLogger, make_logger

    # the network channels are ported (item 8e): against a closed local port
    # they reach the network and fail there
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")
    monkeypatch.setenv("WANDB_BASE_URL", "http://127.0.0.1:9")
    for spec in ("hf:org/repo/x.ckpt", "wandb:e/p/r"):
        with pytest.raises(urllib.error.URLError):
            resolve_checkpoint_path(spec, cache_dir=str(tmp_path / "cache"))
    # the fv3gfs datamodule is ported (item 8a): built from a stats
    # directory; without one, JAX's error (a path join of None)
    import spherical_dyffusion_tpu.interface as jinterface
    from spherical_dyffusion_tpu_torch.data.datamodule import FV3GFSDataModule
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5

    fv3 = {"kind": "fv3gfs", "in_names": ["a"], "out_names": ["a"]}
    errors = []
    for get in (interface.get_datamodule, jinterface.get_datamodule):
        with pytest.raises(TypeError) as e:
            get({"datamodule": fv3})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for name, value in (("centering.nc", 1.5), ("scaling.nc", 2.0)):
        write_hdf5(str(tmp_path / name), {"a": np.float32(value)})
    dm = interface.get_datamodule({"datamodule": dict(fv3, data_dir_stats=str(tmp_path))})
    assert isinstance(dm, FV3GFSDataModule)
    assert dm.normalizer.get_state() == {"means": {"a": 1.5}, "stds": {"a": 2.0}}
    # the UNet is ported (item 6): get_model builds it
    from spherical_dyffusion_tpu_torch.models.unet import UNet
    net = interface.get_model({"kind": "unet", "dim": 8, "dim_mults": [1, 2]}, (8, 16), 3, 3,
                              True, device="cpu")
    assert isinstance(net, UNet) and net.cfg.in_chans == 3 and net.cfg.with_time_emb
    monkeypatch.delenv("WANDB_BASE_URL")
    lg = make_logger({"logger": {"wandb": {"project": "p"}}}, str(tmp_path))
    assert isinstance(lg.loggers[-1], WandbLogger) and lg.loggers[-1]._native is None
    lg.finish()
    dm = DebugDataModule(channels=2, height=8, width=16, horizon=3)
    # the simultaneous experiment is ported (item 5): it builds
    exp = interface.get_experiment({"experiment": "simultaneous"}, dm, device="cpu")
    assert exp.horizon_at_once == 3 and not exp.model.cfg.with_time_emb
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "a.ckpt").write_bytes(b"x")
    assert resolve_checkpoint_path(str(tmp_path)) == str(tmp_path / "sub" / "a.ckpt")
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_path(str(tmp_path / "missing.ckpt"))


# -------------------------------------------------------------- F7 and F8

def _decayed_names(trainer: Trainer):
    names = {id(p): n for n, p in trainer.exp.model.named_parameters()}
    decay_group = trainer.init_state().optimizer.param_groups[0]
    assert decay_group["weight_decay"] > 0
    return {names[id(p)] for p in decay_group["params"]}


def _jax_decayed_names(variables, num_layers):
    """JAX's ``_wd_mask`` over its own layout, by port parameter name: a
    stacked ``blocks_mid/block`` leaf stands for blocks 1 .. L-2."""
    mask = _wd_mask(variables["params"])
    out = set()

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            elif v:
                out.add(prefix + (k,))

    walk(jax.device_get(mask), ())
    names = set()
    for path in out:
        if path[:2] == ("blocks_mid", "block"):
            names |= {".".join((f"block_{i}",) + path[2:]) for i in range(1, num_layers - 1)}
        else:
            names.add(".".join(path))
    return names


@pytest.mark.parametrize("scan_layers", [False, True])
def test_weight_decay_set_matches_jax_wd_mask(scan_layers):
    """F7: the parameters the port decays are those JAX's ``_wd_mask``
    decays, in both layouts; under ``scan_layers`` that adds the nine 1-D
    leaves of every middle block (biases of the filter, inner skip, MLP and
    time MLP; scales and biases of both norms)."""
    L = 4
    kw = dict(img_shape=(16, 32), in_chans=7, out_chans=3, embed_dim=16, num_layers=L,
              with_time_emb=True, scan_layers=scan_layers, dropout_mlp=0.1)
    jv = JSFNO(JSFNOConfig(**kw)).init(jax.random.PRNGKey(0), jnp.ones((1, 16, 32, 7)),
                                       time=jnp.ones((1,)))
    want = _jax_decayed_names(jv, L)
    dm = DebugDataModule(channels=3, height=16, width=32, horizon=3, n_forcing=1)
    net = SFNO(SFNOConfig(**kw))
    net.load_state_dict(flax_to_state_dict(jv))
    exp = InterpolationExperiment(net, ExperimentConfig(horizon=3), dm.in_packer, dm.out_packer,
                                  dm.normalizer)
    got = _decayed_names(Trainer(exp, dm, TrainerConfig()))
    assert got == want
    one_d = {n for n, p in net.named_parameters() if p.dim() == 1}
    extra = got & one_d
    if scan_layers:
        assert len(extra) == 9 * (L - 2)
        assert not any(n.startswith(("block_0.", f"block_{L - 1}.")) for n in extra)
    else:
        assert not extra
    assert not any("pos_embed" in n for n in got)


def _four_sigma(p, n):
    return 4 * math.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_exact_dropout_rate_scale_and_seeding(rate):
    """F8: each rate within 4 standard deviations, kept values scaled by
    1 / (1 - rate); one seed gives one mask, another seed another."""
    x = torch.ones(200, 1000)
    y = exact_dropout(x, rate, torch.Generator().manual_seed(0))
    keep = 1.0 - rate
    kept = y[y != 0]
    assert abs(kept.numel() / x.numel() - keep) <= _four_sigma(keep, x.numel())
    torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / keep), rtol=1e-6, atol=0)
    assert torch.equal(y, exact_dropout(x, rate, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, exact_dropout(x, rate, torch.Generator().manual_seed(1)))
    assert torch.equal(exact_dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))


def test_exact_dropout_draws_on_the_activations_device(monkeypatch):
    """F8: the uniform comes from a generator on x's device, seeded from the
    caller's host generator; nothing of x's size is drawn elsewhere."""
    real = torch.rand
    calls = []

    def spy(*args, **kw):
        calls.append((kw.get("device"), kw["generator"].device))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "rand", spy)
    x = torch.ones(4, 8, dtype=torch.bfloat16)
    y = QuantizedDropout(0.3, exact=True)(x, deterministic=False,
                                          generator=torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    assert calls == [(x.device, x.device)]


def test_exact_dropout_config_never_takes_the_fused_kernels():
    """``exact_dropout`` keeps K2 and K3 out, as in JAX (the kernels draw
    quantized masks); dropout off, the model equals JAX's (1e-5)."""
    kw = dict(img_shape=(8, 16), in_chans=3, out_chans=3, embed_dim=8, num_layers=2,
              with_time_emb=True, dropout_mlp=0.2, exact_dropout=True, exact_norm=True,
              activation_function="gelu_exact")
    for fused in (dict(fused_mlp=True), dict(fused_tail=True)):
        net = SFNO(SFNOConfig(**kw, **fused))
        assert all(not b.mlp.fused and b.mlp.drop.exact for b in net.blocks)
    mlp = MLP2d(8, 16, 8, drop_rate=0.2, fused=True, exact_dropout=True)
    assert not mlp.fused
    jv = JSFNO(JSFNOConfig(**kw)).init(jax.random.PRNGKey(1), jnp.ones((1, 8, 16, 3)),
                                       time=jnp.ones((1,)))
    x = np.random.default_rng(2).standard_normal((2, 8, 16, 3)).astype(np.float32)
    t = np.asarray([1.0, 3.0], np.float32)
    want = np.asarray(JSFNO(JSFNOConfig(**kw)).apply(jv, jnp.asarray(x), time=jnp.asarray(t)))
    net = SFNO(SFNOConfig(**kw, fused_tail=True))
    net.load_state_dict(flax_to_state_dict(jv))
    with torch.no_grad():
        got = net(torch.from_numpy(x), time=torch.from_numpy(t)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    live = net(torch.from_numpy(x), time=torch.from_numpy(t), deterministic=False,
               generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(live).all() and not np.allclose(live.detach().numpy(), got)


def test_validate_inputs_noise_is_drawn_on_the_device(monkeypatch):
    """F8: ``validate``'s inputs noise is N(0, noise^2) (mean and spread
    within 4 standard deviations), drawn from a generator on the device
    seeded from ``cfg.seed + 7``: the same seed gives the same noise,
    another seed other noise."""
    dm = DebugDataModule(channels=3, height=16, width=32, horizon=3, n_forcing=1,
                         n_timesteps=8)
    net = SFNO(SFNOConfig(img_shape=(16, 32), in_chans=7, out_chans=3, embed_dim=8,
                          num_layers=1, with_time_emb=True))
    net.init_weights(torch.Generator().manual_seed(0))
    noise = 0.3
    exp = InterpolationExperiment(net, ExperimentConfig(horizon=3, num_predictions=2,
                                                        prediction_inputs_noise=noise),
                                  dm.in_packer, dm.out_packer, dm.normalizer)
    seen = []
    real_predict = exp.predict
    real_randn = torch.randn
    devices = []

    def predict(inputs, *a, **k):
        seen.append(inputs.clone())
        return real_predict(inputs, *a, **k)

    def randn(*a, **k):
        devices.append((k.get("device"), k["generator"].device))
        return real_randn(*a, **k)

    monkeypatch.setattr(exp, "predict", predict)
    monkeypatch.setattr(torch, "randn", randn)

    def run(seed):
        seen.clear()
        tr = Trainer(exp, dm, TrainerConfig(seed=seed, use_ema=False))
        tr.validate(tr.init_state(), max_batches=1)
        return torch.cat([s.flatten() for s in seen])

    clean_inputs = exp.get_inputs_from_dynamics(
        dm.normalizer.normalize(next(iter(dm.val_batches()))["dynamics"]))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert devices and all(d == (torch.device("cpu"), torch.device("cpu")) for d in devices)
    clean = clean_inputs.repeat(2, 1, 1, 1).flatten()
    d = (a.reshape(-1, clean.numel()) - clean[None]) / noise
    n = d.numel()
    assert abs(float(d.mean())) <= 4 / math.sqrt(n)
    assert abs(float(d.std()) - 1.0) <= 4 * math.sqrt(2 / n)
