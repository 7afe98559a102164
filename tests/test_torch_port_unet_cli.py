"""The UNet on the port's paths, against the JAX package, on the CPU.

Interpolation training on a UNet as JAX's ``tests/test_training.py:291``
runs it (dim 8, ``dim_mults`` (1, 2), a time embedding; dropout off and the
timesteps pinned): the per-step losses of one epoch. A DYffusion window with
UNet interpolator and forecaster (dropout off). A JAX-saved UNet checkpoint
(msgpack) through the port's ``run_inference``. The refusal of a reference
checkpoint of a UNet, as JAX refuses it. The weight-decay set on a UNet tree
against JAX's ``_wd_mask``. ``get_model`` builds the UNet from the
``unet`` model config.

The weights are the port's, drawn from a seed and carried to JAX by
``utils/convert.py``; JAX's trainer starts from them (its initializer is
replaced, so none is compiled). Each JAX reference runs once, in a module
fixture. Tolerances: losses 1e-5 relative; the window 1e-5 of its largest
value.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu import interface as jinterface
from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu.inference.stepper import DYffusionStepper as JStepper
from spherical_dyffusion_tpu.models import UNet as JUNet
from spherical_dyffusion_tpu.models import UNetConfig as JUNetConfig
from spherical_dyffusion_tpu.parallel import make_mesh
from spherical_dyffusion_tpu.training import ExperimentConfig as JExperimentConfig
from spherical_dyffusion_tpu.training import InterpolationExperiment as JInterp
from spherical_dyffusion_tpu.training import Trainer as JTrainer
from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
from spherical_dyffusion_tpu.training.experiments import (
    DYffusionForecastingExperiment as JForecast,
)
from spherical_dyffusion_tpu.training.trainer import _wd_mask
from spherical_dyffusion_tpu_torch import interface
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.unet import UNet, UNetConfig
from spherical_dyffusion_tpu_torch.run_inference import main_from_config
from spherical_dyffusion_tpu_torch.training.experiments import (
    DYffusionForecastingExperiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(2)

H, W, C, CF, HORIZON = 8, 16, 2, 1, 3
UNET = dict(dim=8, dim_mults=(1, 2), with_time_emb=True, block_dropout=0.0,
            block_dropout1=0.0, attn_dropout=0.0)
DM = dict(channels=C, height=H, width=W, horizon=HORIZON, n_forcing=CF, batch_size=2,
          n_timesteps=10)


def _unet_kw(kind):
    cin = 2 * C + CF if kind == "interpolator" else C + CF
    return dict(img_shape=(H, W), in_chans=cin, out_chans=C, **UNET)


def _port_unet(kind, seed):
    net = UNet(UNetConfig(**_unet_kw(kind)))
    net.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases and norm affines off their init values
        g = torch.Generator().manual_seed(seed + 100)
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _jax_vars(net):
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(net.state_dict()))


@pytest.fixture(scope="module")
def pin():
    """Both packages' timestep draws pinned to 1, 2, 1, ... per sample."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", lambda key, shape, minval, maxval, *a, **k:
               jnp.asarray(([1, 2] * shape[0])[:shape[0]], jnp.int32))
    real = torch.randint

    def fake(low, high=None, size=None, *a, **k):
        if size is not None and high is not None and len(size) == 1:
            return torch.tensor(([1, 2] * size[0])[:size[0]], dtype=torch.long)
        return real(low, high, size, *a, **k)

    mp.setattr(torch, "randint", fake)
    yield
    mp.undo()


# ----------------------------------------------------------------- training

@pytest.fixture(scope="module")
def jax_fit(pin):
    """One epoch of JAX's trainer on the UNet interpolator, step by step as
    its ``fit`` runs: the per-step losses."""
    jdm = JDebugDataModule(**DM)
    net = _port_unet("interpolator", 0)
    jexp = JInterp(JUNet(JUNetConfig(**_unet_kw("interpolator"))),
                   JExperimentConfig(horizon=HORIZON), jdm.in_packer, jdm.out_packer,
                   jdm.normalizer)
    cfg = JTrainerConfig(lr=8e-3, epochs=1, use_ema=False, warmup_steps=2)
    tr = JTrainer(jexp, jdm, cfg, mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    tr._init_params = lambda *a: _jax_vars(net)  # the port's weights, no init compiled
    state = tr.init_state(next(iter(jdm.train_batches(seed=0))))
    step = tr._make_train_step()
    losses = []
    for i, b in enumerate(jdm.train_batches(seed=cfg.seed)):
        state, m = step(state, jnp.asarray(b["dynamics"]),
                        jnp.asarray(b["dynamical_condition"]), jax.random.PRNGKey(i), None)
        losses.append(float(m["loss"]))
    return dict(losses=losses, net=net)


def test_unet_interpolation_training_matches_jax(jax_fit):
    dm = DebugDataModule(**DM)
    exp = InterpolationExperiment(jax_fit["net"], ExperimentConfig(horizon=HORIZON),
                                  dm.in_packer, dm.out_packer, dm.normalizer)
    tr = Trainer(exp, dm, TrainerConfig(lr=8e-3, epochs=1, use_ema=False, warmup_steps=2))
    hist = tr.fit(val_every=100, verbose=False)
    assert len(hist["step_losses"]) == len(jax_fit["losses"]) == 3
    np.testing.assert_allclose(hist["step_losses"], jax_fit["losses"], rtol=1e-5)


def test_weight_decay_set_on_a_unet_matches_jax_wd_mask():
    """JAX decays every leaf of two or more dimensions (the conv and Dense
    kernels), never the biases, norm scales and ``g``s."""
    net = _port_unet("interpolator", 0)
    dm = DebugDataModule(**DM)
    exp = InterpolationExperiment(net, ExperimentConfig(horizon=HORIZON), dm.in_packer,
                                  dm.out_packer, dm.normalizer)
    names = {id(p): n for n, p in net.named_parameters()}
    group = Trainer(exp, dm, TrainerConfig()).init_state().optimizer.param_groups[0]
    assert group["weight_decay"] > 0
    got = {names[id(p)] for p in group["params"]}
    mask = _wd_mask(state_dict_to_flax(net.state_dict())["params"])
    want = {".".join(k.key for k in path) for path, v in
            jax.tree_util.tree_leaves_with_path(mask) if v}
    assert got == want and any(n.endswith("WSConv_0.kernel") for n in got)
    assert not any(n.endswith((".bias", ".scale", ".g")) for n in got)


# ------------------------------------------------------------------- window

def _forecasters(kind_pkg, ivars_net, fnet):
    """The DYffusion experiment of one package over the same weights."""
    dk = dict(timesteps=HORIZON, forward_conditioning="none", time_encoding="dynamics",
              enable_interpolator_dropout=False)
    if kind_pkg == "jax":
        dm = JDebugDataModule(**DM)
        interp = JInterp(JUNet(JUNetConfig(**_unet_kw("interpolator"))),
                         JExperimentConfig(horizon=HORIZON), dm.in_packer, dm.out_packer,
                         dm.normalizer)
        exp = JForecast(JUNet(JUNetConfig(**_unet_kw("forecaster"))), interp,
                        _jax_vars(ivars_net), JDYffusionConfig(**dk),
                        JExperimentConfig(horizon=HORIZON), dm.in_packer, dm.out_packer,
                        dm.normalizer, forcing_names=dm.cfg.forcing_names,
                        forcing_normalizer=dm.forcing_normalizer)
        return JStepper(exp, _jax_vars(fnet))
    dm = DebugDataModule(**DM)
    interp = InterpolationExperiment(ivars_net, ExperimentConfig(horizon=HORIZON),
                                     dm.in_packer, dm.out_packer, dm.normalizer)
    exp = DYffusionForecastingExperiment(
        fnet, interp, DYffusionConfig(**dk), ExperimentConfig(horizon=HORIZON), dm.in_packer,
        dm.out_packer, dm.normalizer, forcing_names=dm.cfg.forcing_names,
        forcing_normalizer=dm.forcing_normalizer)
    return DYffusionStepper(exp)


def test_unet_dyffusion_window_matches_jax():
    """A 5-step window (a full segment and a partial one at horizon 3) with
    UNet interpolator and forecaster, every dropout off."""
    inet, fnet = _port_unet("interpolator", 0), _port_unet("forecaster", 1)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((2, H, W, C)).astype(np.float32)
    forcing = rng.standard_normal((2, 6, H, W, CF)).astype(np.float32)
    jx, jp = _forecasters("jax", inet, fnet).run_window(
        jnp.asarray(x0), jnp.asarray(forcing), None, None, jax.random.PRNGKey(0), 5)
    x, p = _forecasters("port", inet, fnet).run_window(
        torch.from_numpy(x0), torch.from_numpy(forcing), None, None,
        torch.Generator().manual_seed(0), 5)
    for got, want in ((p, jp), (x, jx)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


# -------------------------------------------------------------- checkpoints

def _run_config(ip_path=None):
    cfg = {"experiment": "dyffusion" if ip_path else "interpolation",
           "datamodule": dict(kind="debug", **DM),
           "model": dict(kind="unet", **{k: list(v) if isinstance(v, tuple) else v
                                         for k, v in UNET.items() if k != "with_time_emb"}),
           "diffusion": {"forward_conditioning": "none", "enable_interpolator_dropout": False},
           "module": {"enable_inference_dropout": False}}
    if ip_path:
        cfg["diffusion"]["interpolator_checkpoint_path"] = ip_path
    return cfg


def test_jax_saved_unet_checkpoint_runs_through_run_inference(tmp_path):
    """JAX's ``save_experiment_checkpoint`` writes the interpolator's and
    the forecaster's msgpack checkpoints; the port's ``run_inference``
    loads both UNets with those weights and rolls out; its logs equal a
    rollout of the same weights built by hand."""
    inet, fnet = _port_unet("interpolator", 0), _port_unet("forecaster", 1)
    ip, fc = str(tmp_path / "ip.ckpt"), str(tmp_path / "fc.ckpt")
    for path, net, cfg in ((ip, inet, _run_config()), (fc, fnet, _run_config(ip))):
        state = types.SimpleNamespace(params=state_dict_to_flax(net.state_dict()), ema=None,
                                      opt_state=None, step=0)
        jinterface.save_experiment_checkpoint(path, state, cfg)
    run = {"checkpoint_path": fc, "platform": "cpu", "n_forward_steps": 6,
           "forward_steps_in_memory": 3, "verbose": False, "log_zonal_mean_images": False}
    out = main_from_config(dict(run, experiment_dir=str(tmp_path / "a")))
    exp = out["stepper"].exp
    assert isinstance(exp.model, UNet) and isinstance(exp.interpolator.model, UNet)
    for net, got in ((fnet, exp.model), (inet, exp.interpolator.model)):
        assert all(torch.equal(v, got.state_dict()[k]) for k, v in net.state_dict().items())
    # the same rollout from the same weights, loaded again: the logs equal
    again = main_from_config(dict(run, experiment_dir=str(tmp_path / "b")))
    assert again["logs"] == out["logs"]
    metrics = json.loads((tmp_path / "a" / "metrics.json").read_text())
    assert metrics["n_forward_steps"] == 6
    assert all(np.isfinite(v) for k, v in metrics.items() if k.startswith("inference/"))


def test_reference_unet_checkpoint_raises_as_in_jax(tmp_path):
    """A reference Lightning checkpoint with a UNet ``_target_``: both
    packages translate it to ``kind: unet`` and then read an SFNO's
    architecture from its weights, which raises."""
    net = _port_unet("interpolator", 0)
    ck = {"state_dict": {"model." + k: v for k, v in net.state_dict().items()},
          "hyper_parameters": {
              "model_config": {"_target_": "src.models.unet.Unet", "dim": 8},
              "datamodule_config": {"_target_": "src.datamodules.fv3gfs.FV3GFSDataModule",
                                    "in_names": ["a", "b", "f"], "forcing_names": ["f"],
                                    "out_names": ["a", "b"], "horizon": HORIZON,
                                    "window": 1}}}
    path = str(tmp_path / "unet_ref.ckpt")
    torch.save(ck, path)
    with pytest.raises(ValueError, match="state_dict holds no SFNO blocks"):
        jinterface.load_reference_checkpoint(path)
    with pytest.raises(ValueError, match="state_dict holds no SFNO blocks"):
        interface.load_experiment_checkpoint(path, device="cpu")


def test_get_model_builds_the_unet_of_its_config():
    """``configs/model/unet.json``'s model section (JSON lists) at debug
    size, on the CPU as asked, weights from the generator."""
    cfg = json.load(open(interface.__file__.replace("interface.py", "configs/model/unet.json")))
    cfg.update(dim=8, dim_mults=[1, 2], upsample_dims=[16, 32])
    gen = torch.Generator().manual_seed(3)
    net = interface.get_model(cfg, (12, 30), 5, 2, True, device="cpu", generator=gen)
    assert isinstance(net, UNet) and net.cfg.dim_mults == (1, 2)
    assert net.cfg.upsample_dims == (16, 32) and net.cfg.outer_sample_mode == "bilinear"
    assert next(net.parameters()).device.type == "cpu"
    y = net(torch.zeros(1, 12, 30, 3), time=torch.ones(1),
            condition=torch.zeros(1, 12, 30, 2))
    assert y.shape == (1, 12, 30, 2)
    again = interface.get_model(cfg, (12, 30), 5, 2, True, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))
