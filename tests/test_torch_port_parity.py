"""The port's float64 parity oracles against the JAX package's, and the port's
SFNO and inference window against them, on the CPU.

Debug sizes: embed 16, 2 layers, 16 x 32; reference-format ``state_dict``s
from port SFNOs with every leaf redrawn from a numpy seed (so a transposed or
misnamed weight shows), and a reference-format checkpoint pair written by
``utils/parity_window.py:fabricate_reference_checkpoints`` (horizon 3, the
prescriber and the ``hack_for_imprecise_interpolation`` channel order).
Tolerances: the oracles equal JAX's bit for bit (both are float64 numpy);
the port's float32 SFNO within ``assert_activation_parity``'s 2e-5 of each
stage's scale (plus 1e-6), as ``tests/test_parity.py`` holds JAX's; the
window within 1e-4 a step in normalized space, as ``scripts/parity_check.py``.
"""

import inspect

import numpy as np
import pytest
import torch

import spherical_dyffusion_tpu.utils.parity as jparity
import spherical_dyffusion_tpu.utils.parity_window as jparity_window
from spherical_dyffusion_tpu.diffusion import DYffusionConfig as JDYffusionConfig
from spherical_dyffusion_tpu_torch.diffusion.dyffusion import DYffusionConfig
from spherical_dyffusion_tpu_torch.interface import get_model
from spherical_dyffusion_tpu_torch.utils import parity, parity_window
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax
from spherical_dyffusion_tpu_torch.utils.torch_convert import sfno_flax_to_torch

torch.set_num_threads(2)
SHAPE = (16, 32)


def _reference_sd(in_chans=5, out_chans=3, operator_type="dhconv", time=True, seed=0,
                  mlp_dropout=False, layers=2):
    """A reference-format state_dict of a port SFNO, every leaf redrawn."""
    net = get_model({"kind": "sfno", "embed_dim": 16, "num_layers": layers,
                     "operator_type": operator_type}, SHAPE, in_chans, out_chans, time,
                    0.0, 5.0, device="cpu", generator=torch.Generator().manual_seed(seed))
    sd = sfno_flax_to_torch(state_dict_to_flax(net.state_dict()), mlp_dropout=mlp_dropout)
    r = np.random.default_rng(seed + 1)
    return {k: (0.5 * r.standard_normal(v.shape)).astype(np.float32) for k, v in sd.items()}


def _oracles(sd, **kw):
    kw = dict(img_shape=SHAPE, num_layers=2, embed_dim=16, round_matrices_to_f32=True, **kw)
    return parity.NumpySFNOOracle(sd, **kw), jparity.NumpySFNOOracle(sd, **kw)


# -------------------------------------------------------------- the copies

@pytest.mark.parametrize("name", ["NumpySFNOOracle", "_Transform", "_gelu", "_silu",
                                  "_conv1x1", "_linear", "_instance_norm",
                                  "flip_lat_state_dict"])
def test_sfno_oracle_copy_is_pinned(name):
    assert inspect.getsource(getattr(parity, name)) == inspect.getsource(getattr(jparity, name))


def test_window_oracle_copy_is_pinned():
    assert inspect.getsource(parity_window.NumpyDYffusionWindowOracle) == \
        inspect.getsource(jparity_window.NumpyDYffusionWindowOracle)


@pytest.mark.parametrize("operator_type,time", [("dhconv", False), ("dhconv", True),
                                                ("diagonal", False)])
def test_sfno_oracle_equals_jax_bit_for_bit(operator_type, time):
    sd = _reference_sd(operator_type=operator_type, time=time, mlp_dropout=time)
    got, want = _oracles(sd, operator_type=operator_type, with_time_emb=time, min_time=0.0,
                         max_time=5.0)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 3, *SHAPE))
    cond = r.standard_normal((2, 2, *SHAPE))
    t = np.asarray([1.0, 3.5]) if time else None
    out, acts = got.forward(x, time=t, condition=cond)
    jout, jacts = want.forward(x, time=t, condition=cond)
    assert np.array_equal(out, jout) and acts.keys() == jacts.keys()
    assert all(np.array_equal(acts[k], jacts[k]) for k in acts)
    flipped = parity.flip_lat_state_dict(sd)
    assert all(np.array_equal(flipped[k], v) for k, v in jparity.flip_lat_state_dict(sd).items())


def _window_oracles(module, cfg_cls, sd_i, sd_f, horizon=3):
    cfg = cfg_cls(timesteps=horizon, hack_for_imprecise_interpolation=True,
                  enable_interpolator_dropout=False)
    tmin, tmax = module.build_schedule(cfg).forecaster_time_range
    kw = dict(img_shape=SHAPE, num_layers=2, embed_dim=16, with_time_emb=True,
              round_matrices_to_f32=True)
    oracle_cls = parity.NumpySFNOOracle if module is parity_window else jparity.NumpySFNOOracle
    return module.NumpyDYffusionWindowOracle(
        oracle_cls(sd_i, min_time=1, max_time=horizon - 1, **kw),
        oracle_cls(sd_f, min_time=tmin, max_time=tmax, **kw), cfg,
        out_channel_indices=np.asarray([1, 2, 3]), prescribed_channel=1)


def test_window_oracle_equals_jax_bit_for_bit():
    """Two full horizon-3 passes and a partial one, the prescriber, the
    hand-off and the input-only channel carried over."""
    sd_i, sd_f = (_reference_sd(in_chans=9, seed=s) for s in (3, 4))
    got = _window_oracles(parity_window, DYffusionConfig, sd_i, sd_f)
    want = _window_oracles(jparity_window, JDYffusionConfig, sd_i, sd_f)
    r = np.random.default_rng(5)
    x0 = r.standard_normal((1, 4, *SHAPE))
    forcing = r.standard_normal((1, 8, 1, *SHAPE))
    tgt = r.standard_normal((1, 8, *SHAPE))
    mask = (r.random((1, 8, *SHAPE)) > 0.5).astype(np.float32)
    a = got.run_window(x0, 7, forcing_norm=forcing, prescribed_target_norm=tgt, mask=mask)
    b = want.run_window(x0, 7, forcing_norm=forcing, prescribed_target_norm=tgt, mask=mask)
    assert a[1].shape == (1, 7, 3, *SHAPE)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# --------------------------------------------------- the port against them

# the reference loader's exact dropout keeps the MLP off K2 and K3 (they
# quantize the rate); with no dropout drawn, turning it off only routes the
# MLP through their plain versions
VARIANTS = {"plain": {}, "K1": {"use_pallas": True},
            "K1+K3": {"use_pallas": True, "fused_tail": True, "exact_dropout": False},
            "K1+K2": {"use_pallas": True, "fused_mlp": True, "exact_dropout": False}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("time", [False, True])
def test_port_sfno_matches_the_oracle(variant, time):
    """The port's SFNO loaded from the reference state_dict
    (``load_reference_sfno``), block by block (forward hooks) against the
    oracle; the kernels run their plain versions here."""
    sd = _reference_sd(time=time, mlp_dropout=True, seed=6)
    model = parity.load_reference_sfno(sd, SHAPE, device="cpu", min_time=0.0, max_time=5.0,
                                       **VARIANTS[variant])
    oracle = parity.NumpySFNOOracle(sd, SHAPE, 2, 16, with_time_emb=time, min_time=0.0,
                                    max_time=5.0, round_matrices_to_f32=True)
    r = np.random.default_rng(8)
    x = r.standard_normal((2, *SHAPE, 3 if time else 5)).astype(np.float32)
    kw = {}
    if time:
        kw = dict(time=np.asarray([1.0, 3.0], np.float32),
                  condition_bhwc=r.standard_normal((2, *SHAPE, 2)).astype(np.float32))
    report = parity.activation_parity_report(model, oracle, x, **kw)
    assert set(report) == {"block_0", "block_1", "output"} | ({"time_emb"} if time else set())
    parity.assert_activation_parity(report)
    again = parity.activation_parity_report(model, oracle, x, reference=oracle.forward(
        np.moveaxis(x, -1, 1), time=kw.get("time"), condition=np.moveaxis(
            kw["condition_bhwc"], -1, 1) if time else None), **kw)
    assert again == report


def test_activation_parity_catches_a_flipped_latitude():
    sd = _reference_sd(seed=9, time=False)
    model = parity.load_reference_sfno(parity.flip_lat_state_dict(sd), SHAPE, device="cpu")
    oracle = parity.NumpySFNOOracle(sd, SHAPE, 2, 16, round_matrices_to_f32=True)
    x = np.random.default_rng(1).standard_normal((1, *SHAPE, 5)).astype(np.float32)
    with pytest.raises(AssertionError, match="activation parity violated"):
        parity.assert_activation_parity(parity.activation_parity_report(model, oracle, x))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return parity_window.fabricate_reference_checkpoints(
        str(tmp_path_factory.mktemp("ref")), embed_dim=16, num_layers=2, horizon=3,
        img_shape=SHAPE)


@pytest.mark.parametrize("variant", ["plain", "K1+K3", "K1+K2"])
def test_window_parity_on_fabricated_reference_checkpoints(pair, variant):
    """7 steps (two horizon-3 passes and a partial one): the port's window,
    loaded through ``load_reference_checkpoint``, against the oracle; the
    oracle's window handed back gives the same report."""
    report = parity_window.run_window_parity_check(
        pair["forecaster"], n_steps=7, tol=1e-4, device="cpu",
        model_overrides=VARIANTS[variant], verbose=False)
    assert len(report["per_step_max_abs_diff"]) == 7 and report["max_abs_diff"] <= 1e-4
    assert report["pred_scale"] > 0.1
    again = parity_window.run_window_parity_check(
        pair["forecaster"], n_steps=7, tol=1e-4, device="cpu",
        model_overrides=VARIANTS[variant], oracle=report["oracle"], verbose=False)
    assert again["per_step_max_abs_diff"] == report["per_step_max_abs_diff"]


def test_window_parity_fails_on_a_wrong_window(pair):
    """The check can fail: a forecaster whose weights the port loads from
    a checkpoint with another seed's is held to the first checkpoint's
    oracle."""
    report = parity_window.run_window_parity_check(pair["forecaster"], n_steps=3,
                                                   device="cpu", verbose=False)
    other = parity_window.fabricate_reference_checkpoints(
        pair["stats"] + "_other", embed_dim=16, num_layers=2, horizon=3, img_shape=SHAPE,
        seed=5)
    with pytest.raises(AssertionError, match="window parity violated"):
        parity_window.run_window_parity_check(other["forecaster"], n_steps=3, device="cpu",
                                              oracle=report["oracle"], verbose=False)


def test_fabricated_pair_is_read_by_jax_as_by_the_port(pair):
    """JAX's ``load_experiment_checkpoint`` reads the fabricated pair as the
    port's loader does: the config, the weights and the EMA."""
    import spherical_dyffusion_tpu.interface as jinterface
    from spherical_dyffusion_tpu_torch import interface
    from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict

    over = {"diffusion": {"enable_interpolator_dropout": False}}
    jexp, jparams, jema, jcfg = jinterface.load_experiment_checkpoint(pair["forecaster"],
                                                                      overrides=over)
    exp, params, ema, cfg = interface.load_experiment_checkpoint(pair["forecaster"],
                                                                 overrides=over, device="cpu")
    assert cfg == jcfg and "_unit_normalization" not in cfg
    assert list(exp.in_packer.names) == pair["state_names"] == list(jexp.in_packer.names)
    for got, want in ((params, flax_to_state_dict(jparams)), (ema, flax_to_state_dict(jema)),
                      (dict(exp.interpolator.model.state_dict()),
                       flax_to_state_dict(jexp.interpolator_params))):
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert exp.diffusion_cfg.hack_for_imprecise_interpolation
