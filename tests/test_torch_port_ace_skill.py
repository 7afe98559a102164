"""The port's ACE skill check (``spherical_dyffusion_tpu_torch/scripts/ace_skill.py``)
against the JAX package's ``scripts/ace_skill.py``, on the CPU at the mini
preset.

* ``rollout`` and ``score`` on the same seeded weights carried to JAX
  (``utils/convert.py:state_dict_to_flax``; the SHT matrices from a jitted
  ``apply`` that returns only them), in float32, against the JAX script's
  jitted scan and score written out here: the predictions, the per-lead
  RMSE, the climatology RMSE and the largest normalized |prediction| within
  1e-5 relative (the predictions relative to their largest entry), for the
  dense config (the port's dhconv through K1's wrapper, plain on the CPU)
  and the CP config t08;
* ``ace_skill.main --preset mini`` trains every config and each rollout is
  ``bounded``, with the JAX script's keys per config;
* the script raises without a card unless ``--platform=cpu`` is given.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data.datamodule import StochasticDataModule as JStochasticDataModule
from spherical_dyffusion_tpu.evaluation import metrics as JM
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu_torch.models.sfno import SFNO
from spherical_dyffusion_tpu_torch.scripts import ace_skill
from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax

torch.set_num_threads(1)  # the mini runs are fastest on one thread

REL = 1e-5  # float32 on both sides
R, ICS = 8, 4  # rollout steps and initial conditions of the parity test
JAX_REPORT_KEYS = {"train_s", "final_train_loss", "rmse_per_lead", "rmse_climatology_per_lead",
                   "max_abs_normalized", "bounded"}


def _jax_variables(model, params, *args):
    consts = jax.jit(lambda p, a: model.apply({"params": p}, *a, mutable=["constants"])[1])(
        params, args)
    return {"params": params, **consts}


@pytest.fixture(scope="module")
def data():
    """The mini preset's chaotic system in both packages, the truth windows
    (I, R + 1, H, W, C) as the script strides them, and the climatology."""
    P = ace_skill.PRESETS["mini"]
    kw = dict(system="chaotic", channels=P["channels"], height=P["height"], width=P["width"],
              horizon=1, n_timesteps=P["n_timesteps"], n_val_timesteps=P["n_val_timesteps"],
              batch_size=P["batch"])
    jdm = JStochasticDataModule(**kw)
    src = jdm._val_src
    names = jdm.cfg.in_names
    stride = max(1, (src.n_timesteps - R - 1) // (ICS - 1))
    truth = np.stack([np.stack([w[n] for n in names], -1) for w in (
        src.read_window(i * stride, R + 1, names) for i in range(ICS))]).astype(np.float32)
    sample = jdm._train_src.read_window(0, 512, names)
    clim = np.stack([sample[n].mean(0) for n in names], -1)
    return dict(P=P, jdm=jdm, truth=truth, clim=clim)


@pytest.mark.parametrize("name", ["dense", "t08"])
def test_rollout_and_score_match_jax(data, name):
    from spherical_dyffusion_tpu_torch.data.datamodule import StochasticDataModule

    P, jdm, truth, clim = data["P"], data["jdm"], data["truth"], data["clim"]
    cfg = ace_skill.model_config(P, name, dtype="float32")
    model = SFNO(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # spectral weights large enough that the filters show
        for n, p in model.named_parameters():
            if ".filter." in n:
                p.mul_(30.0)
    dm = StochasticDataModule(system="chaotic", channels=P["channels"], height=P["height"],
                              width=P["width"], horizon=1, n_timesteps=P["n_timesteps"],
                              n_val_timesteps=P["n_val_timesteps"], batch_size=P["batch"])
    norm = dm.normalizer
    w = dm.grid.horizontal.area_weights()
    t_truth = torch.from_numpy(truth)
    preds = ace_skill.rollout(model, norm, t_truth[:, 0], R)
    rmse, rmse_c, mx = ace_skill.score(preds, t_truth[:, 1:], w, torch.from_numpy(clim), norm)

    keep = ("img_shape", "in_chans", "out_chans", "embed_dim", "num_layers",
            "hard_thresholding_fraction", "rank")
    jcfg = JSFNOConfig(factorization=cfg.factorization or None,
                       **{k: getattr(cfg, k) for k in keep})
    jmodel = JSFNO(jcfg)
    params = _jax_variables(jmodel, state_dict_to_flax(model.state_dict())["params"],
                            jnp.zeros((1,) + truth.shape[2:]))
    jnorm = jdm.normalizer
    jw = jnp.asarray(jdm.grid.horizontal.area_weights())

    @jax.jit
    def jrollout(p, x0_raw):
        def step(x, _):
            y = jmodel.apply(p, x)
            return y, y

        _, ys = jax.lax.scan(step, jnorm.normalize(x0_raw), None, length=R)
        return jnorm.denormalize(ys)

    @jax.jit
    def jscore(preds, truth_tail):
        wc = jw[..., None]
        r = JM.root_mean_squared_error(truth_tail, preds, wc, dim=(-3, -2, -1))
        rc = JM.root_mean_squared_error(truth_tail, jnp.broadcast_to(clim, truth_tail.shape),
                                        wc, dim=(-3, -2, -1))
        return r.mean(0), rc.mean(0), jnp.max(jnp.abs(jnorm.normalize(preds)))

    jpreds = jnp.moveaxis(jrollout(params, jnp.asarray(truth[:, 0])), 0, 1)
    want = jscore(jpreds, jnp.asarray(truth[:, 1:]))
    jp = np.asarray(jpreds)
    assert np.abs(preds.numpy() - jp).max() <= REL * np.abs(jp).max()
    np.testing.assert_allclose(rmse.numpy(), np.asarray(want[0]), rtol=REL, atol=0)
    np.testing.assert_allclose(rmse_c.numpy(), np.asarray(want[1]), rtol=REL, atol=0)
    assert abs(float(mx) - float(want[2])) <= REL * float(want[2])
    assert ace_skill.leads_of(R) == [1, 2, 4, 8]


@pytest.fixture(scope="module")
def ace_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_skill_ace"))
    return out, ace_skill.main(["--preset", "mini", "--platform", "cpu", f"--out={out}"])


@pytest.mark.parametrize("name", list(ace_skill.CONFIGS))
def test_every_config_trains_and_stays_bounded(ace_run, name):
    out, report = ace_run
    entry = report["configs"][name]
    assert JAX_REPORT_KEYS <= set(entry)
    assert entry["bounded"], entry
    assert np.isfinite(entry["final_train_loss"])
    leads = [f"lead{k}" for k in ace_skill.leads_of(report["rollout_steps"])]
    assert list(entry["rmse_per_lead"]) == leads
    # the first lead beats climatology: the one-step forecaster learned
    assert entry["rmse_per_lead"]["lead1"] < entry["rmse_climatology_per_lead"]["lead1"]
    assert os.path.exists(os.path.join(out, "metrics.json"))


def test_raises_without_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        ace_skill.main(["--preset", "mini", f"--out={tmp_path}"])
    assert not os.listdir(tmp_path)
