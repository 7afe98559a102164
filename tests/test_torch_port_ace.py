"""Parity of the port's ACE family with the JAX package, on the CPU.

The physics constants and vertical metrics, ``SigmaCoordinates`` and
``StandardNormalizer``'s state, ``ClimateData``, the corrector, the ocean,
the derived diagnostics, the conservation and weighted-sum losses, the
single-step stepper and its windowed rollout: the same numpy inputs from a
seed go through both packages in float32.

Debug size: 8 x 16 grids (16 x 32 for the SFNO stepper), K = 3 water
levels, SFNOs at embed 8 x 2 layers; the JAX kernels run interpreted, the
port's wrappers compute their plain versions. The SFNO weights are the
port's (seeded, with JAX's initializers' distributions), carried to JAX by
``utils/convert.py``, so that no JAX initializer is compiled. Tolerances: fields 1e-5 of
each field's largest value where a model runs (1e-6 for the physics alone),
as each test states; aggregator logs as ``_assert_logs`` states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.data import SigmaCoordinates as JSigma
from spherical_dyffusion_tpu.data import StandardNormalizer as JNorm
from spherical_dyffusion_tpu.evaluation import metrics as JM
from spherical_dyffusion_tpu.evaluation.aggregators import InferenceAggregator as JAgg
from spherical_dyffusion_tpu.inference import ace_stepper as jace
from spherical_dyffusion_tpu.inference import climate_data as jcd
from spherical_dyffusion_tpu.inference import corrector as jcorr
from spherical_dyffusion_tpu.inference import derived_variables as jdv
from spherical_dyffusion_tpu.inference import ocean as jocean
from spherical_dyffusion_tpu.models import SFNO as JSFNO
from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
from spherical_dyffusion_tpu.training import losses as jlosses
from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.coords import SigmaCoordinates
from spherical_dyffusion_tpu_torch.data.normalization import StandardNormalizer
from spherical_dyffusion_tpu_torch.evaluation import metrics as M
from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
from spherical_dyffusion_tpu_torch.inference import ace_stepper as ace
from spherical_dyffusion_tpu_torch.inference import climate_data as cd
from spherical_dyffusion_tpu_torch.inference import corrector as corr
from spherical_dyffusion_tpu_torch.inference import derived_variables as dv
from spherical_dyffusion_tpu_torch.inference import ocean as ocean_mod
from spherical_dyffusion_tpu_torch.training import losses
from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

K = 3
H, W = 8, 16
# hybrid levels of the size real ones have (thousands of Pa), where the
# float32 rounding point of ak before differencing shows
AK = np.array([0.0, 2000.123456789, 6500.987654321, 4000.5])
BK = np.array([0.0, 0.2, 0.55, 1.0])
LATS = np.linspace(-80, 80, H)


def _sigmas():
    return JSigma(ak=AK, bk=BK), SigmaCoordinates(ak=AK, bk=BK)


def _areas():
    return JM.spherical_area_weights(LATS, W), M.spherical_area_weights(LATS, W)


def _sample(seed=0, shape=(2, H, W)):
    """Named fields of the ACE physics, numpy float32."""
    rng = np.random.default_rng(seed)
    d = {
        "PRESsfc": 1e5 + 1e3 * rng.standard_normal(shape),
        "LHTFLsfc": 80 + 10 * rng.standard_normal(shape),
        "SHTFLsfc": 10 + 2 * rng.standard_normal(shape),
        "PRATEsfc": np.abs(3e-5 * (1 + 0.3 * rng.standard_normal(shape))),
        "tendency_of_total_water_path_due_to_advection": 1e-5 * rng.standard_normal(shape),
        "DLWRFsfc": 400 + 10 * rng.standard_normal(shape),
        "ULWRFsfc": 390 + 10 * rng.standard_normal(shape),
        "DSWRFsfc": 200 + 10 * rng.standard_normal(shape),
        "USWRFsfc": 20 + 2 * rng.standard_normal(shape),
    }
    for k in range(K):
        d[f"specific_total_water_{k}"] = np.abs(3e-3 * (1 + 0.1 * rng.standard_normal(shape)))
    return {k: v.astype(np.float32) for k, v in d.items()}


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v.copy()) for k, v in d.items()})


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3g} vs {rtol} x {scale:.3g}"


def _close_dicts(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol, k)


# ----------------------------------------------------- metrics, coords, norm

def test_physics_constants_and_vertical_metrics_match_jax():
    """The constants equal; ``vertical_integral`` and
    ``surface_pressure_due_to_dry_air`` 1e-6 of their largest value, with
    ak and bk rounded to float32 as JAX rounds them."""
    assert (M.GRAVITY, M.TIMESTEP_SECONDS, M.LATENT_HEAT_OF_VAPORIZATION) == (
        JM.GRAVITY, JM.TIMESTEP_SECONDS, JM.LATENT_HEAT_OF_VAPORIZATION)
    d = _sample(1)
    q = np.stack([d[f"specific_total_water_{k}"] for k in range(K)], -1)
    ps = d["PRESsfc"]
    ak32, bk32 = AK.astype(np.float32), BK.astype(np.float32)
    want_vi = JM.vertical_integral(jnp.asarray(q), jnp.asarray(ps), jnp.asarray(ak32),
                                   jnp.asarray(bk32))
    got_vi = M.vertical_integral(torch.from_numpy(q), torch.from_numpy(ps),
                                 torch.from_numpy(ak32), torch.from_numpy(bk32))
    _close(got_vi, want_vi, 1e-6, "vertical_integral")
    want = JM.surface_pressure_due_to_dry_air(jnp.asarray(q), jnp.asarray(ps),
                                              jnp.asarray(ak32), jnp.asarray(bk32))
    got = M.surface_pressure_due_to_dry_air(torch.from_numpy(q), torch.from_numpy(ps),
                                            torch.from_numpy(ak32), torch.from_numpy(bk32))
    _close(got, want, 1e-6, "surface_pressure_due_to_dry_air")


def test_sigma_coordinates_and_normalizer_state_match_jax():
    """``SigmaCoordinates``' coords, levels and dict form, and the
    normalizer's dict (de)normalization and state, equal JAX's."""
    js, ps = _sigmas()
    assert ps.num_levels == js.num_levels == K
    assert ps.as_dict() == js.as_dict()
    back = SigmaCoordinates.from_dict(ps.as_dict())
    np.testing.assert_array_equal(back.ak, JSigma.from_dict(js.as_dict()).ak)
    assert set(ps.coords) == set(js.coords) == {"ak", "bk"}
    ak, bk = ps.tensors("cpu")
    assert ak.dtype == torch.float32 and torch.equal(ak, torch.from_numpy(AK.astype(np.float32)))
    assert ps.tensors("cpu")[1] is bk  # made once per device

    names = ["PRESsfc", "LHTFLsfc", "specific_total_water_0"]
    means = {"PRESsfc": 1e5, "LHTFLsfc": 80.0, "specific_total_water_0": 3e-3}
    stds = {"PRESsfc": 1e3, "LHTFLsfc": 10.0, "specific_total_water_0": 3e-4}
    jn, pn = JNorm.from_dicts(means, stds, names), StandardNormalizer.from_dicts(means, stds,
                                                                                  names)
    assert pn.get_state() == jn.get_state()
    assert StandardNormalizer.from_state(pn.get_state()).get_state() == jn.get_state()
    jd, pd = _both({n: v for n, v in _sample(2).items() if n in names})
    _close_dicts({k: v.numpy() for k, v in pn.normalize_dict(pd).items()},
                 jn.normalize_dict(jd), 1e-6)
    _close_dicts({k: v.numpy() for k, v in pn.denormalize_dict(pd).items()},
                 jn.denormalize_dict(jd), 1e-6)


# -------------------------------------------------------------- ClimateData

def test_natural_sort_and_climate_data_match_jax():
    """``natural_sort``, the level stacking, every accessor (1e-6), and the
    setters writing back under the name the data holds (``PS``, ``LHFLX``)."""
    names = ["a_11", "A_2", "a_1", "b10c2", "b9c10"]
    assert cd.natural_sort(names) == jcd.natural_sort(names)
    assert cd.CLIMATE_FIELD_NAME_PREFIXES == jcd.CLIMATE_FIELD_NAME_PREFIXES
    js, ps = _sigmas()
    d = _sample(3)
    # levels inserted out of order, so the natural sort decides the stacking
    d = {**{f"specific_total_water_{k}": d[f"specific_total_water_{k}"]
            for k in reversed(range(K))}, **d}
    jd, pd = _both(d)
    jc, pc = jcd.ClimateData(jd), cd.ClimateData(pd)
    for acc in ("specific_total_water", "surface_pressure", "precipitation_rate",
                "latent_heat_flux", "evaporation_rate",
                "tendency_of_total_water_path_due_to_advection",
                "net_surface_energy_flux_without_frozen_precip"):
        _close(getattr(pc, acc), getattr(jc, acc), 1e-6, acc)
    _close(pc.total_water_path(ps), jc.total_water_path(js), 1e-6, "total_water_path")
    _close(pc.surface_pressure_due_to_dry_air(ps), jc.surface_pressure_due_to_dry_air(js),
           1e-6, "dry air")

    alt = {"PS": d["PRESsfc"], "LHFLX": d["LHTFLsfc"]}
    jd, pd = _both(alt)
    jc, pc = jcd.ClimateData(jd), cd.ClimateData(pd)
    for c, arr in ((jc, jnp.asarray), (pc, torch.from_numpy)):
        c.surface_pressure = arr(np.full((2, H, W), 7.0, np.float32))
        c.evaporation_rate = arr(np.full((2, H, W), 2e-5, np.float32))
    assert set(pc.data) == set(jc.data) == {"PS", "LHFLX"}
    _close_dicts({k: v.numpy() for k, v in pc.data.items()}, jc.data, 1e-7)
    with pytest.raises(KeyError):
        pc.precipitation_rate = torch.zeros(1)


# ---------------------------------------------------------------- corrector

@pytest.mark.parametrize("kw,rtol", [
    (dict(conserve_dry_air=True), 1e-6),
    (dict(zero_global_mean_moisture_advection=True), 1e-6),
    (dict(moisture_budget_correction="precipitation"), 1e-6),
    (dict(moisture_budget_correction="evaporation"), 1e-6),
    (dict(moisture_budget_correction="advection_and_precipitation"), 1e-6),
    (dict(moisture_budget_correction="advection_and_evaporation"), 1e-6),
    # the budget after the dry-air correction: the water-path tendency
    # differences two paths of about 30 kg/m^2 whose surface pressures the
    # correction set to within a float32 ulp (0.0078 Pa) in either package;
    # measured 2.1e-5 of the largest precipitation rate
    (dict(conserve_dry_air=True, zero_global_mean_moisture_advection=True,
          moisture_budget_correction="advection_and_precipitation"), 1e-4),
], ids=["dry_air", "zero_advection", "precipitation", "evaporation",
        "advection_and_precipitation", "advection_and_evaporation", "all"])
def test_corrector_matches_jax(kw, rtol):
    """Every mode and every budget term: each corrected field within
    ``rtol`` of its largest value."""
    js, ps = _sigmas()
    ja, pa = _areas()
    jin, pin = _both(_sample(4))
    jgen, pgen = _both(_sample(5))
    want = jcorr.CorrectorConfig(**kw).build(ja, js)(jin, jgen)
    got = corr.CorrectorConfig(**kw).build(pa, ps)(pin, pgen)
    _close_dicts({k: v.numpy() for k, v in got.items()}, want, rtol)


def test_corrector_rounds_ak_and_bk_before_differencing():
    """The dry-air correction differences ak and bk after their float32
    rounding: the same coefficients given already rounded give the same
    bits; the config's validation is JAX's."""
    _, ps = _sigmas()
    _, pa = _areas()
    _, pin = _both(_sample(4))
    _, pgen = _both(_sample(5))
    rounded = SigmaCoordinates(ak=AK.astype(np.float32).astype(np.float64),
                               bk=BK.astype(np.float32).astype(np.float64))
    cfg = corr.CorrectorConfig(conserve_dry_air=True)
    a = cfg.build(pa, ps)(pin, pgen)["PRESsfc"]
    b = cfg.build(pa, rounded)(pin, pgen)["PRESsfc"]
    assert torch.equal(a, b)
    for bad in ("rain", ""):
        with pytest.raises(ValueError):
            corr.CorrectorConfig(moisture_budget_correction=bad)
        with pytest.raises(ValueError):
            jcorr.CorrectorConfig(moisture_budget_correction=bad)


# -------------------------------------------------------------------- ocean

@pytest.mark.parametrize("slab", [False, True])
@pytest.mark.parametrize("interpolate", [False, True])
def test_ocean_matches_jax(slab, interpolate):
    """Prescribed and slab, each with and without ``interpolate``: the
    surface temperature 1e-6 of its largest value, the other fields
    untouched."""
    rng = np.random.default_rng(6)
    shape = (2, H, W)
    d = _sample(7)
    gen = {"surface_temperature": (290 + rng.standard_normal(shape)).astype(np.float32),
           **{k: d[k] for k in ("DLWRFsfc", "ULWRFsfc", "DSWRFsfc", "USWRFsfc", "LHTFLsfc",
                                "SHTFLsfc")}}
    inp = {"surface_temperature": (291 + rng.standard_normal(shape)).astype(np.float32)}
    tgt = {"surface_temperature": (300 + rng.standard_normal(shape)).astype(np.float32),
           "ocean_fraction": rng.uniform(0, 1, shape).astype(np.float32),
           "depth": rng.uniform(20, 80, shape).astype(np.float32),
           "qflux": rng.standard_normal(shape).astype(np.float32)}
    out = []
    for mod, both_i in ((jocean, 0), (ocean_mod, 1)):
        cfg = mod.OceanConfig("surface_temperature", "ocean_fraction", interpolate=interpolate,
                              slab=mod.SlabOceanConfig("depth", "qflux") if slab else None)
        oc = cfg.build(["surface_temperature"], ["surface_temperature"])
        assert oc.target_names == (["ocean_fraction", "depth", "qflux"] if slab else
                                   ["surface_temperature", "ocean_fraction"])
        out.append(oc(_both(tgt)[both_i], _both(inp)[both_i], _both(gen)[both_i]))
    want, got = out
    _close_dicts({k: v.numpy() for k, v in got.items()}, want, 1e-6)
    for k in gen:
        if k != "surface_temperature":
            np.testing.assert_array_equal(got[k].numpy(), gen[k])
    _close(ocean_mod.mixed_layer_temperature_tendency(torch.tensor(100.0), torch.tensor(5.0),
                                                      torch.tensor(50.0)),
           jocean.mixed_layer_temperature_tendency(100.0, 5.0, 50.0), 1e-7)
    with pytest.raises(ValueError):
        ocean_mod.OceanConfig("sst", "mask").build(["sst"], ["other"])


def test_ocean_mask_rounds_half_to_even():
    """The region is round(mask) == 1, half to even: 0.5 and 2.5 round
    away from 1, 1.5 to 2, 0.51 and 1.49 to 1; as in JAX."""
    mask = np.array([[0.5, 1.5, 2.5, 0.51, 1.49, 1.0, 0.49, -0.5]], np.float32)
    want_region = np.array([[False, False, False, True, True, True, False, False]])
    shape = mask.shape
    gen = {"sst": np.zeros(shape, np.float32)}
    tgt = {"sst": np.ones(shape, np.float32), "mask": mask}
    outs = []
    for mod, i in ((jocean, 0), (ocean_mod, 1)):
        oc = mod.OceanConfig("sst", "mask").build(["sst"], ["sst"])
        outs.append(np.asarray(oc(_both(tgt)[i], _both(gen)[i], _both(gen)[i])["sst"]))
    np.testing.assert_array_equal(outs[1], want_region.astype(np.float32))
    np.testing.assert_array_equal(outs[1], outs[0])


# ---------------------------------------------------------- derived, losses

def test_derived_quantities_match_jax():
    """The three diagnostics on (B, T, H, W) fields (1e-6), the registry's
    names, a diagnostic with missing inputs skipped as in JAX, and the
    shapes on ``device="meta"``."""
    js, ps = _sigmas()
    d = {k: np.stack([v, 1.01 * v, 0.98 * v], axis=1) for k, v in _sample(8).items()}
    jd, pd = _both(d)

    def jderived(data):
        return jdv.compute_derived_quantities(data, js)

    want = jderived(jd)  # eagerly: jit would fuse the budget residual's cancellation
    got = dv.compute_derived_quantities(pd, ps)
    assert list(dv.DERIVED_VARIABLE_REGISTRY) == list(jdv.DERIVED_VARIABLE_REGISTRY)
    _close_dicts({k: v.numpy() for k, v in got.items()}, want, 1e-6)
    np.testing.assert_array_equal(got["total_water_path_budget_residual"][:, 0].numpy(), 0.0)
    partial = {k: v for k, v in pd.items() if k != "LHTFLsfc"}
    want_keys = set(jax.eval_shape(jderived, {k: v for k, v in jd.items() if k != "LHTFLsfc"}))
    assert set(dv.compute_derived_quantities(partial, ps)) == want_keys
    assert "total_water_path_budget_residual" not in want_keys
    meta = {k: torch.empty((1, 2, H, W), device="meta") for k in d}
    shapes = {k: tuple(v.shape) for k, v in dv.compute_derived_quantities(meta, ps).items()}
    assert shapes == {k: (1, 2, H, W) for k in want}
    with pytest.raises(ValueError, match="already exists"):
        dv.compute_derived_quantities({**pd, "total_water_path": pd["PRESsfc"]}, ps)


def test_conservation_and_weighted_sum_losses_match_jax():
    """``conservation_loss`` on (B, T, H, W) fields: it differences global
    means of about 1e5 Pa, float32 sums taken in another order by each
    package, so within 1e-6 of 1e5 Pa times the penalty (measured 0.017 Pa
    at penalty 0.5); ``weighted_sum_loss`` of two criteria 1e-6 relative."""
    js, ps = _sigmas()
    ja, pa = _areas()
    d = {k: np.stack([v, 1.001 * v, 0.999 * v], axis=1) for k, v in _sample(9).items()}
    jd, pd = _both(d)
    want = jlosses.conservation_loss(ja, js, dry_air_penalty=0.5)(jd)
    got = losses.conservation_loss(pa, ps, dry_air_penalty=0.5)(pd)
    assert abs(float(got) - float(want)) <= 0.5 * 1e-6 * 1e5
    rng = np.random.default_rng(10)
    p, t = (rng.standard_normal((2, H, W, 3)).astype(np.float32) for _ in range(2))
    weights = {"mse": 0.3}
    want = jlosses.weighted_sum_loss({"mse": jlosses.get_loss_fn("l2"),
                                      "l1": jlosses.get_loss_fn("l1")}, weights)(
        jnp.asarray(p), jnp.asarray(t))
    got = losses.weighted_sum_loss({"mse": losses.get_loss_fn("l2"),
                                    "l1": losses.get_loss_fn("l1")}, weights)(
        torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------- the stepper

SH, SW = 16, 32
LEVELS, N_OTHER = 3, 2


def _boost(tree):
    return {k: (_boost(v) if isinstance(v, dict) else (v * 64.0 if k == "weight" else v))
            for k, v in tree.items()}


def _jax_variables(model, params, *args):
    """The JAX SFNO's variables for ``params``: its "constants" collection
    (the SHT matrices) from a jitted apply that returns only that
    collection, so no initializer and no forward is compiled."""
    consts = jax.jit(lambda p, *a: model.apply({"params": p}, *a, mutable=["constants"])[1])(
        params, *args)
    return {"params": params, **consts}


def _stepper_pair(kernels: bool, dtype: str = "float32"):
    """(JAX stepper, port stepper): ace_bench's configuration at debug size
    (``main_path.build_ace``'s names, normalizer, sigma, corrector and
    ocean), ``dtype`` compute and transforms' operands (float32 unless
    asked), the same SFNO weights (the port's, spectral weights scaled up),
    ``use_pallas`` and ``fused_tail`` with ``kernels``."""
    stepper = main_path.build_ace(embed=8, layers=2, dtype=dtype, img_shape=(SH, SW),
                                  levels=LEVELS, n_other=N_OTHER, kernels=kernels,
                                  device="cpu")
    in_names, out_names, all_names = main_path.ace_names(LEVELS, N_OTHER)
    kw = dict(img_shape=(SH, SW), in_chans=len(in_names), out_chans=len(out_names),
              embed_dim=8, num_layers=2, operator_type="dhconv", data_grid="equiangular",
              compute_dtype=dtype, sht_matmul_dtype=dtype)
    params = _boost(state_dict_to_flax(stepper.module.state_dict())["params"])
    stepper.module.load_state_dict(flax_to_state_dict(params))
    v = _jax_variables(JSFNO(JSFNOConfig(**kw)), params, jnp.zeros((1, SH, SW, len(in_names))))
    model = JSFNO(JSFNOConfig(**kw, use_pallas=kernels, fused_tail=kernels))
    norm = stepper.normalizer
    jnorm = JNorm.from_dicts(dict(zip(norm.names, norm.means.tolist())),
                             dict(zip(norm.names, norm.stds.tolist())), norm.names)
    jcfg = jace.SingleStepStepperConfig(
        in_names=in_names, out_names=out_names,
        corrector=jcorr.CorrectorConfig(conserve_dry_air=True),
        ocean=jocean.OceanConfig("surface_temperature", main_path.MASK_NAME))
    jstep = jace.SingleStepStepper(
        jcfg, lambda p, x: model.apply(p, x), v, jnorm,
        JM.spherical_area_weights(np.linspace(-89.5, 89.5, SH), SW),
        JSigma(ak=stepper.sigma.ak, bk=stepper.sigma.bk))
    return jstep, stepper, all_names


def _window(all_names, T, seed=0, start=0):
    src = main_path.AceBenchSource(all_names, 2 * T + 1, (SH, SW), seed=seed)
    return {n: v[None] for n, v in src.read_window(start, T + 1, all_names).items()}


def _stepped(out):
    return {f"{part}/{k}": np.asarray(v) for part in ("gen_data", "target_data",
                                                     "gen_data_norm", "target_data_norm")
            for k, v in getattr(out, part).items()}


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_single_step_stepper_matches_jax(kernels):
    """``run_on_batch`` at debug size against one JAX window of 2T steps:
    the port's full window of T steps (every field of its T + 1 frames, the
    per-step losses), its ``lean`` window (equal to the full one's fields),
    and a second lean window chained through ``initial_state_norm`` (the
    JAX window's last T steps, their loss, the final state), with
    ``use_pallas``/``fused_tail`` off and on (JAX's kernels interpreted):
    fields 1e-5 of their largest value, losses 1e-5 relative. The generated
    surface temperature equals the target where the mask rounds to 1;
    ``get_state`` is JAX's (the area weights 2e-6: float32 cosines in each
    package)."""
    jstep, stepper, all_names = _stepper_pair(kernels)
    T = 2
    data = _window(all_names, 2 * T)
    want = jstep.run_on_batch(data, 2 * T)
    first = {n: v[:, :T + 1] for n, v in data.items()}
    got = stepper.run_on_batch(first, T)
    want_first = {k: v[:, :T + 1] for k, v in _stepped(want).items()}
    _close_dicts(_stepped(got), want_first, 1e-5)
    assert set(got.metrics) == {"loss"} | {f"loss_step_{i}" for i in range(T)}
    for i in range(T):
        np.testing.assert_allclose(float(got.metrics[f"loss_step_{i}"]),
                                   float(want.metrics[f"loss_step_{i}"]), rtol=1e-5)
    mask = first[main_path.MASK_NAME][:, 1:] == 1
    np.testing.assert_array_equal(got.gen_data["surface_temperature"][:, 1:].numpy()[mask],
                                  first["surface_temperature"][:, 1:][mask])

    lean = stepper.run_on_batch(first, T, lean=True)
    assert lean.target_data == {} and set(lean.metrics) == {"loss"}
    for k, v in lean.gen_data.items():
        assert torch.equal(v, got.gen_data[k])
    assert torch.equal(lean.metrics["loss"], got.metrics["loss"])

    second = {n: v[:, T:] for n, v in data.items()}
    got2 = stepper.run_on_batch(second, T, initial_state_norm=got.final_input_norm, lean=True)
    _close_dicts({k: v[:, 1:].numpy() for k, v in got2.gen_data.items()},
                 {k: np.asarray(v)[:, T + 1:] for k, v in want.gen_data.items()}, 1e-5)
    np.testing.assert_allclose(float(got2.metrics["loss"]),
                               sum(float(want.metrics[f"loss_step_{i}"])
                                   for i in range(T, 2 * T)), rtol=1e-5)
    _close(got2.final_input_norm, want.final_input_norm, 1e-5, "final state")
    st, jst = stepper.get_state(), jstep.get_state()
    assert st["config"] == jst["config"] and st["sigma_coordinates"] == jst["sigma_coordinates"]
    assert st["normalizer"] == jst["normalizer"]
    np.testing.assert_allclose(st["area"], jst["area"], rtol=2e-6)


# ---------------------------------------------------------------- the rollout

IN_NAMES = ["PRESsfc", "surface_temperature"] + [f"specific_total_water_{k}"
                                                 for k in range(K)] + ["DSWRFtoa"]
OUT_NAMES = IN_NAMES[:-1]
ALL_NAMES = IN_NAMES + ["ocean_fraction"]
_WM = np.random.default_rng(11).standard_normal((len(IN_NAMES), len(OUT_NAMES))).astype(
    np.float32) * 0.3


def _ace_stats(n):
    """ace_bench's statistics: (mean, std)."""
    return ((1e5, 1e3) if n == "PRESsfc" else (1e-3, 1e-4) if "water" in n else (1.0, 0.5))


@pytest.fixture(scope="module")
def map_pair():
    """(JAX stepper, port stepper) over a small fixed map tanh(x W) (the
    rollout driver's logic, not the network, is under test), with the
    dry-air corrector, the prescribed ocean and ace_bench's statistics;
    shared by the rollout tests, so that JAX compiles its window once."""
    js, ps = JSigma(ak=np.linspace(0, 100.0, K + 1), bk=np.linspace(0, 1.0, K + 1)), \
        SigmaCoordinates(ak=np.linspace(0, 100.0, K + 1), bk=np.linspace(0, 1.0, K + 1))
    ja, pa = _areas()
    means = {n: _ace_stats(n)[0] for n in ALL_NAMES}
    stds = {n: _ace_stats(n)[1] for n in ALL_NAMES}
    kw = dict(in_names=IN_NAMES, out_names=OUT_NAMES, loss="l2")
    jstep = jace.SingleStepStepper(
        jace.SingleStepStepperConfig(**kw, corrector=jcorr.CorrectorConfig(
            conserve_dry_air=True), ocean=jocean.OceanConfig("surface_temperature",
                                                             "ocean_fraction")),
        lambda p, x: jnp.tanh(x @ jnp.asarray(_WM)), {}, JNorm.from_dicts(means, stds,
                                                                          ALL_NAMES), ja, js)
    wm = torch.from_numpy(_WM)
    pstep = ace.SingleStepStepper(
        ace.SingleStepStepperConfig(**kw, corrector=corr.CorrectorConfig(conserve_dry_air=True),
                                    ocean=ocean_mod.OceanConfig("surface_temperature",
                                                                "ocean_fraction")),
        lambda x: torch.tanh(x @ wm), StandardNormalizer.from_dicts(means, stds, ALL_NAMES),
        pa, ps)
    return jstep, pstep


def _assert_logs(got: dict, want: dict, scales: dict):
    """Aggregator logs: each within 1e-4 of its value plus 1e-5 of its
    variable's largest target value (a bias of a corrected field is a sum
    of float32 roundings near 0: 0.1 Pa on a 1e5 Pa surface pressure)."""
    assert set(got) == set(want)
    for k, w in want.items():
        var = k.rsplit("/", 1)[-1]
        tol = 1e-4 * abs(w) + 1e-5 * scales.get(var, 1.0)
        assert abs(got[k] - w) <= tol, f"{k}: {got[k]} vs {w} (tol {tol:.3g})"


@pytest.mark.parametrize("derived", [False, True])
def test_run_ace_inference_matches_jax(derived, map_pair):
    """12 steps in windows of 4 over a 13-frame source of ace_bench's data
    recipe (one numpy source read by both packages): the port's windowed
    rollout against its own single window (the last window's fields 1e-6
    from the carried state), and against JAX's summary (steps,
    ``loss_last_window`` 1e-5) and aggregator logs (``_assert_logs``), with
    ``derived`` off and on; ``ace_scored_names`` equal to JAX's."""
    jstep, pstep = map_pair
    jsrc = psrc = main_path.AceBenchSource(ALL_NAMES, 13, (H, W))
    scored = ace.ace_scored_names(pstep, psrc, derived=derived)
    assert scored == jace.ace_scored_names(jstep, jsrc, derived=derived)
    assert derived == ("surface_pressure_due_to_dry_air" in scored)
    ja, pa = _areas()
    jagg = JAgg(scored, jnp.asarray(ja), log_zonal_mean_images=False)
    pagg = InferenceAggregator(scored, pa, log_zonal_mean_images=False)
    want = jace.run_ace_inference(jstep, jsrc, 12, 4, aggregator=jagg, derived=derived,
                                  verbose=False)
    windows = []
    got = ace.run_ace_inference(pstep, psrc, 12, 4, aggregator=pagg, derived=derived,
                                verbose=False, on_window=lambda s, o: windows.append((s, o)))
    assert got["n_forward_steps"] == want["n_forward_steps"] == 12.0
    np.testing.assert_allclose(got["loss_last_window"], want["loss_last_window"], rtol=1e-5)
    assert len(got["window_seconds"]) == 3 and [s for s, _ in windows] == [0, 4, 8]
    assert got["upload_cache_skips"] == 0
    data = {n: v[None] for n, v in psrc.read_window(0, 13, ALL_NAMES).items()}
    full = pstep.run_on_batch(data, 12)
    for n in OUT_NAMES:
        _close(windows[-1][1].gen_data[n][:, 1:], full.gen_data[n][:, 9:], 1e-6, n)
    scales = {n: float(np.abs(data[n]).max()) for n in ALL_NAMES}
    scales.update(surface_pressure_due_to_dry_air=scales["PRESsfc"],
                  total_water_path=scales["PRESsfc"] / M.GRAVITY)
    _assert_logs(pagg.get_logs(), jagg.get_logs(), scales)


def test_run_ace_inference_upload_cache_and_errors(monkeypatch, map_pair):
    """A source looped by the rollout (8 frames, 16 steps in windows of 4):
    the windows at offsets 8 and 12 repeat those at 0 and 4, so two window
    buffers are uploaded; the generated fields equal one window over the
    wrapped frames (1e-6). Too short a source, and ``derived`` without
    sigma, raise."""
    _, pstep = map_pair
    src = main_path.AceBenchSource(ALL_NAMES, 8, (H, W))
    uploads = []
    real = ace.to_device
    monkeypatch.setattr(ace, "to_device", lambda t, d: (
        uploads.append(tuple(t.shape)) if t.dim() == 5 else None) or real(t, d))
    kept = []
    got = ace.run_ace_inference(pstep, src, 16, 4, n_repeats=3, verbose=False,
                                on_window=lambda s, o: kept.append(o.gen_data))
    assert uploads == [(len(ALL_NAMES), 1, 5, H, W)] * 2
    assert len(got["window_seconds"]) == 4 and got["upload_cache_skips"] == 0
    frames = src.read_window(0, 8, ALL_NAMES)
    data = {n: np.concatenate([v, v, v[:1]])[None] for n, v in frames.items()}
    full = pstep.run_on_batch(data, 16)
    for n in OUT_NAMES:
        _close(kept[-1][n][:, 1:], full.gen_data[n][:, 13:], 1e-6, n)
    with pytest.raises(ValueError, match="frames"):
        ace.run_ace_inference(pstep, src, 40, 4, n_repeats=3, verbose=False)
    nosig = ace.SingleStepStepper(ace.SingleStepStepperConfig(IN_NAMES, OUT_NAMES),
                                  pstep.model_fn, pstep.normalizer, pstep.area)
    with pytest.raises(ValueError, match="sigma"):
        ace.run_ace_inference(nosig, src, 4, 4, derived=True, verbose=False)
