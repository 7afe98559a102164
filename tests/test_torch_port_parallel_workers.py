"""The per-rank work of ``tests/test_torch_port_parallel.py``.

Spawned processes import this module (and so no JAX): each joins a gloo
group through a ``file://`` rendezvous, runs the distributed transforms,
the trainer's gradient mean on seeded terms, data-parallel training steps
(float32 mean, bf16 mean, ZeRO-1 with its checkpoint), a stepper window
over the group, and spatial model parallelism on the meshes of
``SPATIAL_MESHES`` (the SFNO forward and the window over "h" and "w", and
on four ranks a training step on ``make_mesh(data=2, h=2)``), and writes
its results to ``<out>/rank<r>.pt``. It holds no tests.

``start_options`` spawns the four ranks of
``tests/test_torch_port_spatial_options.py``: every SFNO option of
``OPTIONS`` on ``make_mesh(data=1, h=2, w=2)`` (and the rank pipelines and
the folded Legendre stage also on "h" = 2 and "w" = 2 alone, the folded
stage on "h" = 4 and, at 18 x 32 over three of the ranks, on "h" = 3),
forwards with dropout off and live, and the ``data+noise-v1`` window and
the folded window on "h" = 2.

``start_unet`` spawns the four ranks of
``tests/test_torch_port_spatial_unet.py``: the UNets of ``UNETS`` on the
meshes of ``UNET_MESHES`` (forwards with dropout off and live), the inputs
of ``UNET_PROBES`` at h = 2, w = 2, and the main path's UNet window on "h" =
2.
"""

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spherical_dyffusion_tpu_torch import main_path
from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
from spherical_dyffusion_tpu_torch.models.unet import UNet, UNetConfig
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
from spherical_dyffusion_tpu_torch.parallel.distributed_sht import (
    distributed_dhconv,
    distributed_isht,
    distributed_sht,
)
from spherical_dyffusion_tpu_torch.parallel import mesh as mesh_module
from spherical_dyffusion_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
from spherical_dyffusion_tpu_torch.training.experiments import (
    ExperimentConfig,
    InterpolationExperiment,
)
from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

# the transforms' sizes (tests/test_parallel.py's), and the training setup
# of its _tiny_training_setup: batch 4, an SFNO at embed 8 x 1 layer on 8 x 16
H, W, C = 16, 32, 8
TRAIN_STEPS = 2
TIMESTEPS = torch.tensor([1, 2, 2, 1])


def transform_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((C, C, H, 2)) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def reduce_inputs(world: int) -> torch.Tensor:
    """(world, 4096) float32 values: row r is rank r's term of the
    gradient-mean probe."""
    rng = np.random.default_rng(world)
    return torch.from_numpy(rng.standard_normal((world, 4096)).astype(np.float32))


def transforms():
    return (RealSHT(H, W, grid="legendre-gauss"), InverseRealSHT(H, W, grid="legendre-gauss"))


def interpolation_trainer(mesh=None, **cfg) -> Trainer:
    """The interpolation experiment of ``tests/test_parallel.py``'s tiny
    setup, dropout off, weights from seed 0; ``cfg`` goes to
    ``TrainerConfig``; ``mesh`` is the trainer's (else its default)."""
    dm = DebugDataModule(channels=2, height=8, width=16, horizon=3, batch_size=4,
                         n_timesteps=24)
    model = SFNO(SFNOConfig(img_shape=(8, 16), in_chans=4, out_chans=2, embed_dim=8,
                            num_layers=1, with_time_emb=True, min_time=1, max_time=2))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # spectral weights large enough that the filter shows
        model.block_0.filter.weight.mul_(64.0)
    exp = InterpolationExperiment(model, ExperimentConfig(horizon=3), dm.in_packer,
                                  dm.out_packer, dm.normalizer)
    return Trainer(exp, dm, TrainerConfig(epochs=1, steps_per_epoch=TRAIN_STEPS,
                                          warmup_steps=1, **cfg), mesh=mesh)


def train_batches(n: int = TRAIN_STEPS):
    dm = DebugDataModule(channels=2, height=8, width=16, horizon=3, batch_size=4,
                         n_timesteps=24)
    return [b for _, b in zip(range(n), dm.train_batches(seed=0))]


def train(tr: Trainer, ckpt: str = None) -> dict:
    """``TRAIN_STEPS`` steps on ``train_batches``, each sample's diffusion
    timestep pinned to ``TIMESTEPS`` (this rank's rows of it): the per-step
    losses, one validation batch's metrics, the parameters after the steps,
    the ZeRO slices' shapes, and the checkpoint written where one is
    asked."""
    state = tr.init_state()
    gen = torch.Generator().manual_seed(1)
    rows = shard_batch(tr.mesh, TIMESTEPS)
    real = torch.randint

    def pinned(low, high=None, size=None, *a, **k):
        if size is not None and tuple(size) == tuple(rows.shape):
            return rows.clone()
        return real(low, high, size, *a, **k)

    losses = []
    torch.randint = pinned
    try:
        for batch in train_batches():
            dyn, cond, rt = tr.upload(batch)
            losses.append(float(tr.train_step(state, dyn, cond, gen, rt)["loss"]))
    finally:
        torch.randint = real
    if ckpt:
        tr.save_checkpoint(state, ckpt)
    return dict(losses=losses, val=tr.validate(state, max_batches=1),
                params={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                opt_sharded=[tuple(part.shape) for _, part in tr._zero.values()])


def window_stepper(mesh=None) -> DYffusionStepper:
    """A tiny main-path window (SFNO embed 8 x 1 on 8 x 16, 3 state
    channels, horizon 3), every dropout off."""
    st = main_path.build(embed=8, layers=1, img_shape=(8, 16), horizon=3, n_state=3,
                         dtype="float32", use_pallas=False, fused_mlp=False, device="cpu",
                         enable_interpolator_dropout=False)
    return DYffusionStepper(st.exp, prescriber=st.prescriber, mesh=mesh)


def window(stepper: DYffusionStepper):
    inp = main_path.window_inputs(6, (8, 16), 3, batch=4, device="cpu")
    return stepper.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                              torch.Generator().manual_seed(0), 6)


# spatial model parallelism: the meshes of each world, the SFNO's options
# (K3, K2, the exact instance norm, the layer norm), its debug size
MESHES = {"h2": dict(data=1, h=2), "w2": dict(data=1, w=2), "h2w2": dict(data=1, h=2, w=2),
          "d2h2": dict(data=2, h=2)}
SPATIAL_MESHES = {2: ("h2", "w2"), 4: ("h2w2", "d2h2")}
SFNO_OPTS = {"k3": dict(fused_tail=True), "k2": dict(fused_mlp=True),
             "exact_norm": dict(exact_norm=True), "layer_norm": dict(normalization_layer="layer_norm")}
GRID, IN, OUT, STATE = (16, 32), 5, 3, 5
WINDOW_PATHS = {"k3": dict(fused_tail=True, peel=True, scan_layers=True),
                "k2": dict(fused_mlp=True)}
WINDOW_STEPS = 6


def boost_filters(model) -> None:
    """Spectral weights large enough that the sharded filter shows."""
    with torch.no_grad():
        for block in model.blocks:
            block.filter.weight.mul_(64.0)


def spatial_sfno(opts: str, dropout: bool = True) -> SFNO:
    """The debug SFNO (embed 8 x 2 on 16 x 32, a time embedding, K1 on) with
    the options ``SFNO_OPTS[opts]``; MLP dropout, DropPath and the position
    embedding's dropout 0.1 with ``dropout``; weights from seed 0."""
    rate = 0.1 if dropout else 0.0
    model = SFNO(SFNOConfig(img_shape=GRID, in_chans=IN, out_chans=OUT, embed_dim=8,
                            num_layers=2, with_time_emb=True, use_pallas=True,
                            dropout_mlp=rate, drop_path_rate=rate, pos_emb_dropout=rate,
                            **SFNO_OPTS[opts]))
    model.init_weights(torch.Generator().manual_seed(0))
    boost_filters(model)
    return model


def sfno_inputs(grid=GRID):
    rng = np.random.default_rng(2)
    return (torch.from_numpy(rng.standard_normal((2,) + tuple(grid) + (IN,)).astype(np.float32)),
            torch.tensor([1.0, 2.0]))


def sfno_forward(model, x, t, mesh=None, seed: int = 5, dropout: bool = True,
                 **conds) -> torch.Tensor:
    """One forward of a backbone (with ``dropout``, dropout live where the
    model has it, from ``seed``; ``conds``: its conditions); on ``mesh``,
    this rank's block of rows and grid, gathered."""
    if mesh is not None:
        model.set_mesh(mesh)
        x, t = shard_batch(mesh, x, spatial=True), shard_batch(mesh, t)
        conds = {k: shard_batch(mesh, v, spatial=True) for k, v in conds.items()}
    try:
        with torch.no_grad():
            y = model(x, time=t, deterministic=not dropout,
                      generator=torch.Generator().manual_seed(seed), **conds)
    finally:
        model.set_mesh(None)
    return gather_batch(mesh, y, spatial=True) if mesh is not None else y


def spatial_window_stepper(path: str, dropout: bool, mesh=None,
                           **build_kw) -> DYffusionStepper:
    """The main path's window (both SFNOs at embed 8 x 2 on 16 x 32, 5 state
    channels, horizon 3, K1 and ``WINDOW_PATHS[path]``, the SST prescriber;
    ``build_kw`` more of ``main_path.build``'s options) with the
    interpolator's dropout live with ``dropout``, on ``mesh``."""
    st = main_path.build(embed=8, layers=2, img_shape=GRID, horizon=3, n_state=STATE,
                         dtype="float32", device="cpu", enable_interpolator_dropout=dropout,
                         **WINDOW_PATHS[path], **build_kw)
    for net in (st.exp.model, st.exp.interpolator.model):
        boost_filters(net)
    return DYffusionStepper(st.exp, prescriber=st.prescriber, mesh=mesh)


def spatial_window(stepper: DYffusionStepper, rows=slice(None), generator=None):
    inp = main_path.window_inputs(WINDOW_STEPS, GRID, STATE, batch=2, seed=3, device="cpu")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return stepper.run_window(inp["x0"][rows], inp["forcing"][rows], inp["sst"][rows],
                              inp["mask"][rows], gen, WINDOW_STEPS)


def spatial(world: int) -> dict:
    """Per mesh of ``SPATIAL_MESHES[world]``: the SFNO forward of every
    option with dropout live ("sfno") and of K3 and K2 with it off
    ("sfno_det"), the window of each path with the interpolator's dropout
    live ("window") and the K3 window with it off ("window_det"), all
    gathered."""
    out = {}
    x, t = sfno_inputs()
    for key in SPATIAL_MESHES[world]:
        mesh = make_mesh(**MESHES[key])
        out[key] = dict(
            sfno={o: sfno_forward(spatial_sfno(o), x, t, mesh) for o in SFNO_OPTS},
            sfno_det={o: sfno_forward(spatial_sfno(o, dropout=False), x, t, mesh)
                      for o in ("k3", "k2")},
            window={p: spatial_window(spatial_window_stepper(p, True, mesh))
                    for p in WINDOW_PATHS},
            window_det=spatial_window(spatial_window_stepper("k3", False, mesh)))
    return out


def _worker(rank: int, world: int, init: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        res = {}
        # the transforms over (h, w) = (2, world / 2), or (1, 2) on two ranks
        nh = 2 if world >= 4 else 1
        mesh = make_mesh(data=1, h=nh, w=world // nh)
        x, w = transform_inputs()
        sht, isht = transforms()
        hi, wi = mesh.index("h"), mesh.index("w")
        nw = mesh.shape["w"]
        x_blk = x[:, hi * H // nh:(hi + 1) * H // nh, wi * W // nw:(wi + 1) * W // nw]
        spec = distributed_sht(x_blk, sht, mesh)
        w_blk = w[wi * C // nw:(wi + 1) * C // nw]
        conv = distributed_dhconv(spec, w_blk, mesh)
        res.update(coords=(hi, wi), spec=spec, back=distributed_isht(spec, isht, mesh),
                   conv=conv, conv_rep=distributed_dhconv(spec, w_blk, mesh,
                                                          scatter_output=False),
                   pipe=distributed_isht(conv, isht, mesh))
        # the gradient mean over the world, in float32 and in bf16
        tr = interpolation_trainer()
        terms = reduce_inputs(world)[rank]
        res["mean"] = {str(dt): tr._mean_over_data([terms], dt)[0]
                       for dt in (None, "bfloat16")}
        # data-parallel training over the world (batch 4 splits over 2 or 4)
        res["dp"] = train(interpolation_trainer(), os.path.join(out, "dp.ckpt"))
        res["bf16"] = train(interpolation_trainer(grad_reduce_dtype="bfloat16"))
        res["zero"] = train(interpolation_trainer(zero_shard_opt_state=True),
                            os.path.join(out, "zero.ckpt"))
        # the stepper's rows over the world
        res["window"] = window(window_stepper(make_mesh(data=world)))
        # spatial model parallelism, and on four ranks a training step on a
        # mesh with a model axis (the step replicated over "h")
        res["spatial"] = spatial(world)
        if world == 4:
            res["mp"] = train(interpolation_trainer(make_mesh(data=2, h=2)))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world: int, out: str, worker=None):
    """Start ``worker`` (``_worker``) on ``world`` spawned processes,
    without waiting."""
    os.makedirs(out, exist_ok=True)
    init = "file://" + os.path.join(out, "rendezvous")
    return mp.start_processes(worker or _worker, args=(world, init, out), nprocs=world,
                              join=False, start_method="spawn")


def results(ctx, world: int, out: str, timeout_s: float = 300.0) -> list:
    """Wait for ``start``'s processes (raising where one failed, and
    killing them all after ``timeout_s``); their results by rank."""
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------- the SFNO options on a split grid
# (tests/test_torch_port_spatial_options.py): each option at embed 8 x 2 on
# 16 x 32 (the rank pipelines at 16 x 3: 2R <= 16 and R % 2 == 0 at rank
# 0.25, and only the middle block has one grid; the folded stage on "h" = 3
# at 18 x 32, whose middle rank holds the equator), dropout 0.1 in the MLP,
# the position embedding and DropPath (off in a deterministic forward)
RANK_PIPELINE = dict(embed_dim=16, num_layers=3, rank=0.25)
OPTIONS = {
    "dhconv": {},
    "dhconv bf16 operands": dict(sht_matmul_dtype="bfloat16"),
    "dhconv spectral io": dict(sht_matmul_dtype="bfloat16", spectral_io_dtype="bfloat16"),
    "merged dhconv": dict(merged_dhconv=True),
    "merged dhconv bf16": dict(merged_dhconv=True, sht_matmul_dtype="bfloat16",
                               spectral_io_dtype="bfloat16"),
    "separable": dict(separable=True),
    "diagonal": dict(operator_type="diagonal"),
    "diagonal separable": dict(operator_type="diagonal", separable=True),
    "cp spectral": dict(factorization="cp", rank=0.5, rank_pipeline=False),
    "tucker spectral": dict(factorization="tucker", rank=0.5, rank_pipeline=False),
    "tt": dict(factorization="tt", rank=0.5),
    "cp pipeline": dict(factorization="cp", **RANK_PIPELINE),
    "cp pipeline K4": dict(factorization="cp", fused_rank=True, **RANK_PIPELINE),
    "tucker pipeline": dict(factorization="tucker", **RANK_PIPELINE),
    "cp pipeline K4 bf16": dict(factorization="cp", fused_rank=True, sht_matmul_dtype="bfloat16",
                                spectral_io_dtype="bfloat16", hard_thresholding_fraction=0.8,
                                **RANK_PIPELINE),
    "attention": dict(filter_type="non-linear", spectral_layers=2),
    "attention l-dependant": dict(filter_type="non-linear", operator_type="l-dependant",
                                  complex_activation="complex", spectral_layers=2),
    "scale_factor": dict(scale_factor=2),
    "exact dropout": dict(exact_dropout=True),
    "fold": dict(sht_fold_symmetry=True),
    "fold bf16 operands": dict(sht_fold_symmetry=True, sht_matmul_dtype="bfloat16"),
    "fold lon fft": dict(sht_fold_symmetry=True, lon_method="fft"),
    "fold cp pipeline": dict(sht_fold_symmetry=True, factorization="cp", **RANK_PIPELINE),
    "fft transform": dict(spectral_transform="fft"),
    "fft transform scale_factor": dict(spectral_transform="fft", scale_factor=2),
    "fft attention": dict(spectral_transform="fft", filter_type="non-linear", spectral_layers=2),
    "fold 18 x 32": dict(sht_fold_symmetry=True, img_shape=(18, 32)),
}
BF16_OPTIONS = ("dhconv bf16 operands", "dhconv spectral io", "merged dhconv bf16",
                "cp pipeline K4 bf16", "fold bf16 operands")
PIPELINES = ("cp pipeline", "cp pipeline K4", "tucker pipeline")
# mesh -> the options run on it: h = 2 and w = 2 alone are two meshes of two
# ranks each (ranks 0-1 and 2-3), which run the same work; "h" = 3 runs on
# ranks 0-2 (rank 3 holds no block of it)
OPTION_MESHES = {"h2w2": [n for n in OPTIONS if n != "fold 18 x 32"],
                 "h2": [*PIPELINES, "fold"], "w2": [*PIPELINES, "fold"],
                 "h4": ["fold"], "h3": ["fold 18 x 32"]}


def option_mesh(key: str):
    """The mesh ``key`` of ``OPTION_MESHES`` over the world of four (every
    rank makes every mesh's groups)."""
    if key == "h2w2":
        return make_mesh(data=1, h=2, w=2)
    if key == "h4":
        return make_mesh(data=1, h=4)
    shape = {"h2": (2, 1, 2, 1, 1), "w2": (2, 1, 1, 2, 1), "h3": (1, 1, 3, 1, 1)}[key]
    return mesh_module._build(np.arange(int(np.prod(shape))).reshape(shape))


def option_config(name: str) -> SFNOConfig:
    kw = dict(img_shape=GRID, in_chans=IN, out_chans=OUT, embed_dim=8, num_layers=2,
              with_time_emb=True, dropout_mlp=0.1, drop_path_rate=0.1, pos_emb_dropout=0.1)
    kw.update({k: v for k, v in OPTIONS[name].items() if k != "fused_rank"})
    return SFNOConfig(**kw)


def option_sfno(name: str) -> SFNO:
    """The SFNO of option ``name``, weights from seed 0 with the spectral
    weights and factors scaled up so that the filter shows."""
    model = SFNO(option_config(name), fused_rank=OPTIONS[name].get("fused_rank", False))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name_, p in model.named_parameters():
            leaf = name_.rsplit(".", 1)[-1]
            if name_.endswith("filter.weight"):
                p.mul_(64.0)
            elif leaf.split("_", 1)[0] in ("cp", "tucker", "tt"):
                p.mul_(4.0)
    return model


def option_forward(model: SFNO, dropout: bool, mesh=None) -> torch.Tensor:
    """``sfno_forward`` on ``sfno_inputs`` of the model's grid, dropout live
    or off."""
    return sfno_forward(model, *sfno_inputs(model.cfg.img_shape), mesh, dropout=dropout)


def noised_window_stepper(mesh=None) -> DYffusionStepper:
    """The main path's window at embed 8 x 2 on 16 x 32 (K1, the fused
    tail, the peeled sampler) with the ``data+noise-v1`` forecaster
    conditioning: the forecaster takes the noised condition's channels."""
    icfg, fcfg = main_path.sfno_configs(8, 2, "float32", GRID, 3, STATE, use_pallas=True,
                                        fused_mlp=False, fused_tail=True)
    fcfg = dataclasses.replace(fcfg, in_chans=fcfg.in_chans + STATE)
    imodel, fmodel = SFNO(icfg), SFNO(fcfg)
    gen = torch.Generator().manual_seed(0)
    for net in (imodel, fmodel):
        net.init_weights(gen)
        boost_filters(net)
    st = main_path._window_stepper(imodel, fmodel, 3, STATE, peel=True, mesh=mesh)
    st.exp.diffusion_cfg = dataclasses.replace(st.exp.diffusion_cfg,
                                               forward_conditioning="data+noise-v1")
    return st


def fold_window_stepper(mesh=None) -> DYffusionStepper:
    """The fused-tail window of ``spatial_window_stepper`` with the folded
    Legendre stage, the interpolator's dropout live."""
    return spatial_window_stepper("k3", True, mesh, sht_fold_symmetry=True)


def _options_worker(rank: int, world: int, init: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        res = {}
        for key, names in OPTION_MESHES.items():
            mesh = option_mesh(key)
            if rank not in mesh.ranks:
                continue
            res[key] = {}
            for name in names:
                model = option_sfno(name)
                res[key][name] = dict(det=option_forward(model, False, mesh),
                                      drop=option_forward(model, True, mesh))
        h2 = option_mesh("h2")
        res["noised"] = spatial_window(noised_window_stepper(h2))
        res["fold_window"] = spatial_window(fold_window_stepper(h2))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_options(out: str):
    """Start the four ranks of the options' runs, without waiting."""
    return start(4, out, _options_worker)


# ------------------------------------------------ the UNet on a split grid
# (tests/test_torch_port_spatial_unet.py): each config at dim 8, dropout 0.1
# in its blocks and attentions (off in a deterministic forward), on the
# meshes of UNET_MESHES; the main path's UNet window on "h" = 2
UNETS = {
    "bilinear": dict(img_shape=(20, 40), in_chans=5, out_chans=3, dim=8, dim_mults=(1, 2, 4, 8),
                     with_time_emb=True, outer_sample_mode="bilinear", upsample_dims=(24, 48)),
    "nearest": dict(img_shape=(45, 90), in_chans=2, out_chans=2, dim=8, dim_mults=(1, 2),
                    outer_sample_mode="nearest", upsample_dims=(48, 96)),
    "keep": dict(img_shape=(16, 32), in_chans=2, out_chans=2, dim=8, dim_mults=(1, 2, 4),
                 keep_spatial_dims=True, with_time_emb=True),
}
UNET_MESHES = {"h2w2": ["bilinear"], "h2": ["bilinear", "keep"], "w2": ["bilinear"],
               "h4": ["bilinear"], "h3": ["nearest"]}
# the modules whose inputs the h2w2 run records (block or whole grid)
UNET_PROBES = ("down0_block1", "down1_block1", "down2_block1", "down2_downsample", "down3_block1",
               "mid_block1", "up0_upsample", "up1_block1", "up3_block1", "final_res_block")
UNET_WINDOW = dict(img_shape=(20, 40), n_state=3, dim=8, dim_mults=(1, 2, 4),
                   upsample_dims=(24, 48))
UNET_WINDOW_STEPS = 12


def unet_net(name: str) -> UNet:
    """The UNet of config ``name``: weights from seed 0, its biases and norm
    affines moved off their initial values (seed 100)."""
    net = UNet(UNetConfig(**UNETS[name]))
    net.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(100)
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def unet_inputs(name: str):
    """(x, time or None, conditions) from numpy seeds: with 5 input channels,
    3 of state and one each of condition and static condition."""
    kw = UNETS[name]
    rng = np.random.default_rng(11)
    shape = (2,) + tuple(kw["img_shape"])
    x = rng.standard_normal(shape + (3 if kw["in_chans"] == 5 else kw["in_chans"],))
    conds = {}
    if kw["in_chans"] == 5:
        conds = {k: torch.from_numpy(rng.standard_normal(shape + (1,)).astype(np.float32))
                 for k in ("condition", "static_condition")}
    t = torch.tensor([1.0, 2.5]) if kw.get("with_time_emb") else None
    return torch.from_numpy(x.astype(np.float32)), t, conds


def unet_forward(net: UNet, name: str, dropout: bool, mesh=None) -> torch.Tensor:
    """``sfno_forward`` of the UNet ``net`` on ``unet_inputs(name)``."""
    x, t, conds = unet_inputs(name)
    return sfno_forward(net, x, t, mesh, dropout=dropout, **conds)


def unet_window_stepper(mesh=None) -> DYffusionStepper:
    """``main_path.build_unet`` at ``UNET_WINDOW``'s size, the interpolator's
    dropout live, on ``mesh``."""
    return main_path.build_unet(**UNET_WINDOW, device="cpu", mesh=mesh)


def unet_window(stepper: DYffusionStepper):
    inp = main_path.window_inputs(UNET_WINDOW_STEPS, UNET_WINDOW["img_shape"],
                                  UNET_WINDOW["n_state"], seed=3, device="cpu")
    return stepper.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                              torch.Generator().manual_seed(0), UNET_WINDOW_STEPS)


def _unet_worker(rank: int, world: int, init: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        res = {}
        for key, names in UNET_MESHES.items():
            mesh = option_mesh(key)
            if rank not in mesh.ranks:
                continue
            res[key] = {}
            for name in names:
                net = unet_net(name)
                res[key][name] = dict(det=unet_forward(net, name, False, mesh),
                                      drop=unet_forward(net, name, True, mesh))
        net, seen = unet_net("bilinear"), {}
        hooks = [net.get_submodule(n).register_forward_pre_hook(
            lambda mod, args, n=n: seen.__setitem__(n, tuple(args[0].shape)))
            for n in UNET_PROBES]
        unet_forward(net, "bilinear", False, option_mesh("h2w2"))
        for hk in hooks:
            hk.remove()
        res["probes"] = seen
        res["window"] = unet_window(unet_window_stepper(option_mesh("h2")))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_unet(out: str):
    """Start the four ranks of the UNet's runs, without waiting."""
    return start(4, out, _unet_worker)
