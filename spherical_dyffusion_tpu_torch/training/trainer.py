"""The trainer, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/trainer.py`` (``TrainerConfig``,
``Trainer``, ``TrainState``) in its ``fit_mode="fit"`` form: one step per batch
on one device,

* AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and two parameter
  groups: weight decay on the leaves that JAX's ``_wd_mask`` decays, those of
  two or more dimensions in the JAX layout and never ``pos_embed``; under
  ``scan_layers`` JAX stacks the middle blocks with a leading layer axis, so
  their 1-D leaves (biases, norm scales) decay too (``decays``);
* the gradient clipped to ``grad_clip`` by its global norm, then the
  schedule's learning rate for the update about to be applied
  (``training/schedules.py``; step 0 of ``warmup_cosine`` trains at 0);
* ``accumulate_grad_batches`` as ``optax.MultiSteps``: the mean gradient of k
  batches is clipped and applied on every k-th step, and the schedule counts
  applied updates;
* the EMA of the parameters (``training/ema.py``) after every step;
* per-epoch validation on the EMA weights (ensemble RMSE, CRPS and SSR);
* checkpoints holding the JAX entries (``params``, ``ema_params``,
  ``opt_state``, ``step``, ``config_json``) written with ``torch.save``.

The experiment's network arrives with its weights (the port's modules carry
them; ``restore_payload`` or ``utils/convert.py:train_state_payload`` loads
others) and the trainer runs where they lie. Gradients are taken for the
experiment's network only (``torch.autograd.grad``), so a frozen network
inside the loss gets none. A step queues its work and reads nothing back:
losses stay on the device until the epoch ends, as in JAX. Randomness
(diffusion timesteps, dropout, shuffles, validation members) comes from
host ``torch.Generator``s seeded from ``cfg.seed``; the validation inputs
noise from a generator on the device, so that nothing of a batch's size is
drawn on the host.

Deliberate departure: JAX's ``fit`` restarts its epoch count and its key
when it resumes; here a checkpoint also holds the epochs done and the
training generator's state, and ``fit`` continues from them, so a resumed
run is the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..evaluation import metrics as M
from ..utils.device import to_device
from .ema import EMA
from .experiments import stack_window
from .schedules import get_scheduler

__all__ = ["TrainerConfig", "TrainState", "Trainer", "decays"]

# field -> the value the port implements (the JAX package's default)
_UNPORTED = {
    "fit_mode": "fit",
    "grad_reduce_dtype": None,
    "zero_shard_opt_state": False,
    "adam_mu_dtype": None,
    "watch_histograms": False,
    "ckpt_mirror": None,
    "save_to_wandb": False,
    "rollout_val_every": None,
}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX package's trainer settings, same names and defaults.

    A field whose other values the port does not implement raises in
    ``__post_init__`` (``_UNPORTED``: the fused and streaming fit modes, the
    sharded and compressed gradient paths, bf16 Adam moments, gradient
    histograms, the checkpoint mirror and wandb upload, rollout validation);
    so does ``code_snapshot`` where a checkpoint directory is set (the code
    tarball is not ported). Accepted and without effect here: ``rng_impl``
    (the port draws from ``torch.Generator``s), ``donate_state`` (parameters
    are updated in place), ``segment_samples`` and ``rollout_val_steps``
    (read only by the modes above)."""

    lr: float = 4e-4
    weight_decay: float = 5e-3
    epochs: int = 3
    grad_clip: float = 0.5
    scheduler: str = "warmup_cosine"
    warmup_steps: int = 100
    use_ema: bool = True
    ema_decay: float = 0.9999
    seed: int = 0
    steps_per_epoch: Optional[int] = None
    log_every: int = 50
    ckpt_dir: Optional[str] = None
    donate_state: bool = False
    accumulate_grad_batches: int = 1
    num_predictions: Optional[int] = None
    rollout_val_every: Optional[int] = None
    rollout_val_steps: Optional[int] = None
    val_ensemble_chunk: Optional[int] = None
    grad_reduce_dtype: Optional[str] = None
    zero_shard_opt_state: bool = False
    reset_optimizer: bool = False
    adam_mu_dtype: Optional[str] = None
    fit_mode: str = "fit"
    segment_samples: Optional[int] = None
    rng_impl: str = "rbg"
    ckpt_mirror: Optional[str] = None
    ckpt_monitor: Optional[str] = None
    watch_model: bool = False
    watch_histograms: bool = False
    save_to_wandb: bool = False
    code_snapshot: bool = True

    def __post_init__(self):
        for name, value in _UNPORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"TrainerConfig.{name}={getattr(self, name)!r}: the "
                                          f"port implements only {value!r}")
        if self.ckpt_dir and self.code_snapshot:
            raise NotImplementedError("TrainerConfig.code_snapshot: the code tarball beside "
                                      "the checkpoints is not ported; set it False")
        if self.accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")


@dataclasses.dataclass
class TrainState:
    """What a step updates: the network (its parameters), the optimizer, the
    EMA, the step count, the optimizer updates applied (the schedule's
    count) and the batches accumulated toward the next update."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    ema: Optional[EMA]
    step: int = 0
    updates: int = 0
    mini_step: int = 0


def _named_trainable(model: nn.Module):
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def decays(model: nn.Module, name: str, p: torch.Tensor) -> bool:
    """Whether JAX's ``_wd_mask`` decays parameter ``name``: a leaf of two
    or more dimensions other than ``pos_embed``. With ``scan_layers`` (and
    three or more layers) the JAX network holds blocks ``1 .. L-2`` stacked
    with a leading layer axis, so every leaf of those blocks has two or more
    dimensions there."""
    if "pos_embed" in name:
        return False
    if p.dim() >= 2:
        return True
    cfg = getattr(model, "cfg", None)
    if not (getattr(cfg, "scan_layers", False) and cfg.num_layers >= 3):
        return False
    head = name.split(".", 1)[0]
    return head.startswith("block_") and 1 <= int(head[len("block_"):]) <= cfg.num_layers - 2


@contextlib.contextmanager
def _weights(model: nn.Module, params: Optional[Dict[str, torch.Tensor]]):
    """Run with ``params`` loaded into ``model``, then put its own back."""
    if params is None:
        yield
        return
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.load_state_dict(params)
    try:
        yield
    finally:
        model.load_state_dict(own)


class Trainer:
    def __init__(self, experiment, datamodule, cfg: TrainerConfig,
                 run_config: Optional[Dict[str, Any]] = None):
        self.exp = experiment
        self.dm = datamodule
        self.cfg = cfg
        self.run_config = run_config
        self.device = next(experiment.model.parameters()).device
        # the statistics on the device once: normalize then copies nothing
        self.normalizer = experiment.normalizer.to(self.device)
        self.restore_payload: Optional[dict] = None
        self.generator = torch.Generator().manual_seed(cfg.seed + 1)
        self.state: Optional[TrainState] = None
        self.epochs_done = 0
        self._area_weights = None
        self._best_monitor = None

    # ------------------------------------------------------------------ setup
    def init_state(self) -> TrainState:
        """AdamW over the network's parameters in two groups, the schedule,
        the EMA; from ``restore_payload`` (a checkpoint) when set: weights,
        EMA (its count = the step), optimizer moments and counts (unless
        ``reset_optimizer``)."""
        cfg = self.cfg
        model = self.exp.model
        restore = self.restore_payload
        if restore is not None:
            model.load_state_dict(restore["params"])
        named = _named_trainable(model)
        decay = [p for n, p in named if decays(model, n, p)]
        no_decay = [p for n, p in named if not decays(model, n, p)]
        spe = cfg.steps_per_epoch
        if spe is None:
            spe = max(1, len(self.dm.dataset("train")) // self.dm.cfg.batch_size)
        self.schedule = get_scheduler(cfg.scheduler, cfg.lr, cfg.epochs * spe, cfg.warmup_steps)
        opt = torch.optim.AdamW([{"params": decay, "weight_decay": cfg.weight_decay},
                                 {"params": no_decay, "weight_decay": 0.0}],
                                lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        state = TrainState(model=model, optimizer=opt, ema=None)
        if cfg.use_ema:
            ema_params = restore.get("ema_params") if restore is not None else None
            state.ema = EMA(model, cfg.ema_decay, params=ema_params,
                            count=restore.get("step", 0) if ema_params is not None else 0)
        if restore is not None:
            state.step = int(restore.get("step", 0))
            if restore.get("opt_state") is not None and not cfg.reset_optimizer:
                self._load_opt_state(state, restore["opt_state"])
        self._params = [p for _, p in named]
        self._groups = None
        if cfg.watch_model:  # top-level submodule -> its parameters' positions
            self._groups = {}
            for i, (n, _) in enumerate(named):
                self._groups.setdefault(n.split(".")[0], []).append(i)
        return state

    def _load_opt_state(self, state: TrainState, opt_state: dict) -> None:
        named = dict(_named_trainable(state.model))
        updates = int(opt_state["updates"])
        for n, p in named.items():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(updates)),
                "exp_avg": opt_state["exp_avg"][n].to(p.device, torch.float32).clone(),
                "exp_avg_sq": opt_state["exp_avg_sq"][n].to(p.device, torch.float32).clone()}
        state.updates = updates
        state.mini_step = int(opt_state.get("mini_step", 0))
        acc = opt_state.get("acc_grads")
        if state.mini_step and acc is not None:
            for n, p in named.items():
                p.grad = acc[n].to(p.device, torch.float32).clone()

    def _opt_state(self, state: TrainState) -> dict:
        named = _named_trainable(state.model)
        moments = {k: {n: state.optimizer.state[p][k].detach().cpu() for n, p in named}
                   for k in ("exp_avg", "exp_avg_sq")} if state.updates else \
            {k: {n: torch.zeros_like(p, device="cpu") for n, p in named}
             for k in ("exp_avg", "exp_avg_sq")}
        acc = ({n: p.grad.detach().cpu() for n, p in named} if state.mini_step else None)
        return dict(moments, updates=state.updates, mini_step=state.mini_step, acc_grads=acc)

    # ------------------------------------------------------------- train step
    def train_step(self, state: TrainState, dynamics: torch.Tensor,
                   dynamical_condition: Optional[torch.Tensor], generator: torch.Generator,
                   random_timestep: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the device: normalize, loss,
        gradients of the network's parameters, and on every
        ``accumulate_grad_batches``-th step clip, update; then the EMA.
        Returns the experiment's metrics and ``grad_norm`` (the batch's
        gradient norm before clipping) as device tensors. ``mark``, if
        given, is called with "forward", "backward" and "optimizer" as each
        part has been queued (``main_path.train_steps`` records CUDA events
        there)."""
        cfg = self.cfg
        dyn = self.normalizer.normalize(dynamics)
        extra = {} if random_timestep is None else {"random_timestep": random_timestep}
        loss, metrics = self.exp.train_loss(dyn, generator,
                                            dynamical_condition=dynamical_condition, **extra)
        if mark is not None:
            mark("forward")
        grads = torch.autograd.grad(loss, self._params, materialize_grads=True)
        if mark is not None:
            mark("backward")
        norms = torch._foreach_norm(grads)
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = torch.linalg.vector_norm(torch.stack(norms))
        if self._groups is not None:
            for k, idx in self._groups.items():
                out[f"grad_norm/{k}"] = torch.linalg.vector_norm(torch.stack([norms[i]
                                                                             for i in idx]))
        if state.mini_step == 0:
            for p, g in zip(self._params, grads):
                p.grad = g
        else:
            torch._foreach_add_([p.grad for p in self._params], grads)
        del grads
        state.mini_step += 1
        k = cfg.accumulate_grad_batches
        if state.mini_step == k:
            if k > 1:
                torch._foreach_div_([p.grad for p in self._params], float(k))
            torch.nn.utils.clip_grad_norm_(self._params, cfg.grad_clip)
            lr = self.schedule(state.updates)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.updates += 1
            state.mini_step = 0
        if state.ema is not None:
            state.ema.update(state.model)
        state.step += 1
        if mark is not None:
            mark("optimizer")
        return out

    def upload(self, batch: Dict[str, torch.Tensor]):
        """A host batch's tensors on the trainer's device (pinned, without waiting)."""
        cond = batch.get("dynamical_condition")
        rt = batch.get("random_timestep")
        return (to_device(batch["dynamics"], self.device),
                to_device(cond, self.device) if cond is not None else None,
                to_device(rt, self.device) if rt is not None else None)

    # -------------------------------------------------------------------- fit
    def fit(self, epochs: Optional[int] = None, val_every: int = 1, verbose: bool = True,
            logger=None) -> Dict[str, Any]:
        """Train for ``epochs`` (``cfg.epochs``) epochs over the shuffled
        training batches (epoch e shuffled with seed ``cfg.seed + e``),
        validating every ``val_every`` epochs and checkpointing each epoch
        when ``cfg.ckpt_dir`` is set. Returns ``{"train_loss": [per-epoch
        means], "step_losses": [per step], "val": [tables]}``. ``self.state``
        is the live state from the start, so that a checkpoint can be taken
        while it runs (the command line's "melk" handler)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        state = self.state = self.init_state()
        first_epoch = 0
        if self.restore_payload is not None:
            first_epoch = self.epochs_done = int(self.restore_payload.get("epoch", 0))
            if self.restore_payload.get("generator") is not None:
                self.generator.set_state(self.restore_payload["generator"])
        history: Dict[str, List] = {"train_loss": [], "step_losses": [], "val": []}
        for epoch in range(first_epoch, epochs):
            t0 = time.time()
            losses, pending = [], []
            for batch in self.dm.train_batches(seed=cfg.seed + epoch):
                dyn, cond, rt = self.upload(batch)
                metrics = self.train_step(state, dyn, cond, self.generator, rt)
                losses.append(metrics["loss"])
                if logger is not None and (state.step - 1) % cfg.log_every == 0:
                    pending.append((state.step - 1, metrics))
            # the one read of the epoch: waiting for the device is training time
            step_losses = torch.stack(losses).tolist() if losses else []
            epoch_s = time.time() - t0
            if logger is not None:
                for s, m in pending:
                    logger.log({f"train/{k}": float(v) for k, v in m.items()
                                if k == "loss" or k.startswith("grad_norm")}, step=s)
            mean_loss = float(np.mean(step_losses)) if step_losses else float("nan")
            history["train_loss"].append(mean_loss)
            history["step_losses"].extend(step_losses)
            if logger is not None:
                logger.log({"train/epoch_loss": mean_loss, "train/epoch_time_s": epoch_s,
                            "train/steps_per_sec": len(step_losses) / epoch_s if epoch_s else 0.0,
                            "epoch": epoch}, step=state.step)
            if verbose:
                print(f"epoch {epoch}: train/loss={mean_loss:.5f} ({epoch_s:.1f}s, "
                      f"{state.step} steps)")
            val = None
            if (epoch + 1) % val_every == 0:
                val = self.validate(state)
                history["val"].append(val)
                if logger is not None and val:
                    logger.log(val, step=state.step)
            self.epochs_done = epoch + 1
            self._save_epoch(state, val)
        return history

    # ------------------------------------------------------------ validation
    @property
    def _val_ensemble(self) -> int:
        if self.cfg.num_predictions is not None:
            return self.cfg.num_predictions
        return getattr(self.exp.cfg, "num_predictions", 1) or 1

    @staticmethod
    def _ens_metrics(preds_e, target, w) -> Dict[str, torch.Tensor]:
        """preds_e (E, B, H, W, C) and target (B, H, W, C), denormalized."""
        wc = w[..., None]
        out = {"rmse": torch.mean(M.root_mean_squared_error(
            target, torch.mean(preds_e, 0), wc, dim=(-3, -2, -1)))}
        if preds_e.shape[0] > 1:
            out["crps"] = torch.mean(M.crps_ensemble(target, preds_e, wc, dim=(-3, -2, -1)))
            out["ssr"] = torch.mean(M.spread_skill_ratio(target, preds_e, wc, dim=(-3, -2, -1)))
        return out

    def _members(self, fn, E: int, B: int):
        """E ensemble members of ``fn(n)`` (n members tiled along the batch
        axis, each with its own dropout draws), in chunks of
        ``val_ensemble_chunk``; returns (E, B, ...) or a dict of them."""
        chunk = self.cfg.val_ensemble_chunk or E
        parts = []
        for start in range(0, E, chunk):
            parts.append(fn(min(chunk, E - start)))

        def split(xs):
            return torch.cat([x.reshape((-1, B) + x.shape[1:]) for x in xs])

        if isinstance(parts[0], dict):
            return {k: split([p[k] for p in parts]) for k in parts[0]}
        return split(parts)

    @torch.no_grad()
    def validate(self, state: TrainState, max_batches: int = 4) -> Dict[str, float]:
        """Ensemble RMSE (+ CRPS and SSR when stochastic) per horizon step,
        averaged, on the EMA weights, over up to ``max_batches`` validation
        batches; member and dropout draws from a host generator seeded
        ``cfg.seed + 7``, the inputs noise from a generator on the device
        seeded alike."""
        exp = self.exp
        if self._area_weights is None:
            self._area_weights = to_device(self.dm.grid.horizontal.area_weights(), self.device)
        w = self._area_weights
        out_norm = exp.normalizer.subset(list(exp.out_packer.names)).to(self.device)
        out_idx = exp._out_idx
        gen = torch.Generator().manual_seed(self.cfg.seed + 7)
        noise_gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 7)
        in_noise = float(getattr(exp.cfg, "prediction_inputs_noise", 0.0) or 0.0)

        def perturb(x):
            if in_noise <= 0.0:
                return x
            noise = torch.randn(x.shape, generator=noise_gen, device=x.device)
            return x + in_noise * noise.to(x.dtype)

        tables = []
        ema = state.ema.state_dict() if state.ema is not None else None
        with _weights(exp.model, ema):
            for n, batch in enumerate(self.dm.val_batches(horizon=exp.cfg.horizon)):
                if n >= max_batches:
                    break
                dyn, cond, _ = self.upload(batch)
                dyn_n = self.normalizer.normalize(dyn)
                tables.append(self._eval_batch(dyn, dyn_n, cond, gen, perturb, w, out_norm,
                                               out_idx))
        if not tables:
            return {}
        return {f"val/avg/{k}": float(np.mean([t[k] for t in tables])) for k in tables[0]}

    def _eval_batch(self, dyn, dyn_n, cond, gen, perturb, w, out_norm, out_idx):
        exp = self.exp
        B = dyn.shape[0]

        def tile(x, n):
            return None if x is None else x.repeat((n,) + (1,) * (x.dim() - 1))

        per_h = []
        if hasattr(exp, "get_inputs_from_dynamics"):  # interpolation
            use_do = exp.cfg.enable_inference_dropout
            E = self._val_ensemble if (use_do or exp.cfg.prediction_inputs_noise > 0) else 1
            inputs = exp.get_inputs_from_dynamics(dyn_n)
            for t_step in exp.horizon_range:
                target_time = exp.cfg.window + t_step - 1
                c = exp.slice_condition(cond, target_time) if cond is not None else None

                def member(n):
                    t = torch.full((n * B,), float(t_step), device=dyn.device)
                    return exp.predict(perturb(tile(inputs, n)), time=t, condition=tile(c, n),
                                       generator=gen, use_inference_dropout=use_do)

                preds_e = out_norm.denormalize(self._members(member, E, B))
                per_h.append(self._ens_metrics(preds_e, dyn[:, target_time][..., out_idx], w))
        else:  # forecasting: the full sampling loop per member
            E = self._val_ensemble
            init = stack_window(dyn_n[:, :exp.cfg.window])
            T = dyn.shape[1]
            valid = [h for h in range(1, exp.cfg.horizon + 1) if exp.cfg.window + h - 1 < T]

            def member(n):
                out = exp.predict(perturb(tile(init, n)), gen,
                                  dynamical_condition=tile(cond, n))
                return {h: out.preds[h] for h in valid if h in out.preds}

            preds = self._members(member, E, B)
            for h, p in preds.items():
                target = dyn[:, exp.cfg.window + h - 1][..., out_idx]
                per_h.append(self._ens_metrics(out_norm.denormalize(p), target, w))
        return {k: float(torch.mean(torch.stack([t[k] for t in per_h]))) for k in per_h[0]}

    # ------------------------------------------------------------ checkpoint
    def _save_epoch(self, state: TrainState, val: Optional[dict]) -> None:
        """last.ckpt every epoch; best.ckpt when ``ckpt_monitor`` improves
        (lower is better)."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return
        self.save_checkpoint(state, os.path.join(cfg.ckpt_dir, "last.ckpt"))
        if cfg.ckpt_monitor and val and cfg.ckpt_monitor in val:
            v = float(val[cfg.ckpt_monitor])
            if self._best_monitor is None or v < self._best_monitor:
                self._best_monitor = v
                self.save_checkpoint(state, os.path.join(cfg.ckpt_dir, "best.ckpt"))

    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """The JAX checkpoint's entries (``params``, ``ema_params``,
        ``opt_state``, ``step``, ``config_json``) as CPU tensors through
        ``torch.save``, plus ``epoch`` (the epochs done) and ``generator``
        for an exact resume; the one writer of the port's checkpoints
        (``interface.save_experiment_checkpoint`` calls it).
        ``opt_state`` holds AdamW's moments by parameter name, the updates
        applied, and the batches accumulated toward the next."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "ema_params": ({k: v.cpu() for k, v in state.ema.state_dict().items()}
                           if state.ema is not None else None),
            "opt_state": self._opt_state(state),
            "step": int(state.step),
            "epoch": int(self.epochs_done),
            "generator": self.generator.get_state(),
            "config_json": json.dumps(self.run_config or {}),
        }
        torch.save(payload, path)

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=True)
