"""The trainer, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/training/trainer.py`` (``TrainerConfig``,
``Trainer``, ``TrainState``) on one device:

* AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and two parameter
  groups: weight decay on the leaves that JAX's ``_wd_mask`` decays, those of
  two or more dimensions in the JAX layout and never ``pos_embed``; under
  ``scan_layers`` JAX stacks the middle blocks with a leading layer axis, so
  their 1-D leaves (biases, norm scales) decay too (``decays``); with
  ``adam_mu_dtype="bfloat16"`` the first moment is stored in bf16 with
  optax's rounding points (``training/optim.py``);
* the gradient clipped to ``grad_clip`` by its global norm, then the
  schedule's learning rate for the update about to be applied
  (``training/schedules.py``; step 0 of ``warmup_cosine`` trains at 0);
* ``accumulate_grad_batches`` as ``optax.MultiSteps``: the mean gradient of k
  batches is clipped and applied on every k-th step, and the schedule counts
  applied updates;
* the EMA of the parameters (``training/ema.py``) after every step;
* per-subtree gradient norms (``watch_model``) and gradient-value
  histograms (``watch_histograms``, ``grad_histogram``) at log points;
* three fit loops, as ``fit_mode`` picks them: ``fit`` (a host batch
  uploaded per step), ``fit_in_memory`` (the dataset uploaded once, each
  step's batch gathered on the card) and ``streaming`` (``fit_in_memory``
  over segments of ``segment_samples`` samples, the next one read and
  pinned on a producer thread while the current one trains);
* per-epoch validation on the EMA weights (ensemble RMSE, CRPS and SSR),
  and in ``fit`` a rollout validation every ``rollout_val_every`` epochs
  (``rollout_validate``: ``run_inference`` over the validation source);
* checkpoints holding the JAX entries (``params``, ``ema_params``,
  ``opt_state``, ``step``, ``config_json``) written with ``torch.save``,
  and once per trainer a byte-stable ``code.tar.gz`` of the package
  beside them (``code_snapshot``, ``utils/code_snapshot.py``).

The experiment's network arrives with its weights (the port's modules carry
them; ``restore_payload`` or ``utils/convert.py:train_state_payload`` loads
others) and the trainer runs where they lie. Gradients are taken for the
experiment's network only (``torch.autograd.grad``), so a frozen network
inside the loss gets none. A step queues its work and reads nothing back:
losses and logged metrics stay on the device until the epoch ends, and are
then read at once (``utils/device.py:read_back``), as in JAX. Randomness
(diffusion timesteps, dropout, shuffles, validation members) comes from
host ``torch.Generator``s seeded from ``cfg.seed``, which seed the draws
made on the device; the validation inputs noise comes from a generator on
the device.

Deliberate departure: JAX's ``fit`` restarts its epoch count and its key
when it resumes; here a checkpoint also holds the epochs done and the
training generator's state, and ``fit`` and ``fit_in_memory`` continue from
them, so a resumed run is the uninterrupted one.
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

from ..data.datamodule import prefetched
from ..evaluation import metrics as M
from ..evaluation.aggregators import InferenceAggregator
from ..inference.loop import InferenceConfig, run_inference
from ..inference.stepper import DYffusionStepper
from ..utils import flax_msgpack
from ..utils.code_snapshot import snapshot_code
from ..utils.convert import train_state_payload
from ..utils.device import read_back, to_device
from .ema import EMA
from .experiments import stack_window
from .optim import AdamWLowMu
from .schedules import get_scheduler

__all__ = ["TrainerConfig", "TrainState", "Trainer", "decays", "grad_histogram",
           "histogram_wire"]

# field -> (the value the port implements, the JAX package's default; the
# ROADMAP Queue 1 item that ports the others)
_UNPORTED = {
    "grad_reduce_dtype": (None, 7),
    "zero_shard_opt_state": (False, 7),
    "ckpt_mirror": (None, 8),
    "save_to_wandb": (False, 8),
}
MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HIST_BINS = 64


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX package's trainer settings, same names and defaults.

    A field whose other values the port does not implement raises in
    ``__post_init__`` (``_UNPORTED``), naming the ROADMAP Queue 1 item that
    ports it: the compressed gradient reduction (``grad_reduce_dtype``) and
    the sharded optimizer state (``zero_shard_opt_state``) wait for
    multi-GPU (item 7); the checkpoint mirror (``ckpt_mirror``) and the
    wandb upload (``save_to_wandb``) wait for the network clients (item 8).
    ``adam_mu_dtype`` takes "float32" (``torch.optim.AdamW``, as None) and
    "bfloat16" (``training/optim.py:AdamWLowMu``); ``fit_mode`` is
    checked by ``fit``, with JAX's errors. Accepted and without effect here:
    ``rng_impl`` (the port draws from ``torch.Generator``s) and
    ``donate_state`` (parameters are updated in place)."""

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
        for name, (value, item) in _UNPORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"TrainerConfig.{name}={getattr(self, name)!r}: the "
                                          f"port implements only {value!r} (ROADMAP Queue 1 "
                                          f"item {item})")
        if self.adam_mu_dtype is not None and self.adam_mu_dtype not in MU_DTYPES:
            raise NotImplementedError(f"TrainerConfig.adam_mu_dtype={self.adam_mu_dtype!r}: "
                                      f"the port stores Adam's first moment in "
                                      f"{sorted(MU_DTYPES)}")
        if self.accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")


@dataclasses.dataclass
class TrainState:
    """What a step updates: the network (its parameters), the optimizer, the
    EMA, the step count, the optimizer updates applied (the schedule's
    count) and the batches accumulated toward the next update."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
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


def subtree(model: nn.Module, name: str) -> str:
    """The top-level subtree of JAX's parameter tree that holds parameter
    ``name``: its first component, except that with ``scan_layers`` (and
    three or more layers) blocks ``1 .. L-2`` are stacked under
    ``blocks_mid``."""
    head = name.split(".", 1)[0]
    cfg = getattr(model, "cfg", None)
    if (getattr(cfg, "scan_layers", False) and cfg.num_layers >= 3 and head.startswith("block_")
            and 1 <= int(head[len("block_"):]) <= cfg.num_layers - 2):
        return "blocks_mid"
    return head


_HIST_ROWS = 1024  # rows of partial counts: spreads the atomic adds of a large tensor


def grad_histogram(grads, bins: int = HIST_BINS):
    """``jnp.histogram`` of all values of ``grads`` (a list of tensors) with
    ``bins`` bins, on their device, with no read to the host: ``(counts,
    edges)``, counts float64 (exact; JAX's are float32, which stop counting
    one by one past 2^24 in a bin), edges in the gradients' dtype.

    As JAX: the range is (min, max), or (v - 0.5, v + 0.5) where all values
    are v; the edges are ``lo * (1 - i / bins) + hi * (i / bins)`` for
    ``i < bins`` and then ``hi``, as ``jnp.linspace`` computes them; a value
    falls in bin k where ``edges[k] <= x < edges[k + 1]``, the last bin
    holding its right edge (``searchsorted``). The counts are
    ``scatter_add_``ed into ``_HIST_ROWS`` rows of partial counts, then
    summed. ``torch.histc`` (a range given as host floats) and
    ``torch.bincount`` (an output sized from the data) would each read the
    card from the host."""
    lo = torch.stack([g.min() for g in grads]).min()
    hi = torch.stack([g.max() for g in grads]).max()
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    dev = lo.device
    frac = torch.arange(bins, dtype=lo.dtype, device=dev) / bins
    edges = torch.cat([lo * (1 - frac) + hi * frac, hi[None]])
    counts = torch.zeros((_HIST_ROWS, bins + 2), dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    for g in grads:
        flat = g.detach().reshape(-1)
        idx = torch.searchsorted(edges, flat, right=True)
        idx = torch.where(flat == edges[-1], bins, idx)
        cut = flat.numel() - flat.numel() % _HIST_ROWS
        if cut:
            rows = idx[:cut].view(_HIST_ROWS, -1)
            counts.scatter_add_(1, rows, one.expand(rows.shape))
        if cut < flat.numel():
            rest = idx[cut:]
            counts[0].scatter_add_(0, rest, one.expand(rest.shape))
    return counts.sum(0)[1:bins + 1], edges


def histogram_wire(counts, edges) -> dict:
    """The wandb histogram payload of JAX's ``_histogram_wire`` for host
    ``(counts, edges)``: ``{"_type": "histogram", "values": int counts,
    "bins": float edges}``."""
    return {"_type": "histogram", "values": [int(c) for c in np.asarray(counts)],
            "bins": [float(b) for b in np.asarray(edges)]}


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
        self._code_snapshotted = False

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
        groups = [{"params": decay, "weight_decay": cfg.weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        adam = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        if self.mu_dtype != torch.float32:  # optax's float32 mu is AdamW's own state
            opt = AdamWLowMu(groups, mu_dtype=self.mu_dtype, **adam)
        else:
            opt = torch.optim.AdamW(groups, **adam)
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
        if cfg.watch_model or cfg.watch_histograms:  # JAX's top-level subtree -> positions
            self._groups = {}
            for i, (n, _) in enumerate(named):
                self._groups.setdefault(subtree(model, n), []).append(i)
        return state

    @property
    def mu_dtype(self) -> torch.dtype:
        """The dtype of Adam's stored first moment."""
        return MU_DTYPES[self.cfg.adam_mu_dtype or "float32"]

    def _load_opt_state(self, state: TrainState, opt_state: dict) -> None:
        named = dict(_named_trainable(state.model))
        updates = int(opt_state["updates"])
        for n, p in named.items():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(updates)),
                "exp_avg": opt_state["exp_avg"][n].to(p.device, self.mu_dtype).clone(),
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
            {k: {n: torch.zeros_like(p, device="cpu", dtype=dt) for n, p in named}
             for k, dt in (("exp_avg", self.mu_dtype), ("exp_avg_sq", torch.float32))}
        acc = ({n: p.grad.detach().cpu() for n, p in named} if state.mini_step else None)
        return dict(moments, updates=state.updates, mini_step=state.mini_step, acc_grads=acc)

    # ------------------------------------------------------------- train step
    def train_step(self, state: TrainState, dynamics: torch.Tensor,
                   dynamical_condition: Optional[torch.Tensor], generator: torch.Generator,
                   random_timestep: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None,
                   histograms: bool = False) -> Dict[str, Any]:
        """One step on a batch already on the device: normalize, loss,
        gradients of the network's parameters, and on every
        ``accumulate_grad_batches``-th step clip, update; then the EMA.
        Returns the experiment's metrics and ``grad_norm`` (the batch's
        gradient norm before clipping) as device tensors, with
        ``grad_norm/<subtree>`` under ``watch_model`` and, where
        ``histograms`` is asked for (``fit`` asks at its log points under
        ``watch_histograms``; JAX computes them every step and reads them at
        log points), ``grad_hist/<subtree>``: ``grad_histogram`` of the
        batch's gradient before clipping. ``mark``, if given, is called with
        "forward", "backward" and "optimizer" as each part has been queued
        (``main_path.train_steps`` records CUDA events there)."""
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
        if self._groups is not None and cfg.watch_model:
            for k, idx in self._groups.items():
                out[f"grad_norm/{k}"] = torch.linalg.vector_norm(torch.stack([norms[i]
                                                                             for i in idx]))
        if histograms:
            if self._groups is None:
                raise ValueError("gradient histograms need TrainerConfig.watch_histograms")
            for k, idx in self._groups.items():
                out[f"grad_hist/{k}"] = grad_histogram([grads[i] for i in idx])
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
    def _start(self) -> int:
        """``self.state`` from ``init_state`` (the live state from the start,
        so that a checkpoint can be taken while a fit runs: the command
        line's "melk" handler); with a checkpoint, the epochs it had done
        (and the training generator where it holds one). Returns the first
        epoch to run."""
        self.state = self.init_state()
        if self.restore_payload is None:
            return 0
        self.epochs_done = int(self.restore_payload.get("epoch", 0))
        if self.restore_payload.get("generator") is not None:
            self.generator.set_state(self.restore_payload["generator"])
        return self.epochs_done

    def fit(self, epochs: Optional[int] = None, val_every: int = 1, verbose: bool = True,
            logger=None) -> Dict[str, Any]:
        """Train for ``epochs`` (``cfg.epochs``) epochs. ``cfg.fit_mode``
        "fit_in_memory" and "streaming" go to ``fit_in_memory`` (streaming
        with ``cfg.segment_samples``, which it needs), as in JAX; "fit" runs
        here, over the shuffled training batches (epoch e shuffled with seed
        ``cfg.seed + e``), one host batch uploaded per step, validating
        every ``val_every`` epochs, rolling out the validation source every
        ``cfg.rollout_val_every`` epochs and checkpointing each epoch when
        ``cfg.ckpt_dir`` is set. Logged steps (every ``log_every``-th) log
        ``train/loss`` and the gradient norms and histograms. Returns
        ``{"train_loss": [per-epoch means], "step_losses": [per step],
        "val": [tables]}``, and ``"rollout_val"`` where one ran."""
        cfg = self.cfg
        if cfg.fit_mode in ("fit_in_memory", "streaming"):
            if cfg.fit_mode == "streaming" and not cfg.segment_samples:
                raise ValueError("trainer.fit_mode='streaming' requires trainer.segment_samples "
                                 "(samples per device segment)")
            return self.fit_in_memory(
                epochs=epochs, val_every=val_every, verbose=verbose, logger=logger,
                segment_samples=cfg.segment_samples if cfg.fit_mode == "streaming" else None)
        if cfg.fit_mode != "fit":
            raise ValueError(f"Unknown fit_mode {cfg.fit_mode!r}")
        epochs = epochs if epochs is not None else cfg.epochs
        first_epoch = self._start()
        state = self.state
        history: Dict[str, List] = {"train_loss": [], "step_losses": [], "val": []}
        for epoch in range(first_epoch, epochs):
            t0 = time.time()
            losses, pending = [], []
            for batch in self.dm.train_batches(seed=cfg.seed + epoch):
                dyn, cond, rt = self.upload(batch)
                logged = logger is not None and state.step % cfg.log_every == 0
                metrics = self.train_step(state, dyn, cond, self.generator, rt,
                                          histograms=logged and cfg.watch_histograms)
                losses.append(metrics["loss"])
                if logged:
                    pending.append((state.step - 1, {
                        k: v for k, v in metrics.items()
                        if k == "loss" or k.startswith(("grad_norm", "grad_hist/"))}))
            # the one read of the epoch: waiting for the device is training time
            step_losses, rows = self._read_epoch(losses, pending)
            epoch_s = time.time() - t0
            for s, row in rows:
                logger.log(row, step=s)
            self._end_epoch(history, step_losses, epoch, epoch_s, logger, verbose, "")
            val = self._validate_epoch(history, epoch, val_every, logger)
            if cfg.rollout_val_every and (epoch + 1) % cfg.rollout_val_every == 0:
                rv = self.rollout_validate(state)
                if rv:
                    history.setdefault("rollout_val", []).append(rv)
                    if logger is not None:
                        logger.log(rv, step=state.step)
                    if verbose:
                        head = {k: round(float(v), 5) for k, v in list(rv.items())[:3]}
                        print(f"epoch {epoch} rollout: {head}")
            self.epochs_done = epoch + 1
            self._save_epoch(state, val)
        return history

    @staticmethod
    def _read_epoch(losses, pending):
        """The epoch's step losses and its logged rows, read from the device
        at once: ``(losses, [(step, {"train/<key>": value})])``, a
        histogram as its wandb payload (``histogram_wire``)."""
        flat = [torch.stack(losses)] if losses else []
        for _, m in pending:
            for v in m.values():
                flat.extend(v if isinstance(v, tuple) else [v])
        got = iter(read_back(flat))
        step_losses = next(got).tolist() if losses else []
        rows = []
        for s, m in pending:
            row = {}
            for k, v in m.items():
                row[f"train/{k}"] = (histogram_wire(next(got), next(got))
                                     if isinstance(v, tuple) else float(next(got)))
            rows.append((s, row))
        return step_losses, rows

    def _end_epoch(self, history, step_losses, epoch, epoch_s, logger, verbose, how) -> None:
        mean_loss = float(np.mean(step_losses)) if step_losses else float("nan")
        history["train_loss"].append(mean_loss)
        history["step_losses"].extend(step_losses)
        if logger is not None:
            logger.log({"train/epoch_loss": mean_loss, "train/epoch_time_s": epoch_s,
                        "train/steps_per_sec": len(step_losses) / epoch_s if epoch_s else 0.0,
                        "epoch": epoch}, step=self.state.step)
        if verbose:
            print(f"epoch {epoch}: train/loss={mean_loss:.5f} ({epoch_s:.1f}s, "
                  f"{len(step_losses) if how else self.state.step} steps{how})")

    def _validate_epoch(self, history, epoch, val_every, logger) -> Optional[dict]:
        if (epoch + 1) % val_every:
            return None
        val = self.validate(self.state)
        history["val"].append(val)
        if logger is not None and val:
            logger.log(val, step=self.state.step)
        return val

    # ------------------------------------------------------- fused device fit
    def epoch_generator(self, epoch: int, segment: Optional[int] = None) -> torch.Generator:
        """The host generator of ``fit_in_memory``'s epoch ``epoch`` (and of
        its streaming ``segment``): seeded from the words ``(cfg.seed + 1,
        epoch[, segment])`` through numpy's ``SeedSequence``, as JAX keys
        them ``fold_in(key(seed + 1), epoch)`` (then ``fold_in(., segment)``),
        so that an epoch's draws do not depend on the epochs before it."""
        words = [self.cfg.seed + 1, epoch] + ([] if segment is None else [segment])
        seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
        return torch.Generator().manual_seed(seed)

    def _read_rows(self, ds, rows, keys) -> Dict[str, torch.Tensor]:
        """Samples ``rows`` of ``ds`` stacked per key into host tensors,
        pinned when the trainer is on the card."""
        rows = [int(i) for i in rows]
        first = ds[rows[0]]
        out = {k: np.empty((len(rows),) + np.shape(first[k]), np.asarray(first[k]).dtype)
               for k in keys}
        for j, i in enumerate(rows):
            s = first if j == 0 else ds[i]
            for k in keys:
                out[k][j] = s[k]
        host = {k: torch.from_numpy(v) for k, v in out.items()}
        if self.device.type == "cuda":
            host = {k: v.pin_memory() for k, v in host.items()}
        return host

    def fit_in_memory(self, epochs: Optional[int] = None, val_every: int = 1,
                      verbose: bool = True, logger=None, steps_per_epoch: Optional[int] = None,
                      segment_samples: Optional[int] = None,
                      mark: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
        """Training with the dataset on the device (JAX's ``fit_in_memory``,
        whose epoch is one ``lax.scan``; here a loop of ``train_step`` calls
        that reads nothing back until the epoch ends).

        ``n = min(len(train set), max_train_samples)`` samples are read once,
        stacked and uploaded once (``utils/device.py:to_device``). Each epoch
        takes ``spe = min(steps_per_epoch or cfg.steps_per_epoch or n // bs,
        n // bs)`` batches of ``bs`` rows of ``np.random.default_rng(cfg.seed
        + epoch).permutation(n)`` (drop-last): the permutation's index is the
        epoch's one upload, and each step gathers its rows on the device
        (``index_select``), so no step copies anything from the host. The
        epoch's draws come from ``epoch_generator(epoch)``.

        ``segment_samples`` streams the epoch instead (datasets larger than
        the card): JAX's rounding, ``min(max(bs, segment_samples // bs *
        bs), spe * bs)`` samples a segment and ``max(1, spe * bs //
        segment_samples)`` segments, the remainder dropped; segment k + 1 is
        read, stacked and pinned on a producer thread (``prefetched``, depth
        1) while segment k trains, its steps going through its rows in order
        with ``epoch_generator(epoch, k)``. The host never waits for the
        card between segments.

        Validation every ``val_every`` epochs, checkpoints as ``fit``; no
        rollout validation and no per-step logs, as JAX's fused loop has
        none. Returns ``fit``'s history, plus ``"upload"`` (the dataset's
        bytes, the host seconds reading, stacking and pinning it, and the
        seconds of its copy to the device, by CUDA events on the card) or
        ``"segment_wait_s"`` (per epoch, the host's wait for each segment).
        ``mark`` goes to every ``train_step`` (``main_path.fused_epoch``
        times the steps with it)."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        ds = self.dm.dataset("train")
        bs = self.dm.cfg.batch_size
        n = len(ds)
        if self.dm.cfg.max_train_samples is not None:
            n = min(n, self.dm.cfg.max_train_samples)
        fields = ("dynamics", "dynamical_condition", "random_timestep")
        keys = [k for k in fields if k in ds[0]]
        spe = min(steps_per_epoch or cfg.steps_per_epoch or max(1, n // bs), n // bs)
        cuda = self.device.type == "cuda"
        history: Dict[str, Any] = {"train_loss": [], "step_losses": [], "val": []}
        data = None
        if segment_samples is None:
            t0 = time.perf_counter()
            host = self._read_rows(ds, range(n), keys)
            t1 = time.perf_counter()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            if cuda:
                marks[0].record()
            data = {k: to_device(v, self.device) for k, v in host.items()}
            if cuda:
                marks[1].record()
            upload = dict(bytes=sum(v.numel() * v.element_size() for v in host.values()),
                          host_s=t1 - t0, copy_s=None if cuda else time.perf_counter() - t1)
            del host
        else:
            segment_samples = min(max(bs, (segment_samples // bs) * bs), spe * bs)
            n_seg = max(1, (spe * bs) // segment_samples)
            history["segment_wait_s"] = []
        first_epoch = self._start()
        state = self.state
        for epoch in range(first_epoch, epochs):
            t0 = time.time()
            perm = np.random.default_rng(cfg.seed + epoch).permutation(n)[: spe * bs]
            losses = []
            if data is not None:
                idx = to_device(torch.from_numpy(perm.reshape(spe, bs)), self.device)
                gen = self.epoch_generator(epoch)
                for s in range(spe):
                    batch = [data[k].index_select(0, idx[s]) if k in data else None
                             for k in fields]
                    losses.append(self.train_step(state, batch[0], batch[1], gen,
                                                  batch[2], mark=mark)["loss"])
            else:
                chunks = [perm[i * segment_samples:(i + 1) * segment_samples]
                          for i in range(n_seg)]
                waits = []
                tw = time.perf_counter()
                for si, seg in enumerate(prefetched(
                        (self._read_rows(ds, ch, keys) for ch in chunks), depth=1)):
                    waits.append(time.perf_counter() - tw)
                    seg = {k: to_device(v, self.device) for k, v in seg.items()}
                    gen = self.epoch_generator(epoch, si)
                    for s in range(segment_samples // bs):
                        batch = [seg[k][s * bs:(s + 1) * bs] if k in seg else None
                                 for k in fields]
                        losses.append(self.train_step(state, batch[0], batch[1], gen,
                                                      batch[2], mark=mark)["loss"])
                    del seg
                    tw = time.perf_counter()
                history["segment_wait_s"].append(waits)
            step_losses, _ = self._read_epoch(losses, [])
            epoch_s = time.time() - t0
            self._end_epoch(history, step_losses, epoch, epoch_s, logger, verbose, " fused")
            val = self._validate_epoch(history, epoch, val_every, logger)
            self.epochs_done = epoch + 1
            self._save_epoch(state, val)
        if data is not None:
            if cuda:  # the epochs' reads have waited for the copy
                upload["copy_s"] = marks[0].elapsed_time(marks[1]) / 1e3
            history["upload"] = upload
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

    def rollout_validate(self, state: TrainState) -> Dict[str, float]:
        """The autoregressive rollout over the validation source (JAX's
        ``rollout_validate``), for a forecasting experiment (``{}`` for any
        other): ``run_inference`` of ``cfg.rollout_val_steps`` steps (else
        ``min(prediction_horizon or 8 * horizon, n_timesteps - 1)``) in
        windows of ``min(steps, 8 * horizon)``, one member, through a
        ``DYffusionStepper`` on the trainer's device with the forecaster's
        EMA weights where there are any, reduced by an
        ``InferenceAggregator`` without zonal-mean images; its keys renamed
        ``val/<rest>``. The forecaster's own weights are put back after it
        (``_weights``); the rollout draws from its own generator, so the
        trainer's generator, the EMA and the modules are left as they
        were."""
        exp = self.exp
        if getattr(exp, "diffusion_cfg", None) is None:
            return {}
        src = self.dm._source("val")
        n_steps = self.cfg.rollout_val_steps or min(
            self.dm.cfg.prediction_horizon or 8 * exp.cfg.horizon, src.n_timesteps - 1)
        icfg = InferenceConfig(n_forward_steps=n_steps,
                               forward_steps_in_memory=min(n_steps, 8 * exp.cfg.horizon),
                               n_ensemble=1)
        agg = InferenceAggregator(list(exp.out_packer.names),
                                  self.dm.grid.horizontal.area_weights(),
                                  log_zonal_mean_images=False)
        ema = state.ema.state_dict() if state.ema is not None else None
        with _weights(exp.model, ema):
            run_inference(DYffusionStepper(exp), src, icfg, aggregator=agg, verbose=False)
        return {f"val/{k.split('/', 1)[1]}": v for k, v in agg.get_logs().items()}

    # ------------------------------------------------------------ checkpoint
    def _save_epoch(self, state: TrainState, val: Optional[dict]) -> None:
        """last.ckpt every epoch; best.ckpt when ``ckpt_monitor`` improves
        (lower is better); with ``code_snapshot``, once per trainer, the
        package's source as ``code.tar.gz`` beside them
        (``utils/code_snapshot.py``)."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return
        self.save_checkpoint(state, os.path.join(cfg.ckpt_dir, "last.ckpt"))
        if cfg.ckpt_monitor and val and cfg.ckpt_monitor in val:
            v = float(val[cfg.ckpt_monitor])
            if self._best_monitor is None or v < self._best_monitor:
                self._best_monitor = v
                self.save_checkpoint(state, os.path.join(cfg.ckpt_dir, "best.ckpt"))
        if cfg.code_snapshot and not self._code_snapshotted:
            snapshot_code(os.path.join(cfg.ckpt_dir, "code.tar.gz"))
            self._code_snapshotted = True

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
        """A checkpoint as a restore payload: the port's own (``torch.save``),
        or the JAX package's msgpack checkpoint (read by
        ``utils/flax_msgpack.py``, its optax state carried across by
        ``utils/convert.py:train_state_payload``)."""
        with open(path, "rb") as f:
            head = f.read(2)
        if head == b"PK" or head[:1] == b"\x80":
            return torch.load(path, map_location="cpu", weights_only=True)
        raw = flax_msgpack.read(path)
        return dict(train_state_payload(raw), config_json=raw.get("config_json", "{}"))
