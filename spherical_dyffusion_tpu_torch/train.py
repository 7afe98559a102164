"""Training command line.

Counterpart of ``spherical_dyffusion_tpu/train.py``: seeds, builds the
datamodule, experiment and trainer from a composed JSON config, fits, and
writes the checkpoint with the config embedded to
``<ckpt_dir>/<name>_last.ckpt``. It resumes from that file unless
``resume=new``, writes a checkpoint on SIGUSR1 or when training raises
("melk"), and ``mode=validate`` (or ``test``) restores the checkpoint and
runs validation only.

    python -m spherical_dyffusion_tpu_torch.train [config.json] experiment=<name> [k=v ...]

``experiment=<name>`` loads ``configs/experiment/<name>.json`` (the port's
JSON copies of the JAX package's configs). ``datamodule.kind: fv3gfs``
trains on netCDF directories (``data/datamodule.py:FV3GFSDataModule``), the
debug datamodule on synthetic fields. It runs on the CUDA card unless
the config says ``platform: cpu``; ``platform=cpu`` on the command line sets
it (the configs carry no such key, which the JAX command line would need as
``++platform=cpu``). ``<group>=<name>`` chooses ``configs/<group>/<name>.json``
for a config group (``model=unet``), as Hydra would. With ``SPHDY_MULTIHOST``
or ``SPHDY_COORDINATOR`` set, each process joins the process group first
(``parallel/multihost.py``) and the trainer averages its gradients over the
ranks; rank 0 writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
from typing import List, Optional

import numpy as np
import torch

__all__ = ["run_model", "main"]


def run_model(config_path: Optional[str], overrides: List[str]) -> dict:
    """Train as the config and the dotlist ``overrides`` say. Returns
    ``{"history", "ckpt_path", "trainer", "config"}``, or with
    ``mode=validate`` ``{"metrics", "config", "trainer"}``."""
    from .interface import get_datamodule, get_experiment, resolve_device, \
        save_experiment_checkpoint
    from .parallel.multihost import maybe_init_multihost
    from .training.trainer import Trainer, TrainerConfig
    from .utils.config import CONFIG_DIR, load_config, with_platform
    from .utils.loggers import make_logger

    exp_override = [o for o in overrides if o.startswith("experiment=")]
    groups = {}
    for o in overrides:  # model=unet: a file of a config group, not a value
        key, _, name = o.partition("=")
        if (key not in ("experiment", "") and "." not in key and not key.startswith("+")
                and os.path.exists(os.path.join(CONFIG_DIR, key, f"{name}.json"))):
            groups[key] = name
    plain_overrides = with_platform([o for o in overrides if not o.startswith("experiment=")
                                     and o.partition("=")[0] not in groups])
    path = config_path or os.path.join(CONFIG_DIR, "main.json")
    if exp_override:
        name = exp_override[-1].split("=", 1)[1]
        cand = os.path.join(CONFIG_DIR, "experiment", f"{name}.json")
        if os.path.exists(cand):
            path = cand
        else:
            plain_overrides.append(exp_override[-1])
    cfg = load_config(path, plain_overrides, groups=groups)
    device = resolve_device(cfg)
    # the process group (opt-in by SPHDY_MULTIHOST / SPHDY_COORDINATOR), before
    # anything is built: NCCL on the card, gloo with platform: cpu
    maybe_init_multihost(backend="gloo" if device.type == "cpu" else "nccl")

    seed = int(cfg.get("seed", 0))
    np.random.seed(seed)
    torch.manual_seed(seed)

    dm = get_datamodule(cfg)
    exp = get_experiment(cfg, dm, device=device, seed=seed)
    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    trainer = Trainer(exp, dm, TrainerConfig(
        **{k: v for k, v in cfg.get("trainer", {}).items() if k in fields}), run_config=cfg)

    ckpt_path = os.path.join(cfg.get("ckpt_dir", "checkpoints"),
                             f"{cfg.get('name', 'run')}_last.ckpt")
    if os.path.exists(ckpt_path) and cfg.get("resume", "resume") != "new":
        trainer.restore_payload = Trainer.load_checkpoint(ckpt_path)
        print(f"[resume] restored params from {ckpt_path}")

    def melk(*_):
        if trainer.state is not None:
            save_experiment_checkpoint(ckpt_path, trainer)
            print(f"[melk] checkpoint saved to {ckpt_path}", flush=True)

    try:
        previous = signal.signal(signal.SIGUSR1, melk)
    except (ValueError, AttributeError):  # not the main thread, or no SIGUSR1
        previous = None

    log_dir = cfg.get("log_dir", "logs")
    if torch.distributed.is_initialized() and torch.distributed.get_rank() > 0:
        log_dir = os.path.join(log_dir, f"rank{torch.distributed.get_rank()}")
    logger = make_logger(cfg, out_dir=log_dir)
    logger.log_hyperparams(cfg)
    try:
        mode = cfg.get("mode", "train")
        if mode in ("validate", "test"):
            trainer.restore_payload = Trainer.load_checkpoint(ckpt_path)
            state = trainer.init_state()
            metrics = trainer.validate(state, max_batches=int(cfg.get("max_eval_batches", 8)))
            logger.log(metrics)
            print({k: round(v, 5) for k, v in metrics.items()})
            return {"metrics": metrics, "config": cfg, "trainer": trainer}
        try:
            history = trainer.fit(verbose=bool(cfg.get("verbose", True)), logger=logger)
        except Exception:
            melk()
            raise
        save_experiment_checkpoint(ckpt_path, trainer)
        print(f"checkpoint: {ckpt_path}")
        return {"history": history, "ckpt_path": ckpt_path, "trainer": trainer, "config": cfg}
    finally:
        logger.finish()
        if previous is not None:
            signal.signal(signal.SIGUSR1, previous)


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = argv.pop(0) if argv and argv[0].endswith(".json") else None
    run_model(config_path, argv)


if __name__ == "__main__":
    main()
