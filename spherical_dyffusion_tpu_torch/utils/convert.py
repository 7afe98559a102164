"""Carry JAX-package SFNO weights into the port.

The port's modules keep the flax parameter names and layouts
(``models/modules.py``, ``models/sfno.py``: the dense, separable and
diagonal filter ``weight``, the ``cp_*``, ``tucker_*`` and ``tt_*`` factors,
the spectral-attention ``w{i}``/``b{i}``/``wout`` pairs, the layer norm's
``(h, w, 1)`` ``scale`` and ``bias``), so a flax parameter tree becomes a
``state_dict`` by flattening its nested dicts with "." as separator. Trees saved with
``SFNOConfig.scan_layers`` hold the middle blocks stacked under
``blocks_mid/block`` with a leading layer axis; they are first unstacked into
``block_1`` .. ``block_{L-2}``, as ``unstack_block_params`` of the JAX
package (``utils/params.py``) does. That module imports JAX, so its logic is
repeated here, on numpy arrays.

``train_state_payload`` carries a JAX ``TrainState`` across as the port
trainer's checkpoint payload: params, EMA params, and optax's Adam state
(``mu``, ``nu``, ``count``; with ``optax.MultiSteps`` also the accumulated
gradients and the mini-step) as AdamW's ``exp_avg``, ``exp_avg_sq`` and step,
so both packages can continue from the same mid-training state. The optax
states are found by their fields (no optax import).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["unstack_block_params", "flax_to_state_dict", "state_dict_to_flax",
           "train_state_payload"]


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _as_leaf(a):
    """numpy arrays as they are; torch tensors (the bfloat16 leaves of
    ``utils/flax_msgpack.py``) too; anything else through ``np.asarray``."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def unstack_block_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Explode ``blocks_mid/block`` (leading layer axis) into
    ``block_1`` .. ``block_{L-2}``; trees without it pass through."""
    if "blocks_mid" not in params:
        return dict(params)
    stacked = _tree_map(_as_leaf, params["blocks_mid"]["block"])
    n_mid = _first_leaf(stacked).shape[0]
    n = 1 + max(int(k.split("_")[1]) for k in params if k.startswith("block_"))
    if n != n_mid + 2:
        raise ValueError(f"stacked layout holds {n_mid} middle blocks but the "
                         f"unrolled ends imply {n - 2}")
    out = {k: v for k, v in params.items() if k != "blocks_mid"}
    for i in range(n_mid):
        out[f"block_{i + 1}"] = _tree_map(lambda a, i=i: a[i], stacked)
    return out


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax SFNO variable tree (``{"params": ...}`` or the params
    themselves; other collections such as ``constants`` are ignored) ->
    the port SFNO's ``state_dict`` as float32 CPU tensors."""
    params = variables.get("params", variables)
    params = unstack_block_params(params)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            elif isinstance(v, torch.Tensor):
                sd[name] = v.detach().to("cpu", torch.float32).clone()
            else:
                sd[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(params, "")
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict`` in the unrolled layout: a port
    SFNO's ``state_dict`` -> ``{"params": <nested dict of numpy arrays>}``,
    the tree ``utils/torch_convert.py:sfno_flax_to_torch`` takes."""
    params: Dict[str, Any] = {}
    for name, t in state_dict.items():
        node = params
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return {"params": params}


def _get(node, field):
    return node[field] if isinstance(node, Mapping) else getattr(node, field)


def _find(tree, *fields):
    """The first node of a (named)tuple/dict tree that has all ``fields``
    (as attributes, or as keys of a dict: flax's state dict of a
    namedtuple)."""
    if isinstance(tree, Mapping):
        if all(f in tree for f in fields):
            return tree
    elif all(hasattr(tree, f) for f in fields):
        return tree
    children = tree.values() if isinstance(tree, Mapping) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find(child, *fields)
        if found is not None:
            return found
    return None


def train_state_payload(state: Any) -> Dict[str, Any]:
    """A JAX ``TrainState`` (params, opt_state of the trainer's optax chain,
    ema, step), or the dict of a JAX msgpack checkpoint (``params``,
    ``ema_params``, ``opt_state`` as flax's state dict, ``step``) -> the
    port trainer's ``restore_payload``: ``params`` and ``ema_params`` as
    ``state_dict``s, and ``opt_state`` with ``exp_avg`` and ``exp_avg_sq``
    by parameter name, ``updates`` (Adam's count), ``mini_step`` and
    ``acc_grads`` (``MultiSteps``; 0 and None without). The moments come as
    float32 tensors (a bf16 ``mu`` exactly); the trainer stores ``exp_avg``
    in its ``adam_mu_dtype``."""
    if isinstance(state, Mapping):
        ema = state.get("ema_params") or None
        opt_state = state.get("opt_state")
    else:
        ema = getattr(state, "ema", None)
        ema = ema.params if ema is not None else None
        opt_state = state.opt_state
    opt = None
    if opt_state is not None:
        adam = _find(opt_state, "mu", "nu", "count")
        if adam is None:
            raise ValueError("no Adam state (mu, nu, count) in the optimizer state")
        multi = _find(opt_state, "mini_step", "acc_grads")
        mini = int(np.asarray(_get(multi, "mini_step"))) if multi is not None else 0
        opt = {
            "exp_avg": flax_to_state_dict(_get(adam, "mu")),
            "exp_avg_sq": flax_to_state_dict(_get(adam, "nu")),
            "updates": int(np.asarray(_get(adam, "count"))),
            "mini_step": mini,
            "acc_grads": flax_to_state_dict(_get(multi, "acc_grads")) if mini else None,
        }
    return {
        "params": flax_to_state_dict(_get(state, "params")),
        "ema_params": flax_to_state_dict(ema) if ema is not None else None,
        "opt_state": opt,
        "step": int(np.asarray(_get(state, "step"))),
    }
