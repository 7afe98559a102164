"""Parameter utilities: wildcard matching, freezing, partial loading, and the
SFNO's block layouts.

Counterpart of ``spherical_dyffusion_tpu/utils/params.py``. The port's
networks keep the flax parameter names, so a parameter's name here is its
``state_dict`` key with "." replaced by "/" (``block_0.filter.weight`` is
``block_0/filter/weight``), and a pattern written for the JAX package selects
the same parameters in the port:

* ``param_names``, ``matches_any``, ``freeze_mask``: fnmatch patterns over
  those names;
* ``frozen_param_optimizer``: an optimizer built over the parameters that no
  pattern matches, so frozen ones never move and no moment is made for them
  (JAX masks their updates with ``optax.masked``);
* ``overwrite_weights``, ``ParameterInitConfig``, ``apply_parameter_init``:
  copying weights from another ``state_dict`` by name, a shape-mismatched one
  by its overlapping leading hyper-slab;
* ``stack_block_params``, ``adapt_block_layout``, ``unstack_block_params``:
  the unrolled (``block_i``) and stacked (``blocks_mid/block``, JAX's
  ``SFNOConfig.scan_layers``) layouts of a nested flax parameter tree. The
  port's SFNO always holds the unrolled layout (``scan_layers`` runs the
  same blocks in a loop), so its loaders unstack a stacked tree
  (``utils/convert.py:flax_to_state_dict``) where JAX's restack it to fit its
  template.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "param_names",
    "matches_any",
    "freeze_mask",
    "frozen_param_optimizer",
    "overwrite_weights",
    "adapt_block_layout",
    "stack_block_params",
    "unstack_block_params",
    "ParameterInitConfig",
    "apply_parameter_init",
]

StateLike = Union[torch.nn.Module, Mapping[str, Any]]


def _name(key: str) -> str:
    return key.replace(".", "/")


def _named(tree: StateLike) -> Dict[str, Any]:
    """``{"/"-joined name: leaf}`` of a module (its parameters), a flat
    ``state_dict`` or a nested dict of leaves."""
    if isinstance(tree, torch.nn.Module):
        return {_name(k): p for k, p in tree.named_parameters()}
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{_name(str(k))}"
            if isinstance(v, Mapping):
                walk(v, name + "/")
            else:
                out[name] = v

    walk(tree, "")
    return out


def param_names(tree: StateLike) -> List[str]:
    return list(_named(tree))


def matches_any(name: str, patterns: Sequence[str]) -> bool:
    """fnmatch wildcard matching (the JAX package's rule)."""
    return any(fnmatch.fnmatch(name, pat) for pat in patterns)


def freeze_mask(tree: StateLike, frozen_patterns: Sequence[str]) -> Dict[str, bool]:
    """``{name: trainable}``: False where a pattern matches the name."""
    return {n: not matches_any(n, frozen_patterns) for n in _named(tree)}


def frozen_param_optimizer(make_optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                                    torch.optim.Optimizer],
                           module: torch.nn.Module,
                           frozen_patterns: Sequence[str]) -> torch.optim.Optimizer:
    """``make_optimizer`` (say ``lambda ps: torch.optim.AdamW(ps, lr=...)``)
    over the module's parameters that no pattern matches. The frozen ones
    are left out and their ``requires_grad`` turned off, so they never move
    (weight decay included) and no optimizer state is made for them."""
    trainable = []
    for name, p in module.named_parameters():
        if matches_any(_name(name), frozen_patterns):
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return make_optimizer(trainable)


def overwrite_weights(target: StateLike, source: StateLike,
                      include: Optional[Sequence[str]] = None,
                      exclude: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """``target``'s ``state_dict`` (keys as they are) with the entries that
    ``source`` holds under the same name copied in, in the target's dtype;
    an entry of another shape but the same rank gets the overlapping leading
    hyper-slab (the JAX package's rule for growing models)."""
    tgt = target.state_dict() if isinstance(target, torch.nn.Module) else target
    src = _named(source)
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in tgt.items():
        leaf = torch.as_tensor(leaf)
        name = _name(key)
        out[key] = leaf
        if include is not None and not matches_any(name, include):
            continue
        if matches_any(name, exclude) or name not in src:
            continue
        s = torch.as_tensor(np.asarray(src[name]) if not isinstance(src[name], torch.Tensor)
                            else src[name])
        if tuple(s.shape) == tuple(leaf.shape):
            out[key] = s.to(leaf.dtype, copy=True).to(leaf.device)
        elif s.dim() == leaf.dim():
            new = leaf.detach().clone()
            sl = tuple(slice(0, min(a, b)) for a, b in zip(leaf.shape, s.shape))
            new[sl] = s[sl].to(leaf.dtype).to(leaf.device)
            out[key] = new
    return out


@dataclasses.dataclass(frozen=True)
class ParameterInitConfig:
    """Start from another checkpoint's weights (``include``/``exclude``
    patterns) and freeze a subset of parameters, as the JAX package's."""

    weights_path: Optional[str] = None
    include: Optional[Sequence[str]] = None
    exclude: Sequence[str] = ()
    frozen_parameters: Sequence[str] = ()


def apply_parameter_init(target: StateLike, cfg: ParameterInitConfig,
                         load_fn: Optional[Callable[[str], Mapping[str, Any]]] = None):
    """The init config applied to a freshly built network: with
    ``weights_path``, its weights overwritten from that checkpoint's
    ``params`` (``load_fn(path)``, by default the trainer's checkpoint
    reader). A module is loaded in place and returned; a ``state_dict``
    comes back as a new one."""
    if not cfg.weights_path:
        return target
    if load_fn is None:
        from ..training.trainer import Trainer

        def load_fn(p):
            return Trainer.load_checkpoint(p)["params"]
    new = overwrite_weights(target, load_fn(cfg.weights_path), cfg.include, cfg.exclude)
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(new)
        return target
    return new


# ------------------------------------------------------------ block layouts

def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _as_leaf(a):
    """numpy arrays and torch tensors (the bfloat16 leaves of
    ``utils/flax_msgpack.py``) as they are; anything else through numpy."""
    return a if isinstance(a, (torch.Tensor, np.ndarray)) else np.asarray(a)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _is_blockkeyed(d) -> bool:
    return isinstance(d, Mapping) and any(str(k).startswith("block_") for k in d)


def _n_blocks(params: Mapping[str, Any]) -> int:
    return 1 + max(int(k.split("_")[1]) for k in params if k.startswith("block_"))


def _stack(*xs):
    xs = [_as_leaf(x) for x in xs]
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, 0)
    return np.stack(xs, 0)


def stack_block_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """An unrolled SFNO parameter mapping (``block_0`` .. ``block_{L-1}``)
    -> the stacked layout: blocks 1 .. L-2 under ``blocks_mid/block`` with a
    leading layer axis, the first and last blocks as they are."""
    if not _is_blockkeyed(params):
        raise ValueError("stack_block_params: no block_i keys found")
    n = _n_blocks(params)
    if n < 3:
        raise ValueError(f"stack_block_params: need >=3 blocks, got {n}")
    mid = [params[f"block_{i}"] for i in range(1, n - 1)]
    out = {k: v for k, v in params.items()
           if not (k.startswith("block_") and 0 < int(k.split("_")[1]) < n - 1)}
    out["blocks_mid"] = {"block": _tree_map(_stack, *mid)}
    return out


def unstack_block_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``stack_block_params``: ``blocks_mid/block`` exploded
    into ``block_1`` .. ``block_{L-2}``."""
    if "blocks_mid" not in params:
        raise ValueError("unstack_block_params: no blocks_mid key found")
    stacked = _tree_map(_as_leaf, params["blocks_mid"]["block"])
    n_mid = _first_leaf(stacked).shape[0]
    n = _n_blocks(params)
    if n != n_mid + 2:
        raise ValueError(f"stacked layout holds {n_mid} middle blocks but the unrolled ends "
                         f"imply {n - 2}")
    out = {k: v for k, v in params.items() if k != "blocks_mid"}
    for i in range(n_mid):
        out[f"block_{i + 1}"] = _tree_map(lambda a, i=i: a[i], stacked)
    return out


def adapt_block_layout(template: Any, source: Any) -> Any:
    """``source``'s SFNO subtrees converted to the layout (unrolled or
    stacked) that ``template`` uses wherever the two differ; subtrees whose
    layouts agree, and other subtrees, pass through."""
    if not (isinstance(template, Mapping) and isinstance(source, Mapping)):
        return source
    t_mid, s_mid = "blocks_mid" in template, "blocks_mid" in source
    if t_mid and not s_mid and _is_blockkeyed(source):
        source = stack_block_params(source)
    elif s_mid and not t_mid and _is_blockkeyed(template):
        source = unstack_block_params(source)
    return {k: (adapt_block_layout(template[k], v) if k in template else v)
            for k, v in source.items()}
