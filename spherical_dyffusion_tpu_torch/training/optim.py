"""AdamW with its first moment stored in a narrower dtype.

Counterpart of ``optax.adamw(..., mu_dtype=...)`` as the JAX trainer builds
it for ``TrainerConfig.adam_mu_dtype`` (``training/trainer.py:297-302``
there). ``torch.optim.AdamW`` keeps ``exp_avg`` in the parameter's dtype, so
this step is written with ``torch._foreach_*`` ops, with optax's rounding
points (``scale_by_adam``, then ``add_decayed_weights``, then the learning
rate):

* ``mu = (1 - b1) * g + b1 * mu_stored``, in float32 from the stored
  moment and the float32 gradient; ``b1 * mu_stored`` is computed in the
  stored dtype, with ``b1`` rounded to it, as JAX multiplies a bf16 array by
  a Python float (0.9 becomes 0.8984375 in bf16);
* ``nu = (1 - b2) * g * g + b2 * nu``, float32;
* the update ``(mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p``, times
  ``-lr``, added to p, from that float32 ``mu``;
* ``mu`` is stored rounded to the stored dtype (the update keeps the
  float32 value).

The step runs over chunks of at most ``CHUNK`` elements (a larger tensor
is a chunk of its own), so that its float32 temporaries (the moment, the
denominator) stay near two chunks: over all parameters at once they would
outgrow the half of ``exp_avg`` that the bf16 moment saves. ``nu``, the
weight decay and the step are updated in place (``addcmul_``, ``add_``
with ``alpha``), which may round the last float32 bit apart from optax's
separate product and sum.

The bias corrections ``bc = 1 - b ** count`` are Python floats, as in
``torch.optim.AdamW``; optax evaluates them in float32 (``1 - 0.999`` rounds
1.3e-5 off there). The trainer uses this class only where ``adam_mu_dtype``
is narrower than float32; the default path and "float32" keep
``torch.optim.AdamW``. The state keys are
AdamW's (``step``, ``exp_avg``, ``exp_avg_sq``), so checkpoints hold both
alike.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

__all__ = ["AdamWLowMu", "CHUNK"]

CHUNK = 1 << 25  # elements of one foreach pass (128 MB of float32)


def _chunks(params):
    out, size = [], 0
    for p in params:
        if out and size + p.numel() > CHUNK:
            yield out
            out, size = [], 0
        out.append(p)
        size += p.numel()
    if out:
        yield out


class AdamWLowMu(torch.optim.Optimizer):
    """AdamW whose ``exp_avg`` is stored in ``mu_dtype`` (optax's rule)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWLowMu takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
            count = int(self.state[params[0]]["step"])
            b1, b2 = group["betas"]
            b1_stored = float(torch.tensor(b1, dtype=self.mu_dtype))
            for chunk in _chunks(params):
                grads = [p.grad for p in chunk]
                stored = [self.state[p]["exp_avg"] for p in chunk]
                nus = [self.state[p]["exp_avg_sq"] for p in chunk]
                mu = [m.float() for m in torch._foreach_mul(stored, b1_stored)]
                torch._foreach_add_(mu, grads, alpha=1.0 - b1)
                torch._foreach_mul_(nus, b2)
                torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
                torch._foreach_copy_(stored, mu)  # the stored moment, rounded
                denom = torch._foreach_div(nus, 1.0 - b2 ** count)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_div_(mu, 1.0 - b1 ** count)
                torch._foreach_div_(mu, denom)  # the update, in mu's buffers
                del denom
                if group["weight_decay"]:
                    torch._foreach_add_(mu, chunk, alpha=group["weight_decay"])
                torch._foreach_add_(chunk, mu, alpha=-group["lr"])
        return None
