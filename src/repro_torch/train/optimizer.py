"""AdamW in plain torch (port of the part of `repro.train.optimizer` that the
agent uses).

Follows the reference's (init, update) protocol over parameter dicts:
    state = init(params)
    new_params, new_state = update(grads, state, params, step)
Every leaf carries a leading agent axis B, and gradient clipping takes each
agent's own global norm, as the reference's per-lane vmap does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.batched_linear.ops import sq_norm


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def constant_schedule(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) global L2 norm of each agent's leaves, summed in the reference's
    leaf order (sorted keys, as jax.tree flattens a dict), as one
    `batched_linear.sq_norm`: on the card one launch whose order does not
    depend on the number of agents B."""
    return sq_norm([tree[k].to(torch.float32) for k in sorted(tree)])


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    def update(grads, state, params, step):
        grads = {k: g.to(torch.float32) for k, g in grads.items()}
        if grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            grads = {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                     for k, g in grads.items()}
        t = step.to(torch.float32) + 1.0
        lr_t = sched(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            shape = (-1,) + (1,) * (g.dim() - 1)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            mh = m / bc1.reshape(shape)
            vh = v / bc2.reshape(shape)
            delta = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32)
                        - lr_t.reshape(shape) * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, update)
