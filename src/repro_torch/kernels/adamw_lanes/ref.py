"""Plain torch version of the agents' clipped AdamW kernel
(csrc/adamw_lanes.cu): the CPU path, and on the card the yardstick the
kernel is held to (the norm there one `batched_linear.sq_norm` launch)."""
from __future__ import annotations

import torch

from repro_torch.kernels.batched_linear.ops import sq_norm


def adamw_lanes(grads: dict, m: dict, v: dict, params: dict,
                bc1: torch.Tensor, bc2: torch.Tensor, lr_t: torch.Tensor, *,
                b1: float, b2: float, eps: float, weight_decay: float,
                grad_clip: float) -> tuple[dict, dict, dict]:
    """(new params, new m, new v) of one AdamW step per agent: every leaf
    carries a leading agent axis G, each agent's gradients are clipped by
    its own global norm over the sorted leaves (where grad_clip > 0), and
    bc1, bc2, lr_t (G,) are the step's bias corrections and rate."""
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if grad_clip > 0:
        gnorm = sq_norm([grads[k] for k in sorted(grads)])
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        grads = {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                 for k, g in grads.items()}
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        shape = (-1,) + (1,) * (g.dim() - 1)
        mk = b1 * m[k] + (1 - b1) * g
        vk = b2 * v[k] + (1 - b2) * g * g
        mh = mk / bc1.reshape(shape)
        vh = vk / bc2.reshape(shape)
        delta = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32)
                    - lr_t.reshape(shape) * delta).to(p.dtype)
        new_m[k], new_v[k] = mk, vk
    return new_p, new_m, new_v
