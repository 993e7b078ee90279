"""Plain torch version of the agents' TD-step kernel (csrc/td_grad.cu): the
CPU path, the route for network shapes the kernel does not cover, and the
yardstick the kernel is held to on the card.  The Q network's forward
(`q_values`) and the TD loss (`td_error`) live here, and `core/dqn.py` uses
them, so the gradient path has one definition and this module imports
nothing above the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.batched_linear.ops import linear


def q_values(params: dict, x: torch.Tensor, dueling: bool) -> torch.Tensor:
    """Q (G, N, A) for states x (G, N, S): ReLU layers w0, w1, ... then the
    dueling head V + A - mean_a A, or the plain head w_q.  The products go
    through `batched_linear`'s `linear` (its kernels on the card,
    torch.matmul on the CPU)."""
    x = x.to(torch.float32)
    i = 0
    while f"w{i}" in params:
        x = torch.clamp(linear(x, params[f"w{i}"], params[f"b{i}"]), min=0.0)
        i += 1
    if dueling:
        v = linear(x, params["w_v"], params["b_v"])               # (G, N, 1)
        a = linear(x, params["w_a"], params["b_a"])               # (G, N, A)
        return v + a - a.mean(dim=-1, keepdim=True)
    return linear(x, params["w_q"], params["b_q"])


def td_error(params: dict, s: torch.Tensor, a: torch.Tensor,
             y: torch.Tensor, w: torch.Tensor, dueling: bool) -> torch.Tensor:
    """(G,) squared TD error per agent (paper eq. 3) of Q(s, a) against the
    targets y (G, N), rows weighted by w (G, N): sum(((y - Q(s, a)) w)^2)
    / max(sum(w), 1)."""
    q = q_values(params, s, dueling)                             # (G, N, A)
    q_sa = q.gather(2, a.long()[:, :, None])[:, :, 0]
    err = (y - q_sa) * w               # `w` masks invalid (not-yet-filled) rows
    return torch.square(err).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)


def td_grad(params: dict, s: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
            w: torch.Tensor, ready: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss (G,), gradients) of each agent's squared TD error for its
    minibatch s (G, N, S), actions a (G, N), targets y (G, N) and row
    weights w (G, N): `td_error`, autograd, and every gradient times
    `ready` (G,) float32.  `cfg` is the network's `DQNConfig`."""
    keys = list(params)
    with torch.enable_grad():
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss = td_error(leaves, s, a, y, w, cfg.dueling)
        grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in keys])
    shape = lambda g: (-1,) + (1,) * (g.dim() - 1)
    return loss.detach(), {k: g * ready.reshape(shape(g))
                           for k, g in zip(keys, grads)}
