"""Plain torch versions of the batched TD-step kernels (csrc/batched_linear.cu):
the CPU path, and the yardstick the kernels are held to on the card."""
from __future__ import annotations

import torch


def bgemm(a: torch.Tensor, b: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) [+ bias (G, N) on every row] -> (G, M, N)."""
    c = a @ b
    return c if bias is None else c + bias[:, None, :]


def bgemm_colsum(a: torch.Tensor, b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a @ b, b summed over its K axis (G, N))."""
    return a @ b, b.sum(dim=1)


def sq_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """(G,) sqrt of the sum over the leaves, in order, of each agent's sum of
    squares."""
    total = 0
    for g in leaves:
        total = total + torch.square(g).reshape(g.shape[0], -1).sum(dim=1)
    return torch.sqrt(total)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (G, N, K) @ w (G, K, H) + b (G, H), differentiable by autograd."""
    return x @ w + b[:, None, :]
