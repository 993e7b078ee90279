"""Plain-torch version of the fused dueling-qnet kernel: the CPU path and
the yardstick the CUDA kernel (csrc/dueling_qnet.cu) is held to.  Every
argument carries a leading agent axis G: x (G, N, S), w0 (G, S, H1), ..."""
from __future__ import annotations

import torch


def dueling_qnet_ref(x, w0, b0, w1, b1, wv, bv, wa, ba):
    x = x.to(torch.float32)
    h = torch.clamp(x @ w0 + b0[:, None, :], min=0.0)
    h = torch.clamp(h @ w1 + b1[:, None, :], min=0.0)
    v = h @ wv + bv[:, None, :]
    a = h @ wa + ba[:, None, :]
    return v + a - a.mean(dim=-1, keepdim=True)
