"""Gradient compression for data-parallel reductions (port of
`repro/train/compression.py`), in plain torch ops: the reference computes
it outside any Pallas kernel.

`compress_decompress`: int8 blockwise quantize then dequantize (symmetric,
one f32 scale per 256-value block), the wire format of a compressed
all-reduce applied in place of the reduction so that training sees its
error.  `topk_with_error_feedback`: keep the largest `frac` of |g +
residual|, feed the rest back.  `torch.round` rounds half to even, as
`jnp.round`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 256


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """int8 blockwise quantize -> dequantize, in g's dtype."""
    if g.numel() < _BLOCK:
        return g
    n = g.numel()
    pad = (-n) % _BLOCK
    flat = F.pad(g.to(torch.float32).reshape(-1), (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    out = (q * scale).reshape(-1)[:n].reshape(g.shape)
    return out.to(g.dtype)


def topk_with_error_feedback(g: torch.Tensor, residual: torch.Tensor,
                             frac: float = 0.01):
    """(sent, new_residual): the entries of acc = g + residual with |acc| at
    or above the k-th largest (k = max(g.numel() * frac, 1)) are sent, in
    g's dtype; the rest stays in the residual (f32)."""
    acc = g.to(torch.float32) + residual
    k = max(int(g.numel() * frac), 1)
    flat = acc.reshape(-1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (flat.abs() >= thresh).to(torch.float32)
    sent = flat * mask
    new_residual = (flat - sent).reshape(g.shape)
    return sent.reshape(g.shape).to(g.dtype), new_residual
