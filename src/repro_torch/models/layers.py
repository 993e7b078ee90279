"""Fundamental layers, forward only (port of `repro/models/layers.py`):
RMSNorm, RoPE, the SwiGLU MLP, embeddings.

Pure functions over explicit parameter dicts.  Parameters are bf16; norms
and softmax accumulate in fp32.  The reference's sharding roles and its
custom VJP of RMSNorm (a training concern) have no counterpart here; the
`init_*` functions draw from a `torch.Generator` on the given device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPE = torch.bfloat16


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(DTYPE)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=DTYPE, device=device)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


def l2norm(x, eps=1e-6):
    """Per-head qk-norm (qwen3)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,) or broadcastable."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, swiglu: bool = True) -> dict:
    if not swiglu:
        raise NotImplementedError("repro_torch: the GELU MLP (whisper) is not "
                                  "ported yet; see ROADMAP.md queue 1")
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {"w_gate": _normal(gen, (d_model, d_ff), s_in),
            "w_up": _normal(gen, (d_model, d_ff), s_in),
            "w_down": _normal(gen, (d_ff, d_model), s_out)}


def mlp(params, x, swiglu: bool = True):
    if not swiglu:
        raise NotImplementedError("repro_torch: the GELU MLP (whisper) is not "
                                  "ported yet; see ROADMAP.md queue 1")
    g = F.silu(x @ params["w_gate"])
    return ((g * (x @ params["w_up"])) @ params["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab_padded: int, d_model: int) -> dict:
    return {"table": _normal(gen, (vocab_padded, d_model), 1.0)}


def embed(params, tokens):
    return params["table"][tokens]


def init_lm_head(gen, d_model: int, vocab_padded: int) -> dict:
    return {"w": _normal(gen, (d_model, vocab_padded), d_model ** -0.5)}
