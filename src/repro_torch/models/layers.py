"""Fundamental layers, forward only (port of `repro/models/layers.py`):
RMSNorm, RoPE, the SwiGLU and GELU MLPs, embeddings.

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
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    params = {"w_gate": _normal(gen, (d_model, d_ff), s_in)} if swiglu else {}
    params["w_up"] = _normal(gen, (d_model, d_ff), s_in)
    params["w_down"] = _normal(gen, (d_ff, d_model), s_out)
    return params


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh approximation (torch's own default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(params, x, swiglu: bool = True):
    """SwiGLU, or (swiglu False, whisper) gelu(x w_up) w_down."""
    if not swiglu:
        return (gelu(x @ params["w_up"]) @ params["w_down"]).to(x.dtype)
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
