"""Mamba2 / SSD (state-space duality) mixer (port of
`repro/models/mamba.py`).

Chunked SSD (prefill): the sequence is split into chunks of length Q; the
within-chunk masked quadratic form and the inter-chunk state recurrence are
the SSD scan, `kernels.ssd_scan.ops.ssd` (the CUDA kernel on the card, the
plain chunked version on the CPU):

  dA_t = dt_t * A_h                          (A_h < 0, per head)
  seg  = within-chunk cumsum of dA
  intra:  Y_ij = (C_i . B_j) * exp(seg_i - seg_j) * dt_j  for i >= j
  states: S_c  = sum_j exp(seg_end - seg_j) * B_j (x) (dt_j * X_j)
  recur:  R_{c+1} = exp(sum_c dA) * R_c + S_c
  inter:  Y_i  += (C_i . R_c) * exp(seg_i)
  out:    y = (Y + D * x) -> RMSNorm gated by silu(z) -> out_proj

The D-skip and the gated RMSNorm stay outside the kernel, as in the
reference.  Decode: the exact per-token recurrence on the (B, H, N, P) state
plus a causal depthwise-conv ring buffer, in plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.layers import DTYPE, _normal


def dims(d_model: int, cfg: SSMCfg):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return d_inner, n_heads


def init_mamba(gen, d_model: int, cfg: SSMCfg) -> dict:
    d_inner, H = dims(d_model, cfg)
    G, N = cfg.n_groups, cfg.d_state
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_in": _normal(gen, (d_model, d_in_proj), d_model ** -0.5),
        "conv_w": _normal(gen, (cfg.conv, conv_ch), 0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=DTYPE, device=dev),
        "a_log": torch.log(torch.arange(1, H + 1, **f32)),
        "d_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_scale": torch.ones((d_inner,), dtype=DTYPE, device=dev),
        "w_out": _normal(gen, (d_inner, d_model), d_inner ** -0.5),
    }


def _split_proj(proj, d_inner, G, N, H):
    z, x, B, C, dt = torch.split(proj, [d_inner, d_inner, G * N, G * N, H],
                                 dim=-1)
    return z, x, B, C, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq. x: (B,L,CH); w: (K,CH)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def mamba_block(params, hidden, cfg: SSMCfg, d_model: int):
    """hidden: (B, L, D) -> (B, L, D). Chunked SSD."""
    Bsz, L, _ = hidden.shape
    d_inner, H = dims(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim
    Q = min(cfg.chunk, L)
    if L % Q:
        raise ValueError(f"mamba_block: L={L} is not a multiple of the chunk "
                         f"{Q}")

    proj = hidden @ params["w_in"]
    z, xBC_x, Bmat, Cmat, dt = _split_proj(proj, d_inner, G, N, H)
    xBC = torch.cat([xBC_x, Bmat, Cmat], dim=-1)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    x, Bmat, Cmat = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)

    x = x.reshape(Bsz, L, H, P)
    # the reference uses group 0 only (one B/C pair for all heads)
    Bmat = Bmat.reshape(Bsz, L, G, N)[:, :, 0].float()
    Cmat = Cmat.reshape(Bsz, L, G, N)[:, :, 0].float()
    dt = F.softplus(dt.float() + params["dt_bias"])                # (B,L,H)
    A = -torch.exp(params["a_log"])                                # (H,)

    y = ssd_ops.ssd(x.float(), Bmat, Cmat, dt, A, chunk=Q)         # (B,L,H,P)
    y = y + params["d_skip"][None, None, :, None] * x.float()
    y = y.reshape(Bsz, L, d_inner).to(hidden.dtype)
    y = layers.rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    return y @ params["w_out"]


# ---------------------------------------------------------------------------
# Decode (recurrent step)
# ---------------------------------------------------------------------------

def init_decode_state(batch: int, d_model: int, cfg: SSMCfg, device) -> dict:
    d_inner, H = dims(d_model, cfg)
    conv_ch = d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "ssm": torch.zeros((batch, H, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv - 1, conv_ch), dtype=DTYPE,
                            device=device),
    }


def mamba_decode_step(params, hidden, state, cfg: SSMCfg, d_model: int):
    """hidden: (B, 1, D); state: {ssm (B,H,N,P), conv (B,K-1,CH)}."""
    Bsz = hidden.shape[0]
    d_inner, H = dims(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim

    proj = hidden[:, 0] @ params["w_in"]                           # (B, dproj)
    z, x, Bmat, Cmat, dt = _split_proj(proj, d_inner, G, N, H)
    xBC = torch.cat([x, Bmat, Cmat], dim=-1)                       # (B, CH)
    window = torch.cat([state["conv"], xBC[:, None]], dim=1)       # (B,K,CH)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"])
                      + params["conv_b"])
    new_conv = window[:, 1:]
    x, Bmat, Cmat = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    x = x.reshape(Bsz, H, P).float()
    Bv = Bmat.reshape(Bsz, G, N)[:, 0].float()                     # (B,N)
    Cv = Cmat.reshape(Bsz, G, N)[:, 0].float()
    dt = F.softplus(dt.float() + params["dt_bias"])                # (B,H)
    A = -torch.exp(params["a_log"])
    decay = torch.exp(dt * A)                                      # (B,H)

    new_ssm = (state["ssm"] * decay[:, :, None, None]
               + torch.einsum("bn,bh,bhp->bhnp", Bv, dt, x))
    y = torch.einsum("bn,bhnp->bhp", Cv, new_ssm)
    y = y + params["d_skip"][None, :, None] * x
    y = y.reshape(Bsz, d_inner).to(hidden.dtype)
    y = layers.rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = (y @ params["w_out"])[:, None]
    return out, {"ssm": new_ssm, "conv": new_conv}
