"""Attention: GQA causal self-attention through the flash kernel, and
single-token decode against a KV cache (port of `repro/models/attention.py`).

Paths:
  self_attention() kind 'causal' goes through
                   `kernels.flash_attention.ops.gqa_flash_attention` with the
                   un-expanded K/V (the CUDA kernel on the card, the plain
                   dense version on the CPU) at every S.  The reference runs
                   `attend` up to DENSE_MAX_S and `attend_chunked` above it.
  attend()         dense einsum with mask, and
  attend_chunked() the online-softmax chunked loop: plain ports of the
                   reference's own attention, kept to hold the flash path
                   against it.
  decode_attend()  one new token vs the cache, plain torch (the reference
                   computes it outside any Pallas kernel).
Kinds 'window' and 'bidir' and cross attention are not ported yet
(ROADMAP.md, queue 1 item 11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnCfg
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.layers import DTYPE, _normal

NEG_INF = -1e9
CHUNK_Q = 512
CHUNK_KV = 1024
DENSE_MAX_S = 2048


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"repro_torch: {what} is not ported yet; see "
                               f"ROADMAP.md queue 1 item 11")


def init_attention(gen, d_model: int, cfg: AttnCfg) -> dict:
    s = d_model ** -0.5
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    params = {
        "wq": _normal(gen, (d_model, H * hd), s),
        "wk": _normal(gen, (d_model, K * hd), s),
        "wv": _normal(gen, (d_model, K * hd), s),
        "wo": _normal(gen, (H * hd, d_model), (H * hd) ** -0.5),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), dtype=DTYPE, device=gen.device)
        params["k_norm"] = torch.ones((hd,), dtype=DTYPE, device=gen.device)
    return params


def _qkv(params, x, cfg: AttnCfg, positions, rope: bool = True):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, K, hd)
    v = (x @ params["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = layers.l2norm(q) * params["q_norm"]
        k = layers.l2norm(k) * params["k_norm"]
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, n_heads):
    """Broadcast kv heads to match query heads (GQA)."""
    rep = n_heads // k.shape[2]
    return k.repeat_interleave(rep, dim=2) if rep > 1 else k


def _mask(sq, skv, q_off, kind: str, window: int, device=None):
    qi = q_off + torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    if kind == "bidir":
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    m = ki <= qi
    if kind == "window":
        m &= ki > qi - window
    return m


def attend(q, k, v, kind: str, window: int, scale: float, q_off=0):
    """Dense attention. q: (B,Sq,H,hd), k/v: (B,Skv,H,hd)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    m = _mask(q.shape[1], k.shape[1], q_off, kind, window, q.device)
    logits = logits.masked_fill(~m[None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attend_chunked(q, k, v, kind: str, window: int, scale: float):
    """Online-softmax chunked attention (flash-style, plain torch): outer
    loop over query chunks, inner loop over all KV chunks with causal
    masking.  Supports Sq != Skv for 'bidir': KV is padded to a chunk
    multiple and the padded positions are masked."""
    if kind == "window":
        raise _not_ported("windowed attention ('W'/'L' mixers)")
    B, S, H, hd = q.shape
    S_kv = k.shape[1]
    if kind != "bidir" and S_kv != S:
        raise ValueError("causal attention needs Sq == Skv")
    cq = min(CHUNK_Q, S)
    if S % cq:
        raise ValueError(f"attend_chunked: S={S} is not a multiple of {cq}")
    ckv = CHUNK_KV if S_kv >= CHUNK_KV else S_kv
    pad_kv = (-S_kv) % ckv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nkv = k.shape[1] // ckv
    kc = k.reshape(B, nkv, ckv, H, hd)
    vc = v.reshape(B, nkv, ckv, H, hd)
    masked_kv = S_kv < nkv * ckv
    outs = []
    for i in range(S // cq):
        q_i = q[:, i * cq:(i + 1) * cq]
        q_pos = i * cq + torch.arange(cq, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((B, H, cq), NEG_INF, device=q.device)
        l_run = torch.zeros((B, H, cq), device=q.device)
        for j in range(nkv):
            logits = torch.einsum("bqhd,bkhd->bhqk", q_i,
                                  kc[:, j]).float() * scale
            k_pos = j * ckv + torch.arange(ckv, device=q.device)
            if kind != "bidir":
                msk = k_pos[None, :] <= q_pos[:, None]
                logits = logits.masked_fill(~msk[None, None], NEG_INF)
            if masked_kv:
                logits = logits.masked_fill(
                    ~(k_pos < S_kv)[None, None, None], NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype), vc[:, j]))
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))           # (B,cq,H,hd)
    return torch.cat(outs, dim=1)


def self_attention(params, x, cfg: AttnCfg, kind: str, positions=None,
                   rope: bool = True):
    """kind: 'causal' ('window' and 'bidir' are not ported). Returns
    (B,S,D)."""
    if kind != "causal":
        raise _not_ported(f"self-attention of kind {kind!r}")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions, rope)
    scale = cfg.softmax_scale or cfg.head_dim ** -0.5
    o = flash_ops.gqa_flash_attention(q, k, v, causal=True, scale=scale)
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]


def cross_attention(params, x, memory, cfg: AttnCfg):
    raise _not_ported("cross attention ('C' mixers, the encoder)")


# ---------------------------------------------------------------------------
# Decode (single new token vs KV cache)
# ---------------------------------------------------------------------------

def decode_attend(params, x, cache_k, cache_v, position: int, cfg: AttnCfg):
    """x: (B,1,D); cache_k/v: (B,S,K,hd) with valid entries < position.
    Returns (out (B,1,D), new_k (B,1,K,hd), new_v)."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, 1, H, hd)
    k_new = (x @ params["wk"]).reshape(B, 1, K, hd)
    v_new = (x @ params["wv"]).reshape(B, 1, K, hd)
    if cfg.qk_norm:
        q = layers.l2norm(q) * params["q_norm"]
        k_new = layers.l2norm(k_new) * params["k_norm"]
    pos = torch.full((1,), position, dtype=torch.int32, device=x.device)
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, pos, cfg.rope_theta)

    S = cache_k.shape[1]
    scale = cfg.softmax_scale or hd ** -0.5
    rep = H // K
    qg = q.reshape(B, 1, K, rep, hd)
    logits = torch.einsum("bokrd,bskd->bkrs", qg, cache_k).float() * scale
    new_logit = torch.einsum("bokrd,bokd->bkro", qg, k_new).float() * scale
    ki = torch.arange(S, device=x.device)
    valid = ki[None, None, None, :] < position
    logits = logits.masked_fill(~valid, NEG_INF)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), new_logit)
    p = torch.exp(logits - m)
    p_new = torch.exp(new_logit - m)
    denom = p.sum(dim=-1, keepdim=True) + p_new
    ctx = (torch.einsum("bkrs,bskd->bkrd", (p / denom).to(x.dtype), cache_v)
           + (p_new / denom).to(x.dtype) * v_new.reshape(B, 1, K, 1, hd)[:, 0])
    out = ctx.reshape(B, 1, H * hd) @ params["wo"]
    return out, k_new, v_new
