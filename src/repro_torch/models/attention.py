"""Attention: GQA causal, sliding-window and bidirectional self-attention
and cross attention through the flash kernel, and single-token decode
against a KV cache (port of `repro/models/attention.py`).

Paths:
  self_attention() kinds 'causal', 'window' and 'bidir' go through
                   `kernels.flash_attention.ops.gqa_flash_attention_kv` with
                   the un-expanded K/V (the CUDA kernel on the card, the
                   plain dense version on the CPU) at every S: causal, with
                   `window=cfg.window` for 'window', or non-causal for
                   'bidir' (the encoder), at any S, 1500 included.  The
                   reference runs `attend` up to DENSE_MAX_S and
                   `attend_chunked` above it.
  cross_attention() queries (B, Sq, D) against a memory (B, S_kv, D) or its
                   precomputed (k, v): through the same kernel, non-causal
                   with S_kv != Sq, for Sq > DECODE_MAX_Q (prefill); dense
                   `attend` at or below it (decode), as the reference
                   computes it outside any Pallas kernel.  No RoPE, no
                   qk-norm, as in the reference.
  attend()         dense einsum with mask,
  attend_chunked() the online-softmax chunked loop (for 'window', a KV span
                   per query chunk; `kv_valid` masks padded keys): plain
                   ports of the reference's own attention, kept to hold the
                   flash path against it.
  decode_attend()  one new token vs the cache, plain torch (the reference
                   computes it outside any Pallas kernel).
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
DECODE_MAX_Q = 16       # cross attention at or below it: dense `attend`
KINDS = ("causal", "window", "bidir")


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


def attend_chunked(q, k, v, kind: str, window: int, scale: float,
                   kv_valid: int | None = None):
    """Online-softmax chunked attention (flash-style, plain torch): outer
    loop over query chunks, inner loop over all KV chunks with causal
    masking.  Windowed ('window'): per query chunk only the KV window's
    span is read, so the work stays linear in S.  Supports Sq != Skv for
    'bidir' (cross attention): KV is padded to a chunk multiple and the
    positions at or past `kv_valid` (default Skv) are masked."""
    B, S, H, hd = q.shape
    S_kv = k.shape[1]
    if kind != "bidir" and S_kv != S:
        raise ValueError("causal/windowed attention needs Sq == Skv")
    kv_valid = S_kv if kv_valid is None else kv_valid
    cq = min(CHUNK_Q, S)
    if S % cq:
        raise ValueError(f"attend_chunked: S={S} is not a multiple of {cq}")
    if kind == "window" and window + cq < S:
        return _attend_window_spans(q, k, v, window, scale, cq)
    ckv = CHUNK_KV if S_kv >= CHUNK_KV else S_kv
    pad_kv = (-S_kv) % ckv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nkv = k.shape[1] // ckv
    kc = k.reshape(B, nkv, ckv, H, hd)
    vc = v.reshape(B, nkv, ckv, H, hd)
    masked_kv = kv_valid < nkv * ckv
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
                    ~(k_pos < kv_valid)[None, None, None], NEG_INF)
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


def _attend_window_spans(q, k, v, window: int, scale: float, cq: int):
    """The reference's windowed branch of `attend_chunked`: K/V padded in
    front by the span, query chunk i against keys i*cq - span .. i*cq + cq,
    dense masked softmax per chunk."""
    B, S, H, hd = q.shape
    kv_span = min((window + cq + CHUNK_KV - 1) // CHUNK_KV * CHUNK_KV, S)
    kp = F.pad(k, (0, 0, 0, 0, kv_span, 0))
    vp = F.pad(v, (0, 0, 0, 0, kv_span, 0))
    qi = torch.arange(cq, device=q.device)[:, None]
    kj = torch.arange(kv_span + cq, device=q.device)[None, :]
    outs = []
    for i in range(S // cq):
        q_i = q[:, i * cq:(i + 1) * cq]
        k_i = kp[:, i * cq:i * cq + kv_span + cq]
        v_i = vp[:, i * cq:i * cq + kv_span + cq]
        # positions of k_i run from i*cq - kv_span (pre-pad space)
        qpos, kpos = i * cq + qi, i * cq - kv_span + kj
        m = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
        logits = torch.einsum("bqhd,bkhd->bhqk", q_i, k_i).float() * scale
        logits = logits.masked_fill(~m[None, None], NEG_INF)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v_i))
    return torch.cat(outs, dim=1)


def self_attention(params, x, cfg: AttnCfg, kind: str, positions=None,
                   rope: bool = True):
    """kind: 'causal' | 'window' | 'bidir'. Returns (B,S,D)."""
    if kind not in KINDS:
        raise ValueError(f"self_attention: kind {kind!r} not in {KINDS}")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions, rope)
    scale = cfg.softmax_scale or cfg.head_dim ** -0.5
    o = flash_ops.gqa_flash_attention_kv(
        q, k, v, causal=kind != "bidir", scale=scale,
        window=cfg.window if kind == "window" else 0)
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder / VLM image layers)
# ---------------------------------------------------------------------------

def cross_attention(params, x, memory, cfg: AttnCfg):
    """x: (B,Sq,D) queries; memory: (B,Skv,D) or precomputed (k, v), each
    (B,Skv,K,hd). Returns (B,Sq,D)."""
    B, Sq, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, Sq, H, hd)
    if isinstance(memory, tuple):
        k, v = memory
    else:
        Skv = memory.shape[1]
        k = (memory @ params["wk"]).reshape(B, Skv, K, hd)
        v = (memory @ params["wv"]).reshape(B, Skv, K, hd)
    scale = cfg.softmax_scale or hd ** -0.5
    if Sq <= DECODE_MAX_Q:
        o = attend(q, _expand_kv(k, H), _expand_kv(v, H), "bidir", 0, scale)
    else:
        o = flash_ops.gqa_flash_attention_kv(q, k, v, causal=False,
                                             scale=scale)
    return o.reshape(B, Sq, H * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# Decode (single new token vs KV cache)
# ---------------------------------------------------------------------------

def decode_attend(params, x, cache_k, cache_v, position: int, cfg: AttnCfg,
                  window: int = 0):
    """x: (B,1,D); cache_k/v: (B,S,K,hd) with valid entries < position (and,
    with a window, >= position - window).
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
    if window:
        valid &= ki[None, None, None, :] >= position - window
    logits = logits.masked_fill(~valid, NEG_INF)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), new_logit)
    p = torch.exp(logits - m)
    p_new = torch.exp(new_logit - m)
    denom = p.sum(dim=-1, keepdim=True) + p_new
    ctx = (torch.einsum("bkrs,bskd->bkrd", (p / denom).to(x.dtype), cache_v)
           + (p_new / denom).to(x.dtype) * v_new.reshape(B, 1, K, 1, hd)[:, 0])
    out = ctx.reshape(B, 1, H * hd) @ params["wo"]
    return out, k_new, v_new
