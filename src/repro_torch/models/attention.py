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
Training: every kind and the cross attention take their gradient from the
same entry (on the card its `FlashAttention` autograd function, whose
backward kernels take every mask and key length above); dense `attend`
(Sq <= DECODE_MAX_Q) is differentiated by autograd.
  attend()         dense einsum with mask,
  attend_chunked() the online-softmax chunked loop (for 'window', a KV span
                   per query chunk; `kv_valid` masks padded keys): plain
                   ports of the reference's own attention, kept to hold the
                   flash path against it.
  decode_attend()  one new token vs the cache, plain torch (the reference
                   computes it outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnCfg
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.layers import DTYPE, _normal
from repro_torch.sharding.context import (batch_heads_placements, is_dtensor,
                                          merge_heads, on_local_shards,
                                          replicate_like, split_heads)

NEG_INF = -1e9
CHUNK_Q = 512
CHUNK_KV = 1024
DENSE_MAX_S = 2048
DECODE_MAX_Q = 16       # cross attention at or below it: dense `attend`
KINDS = ("causal", "window", "bidir")


def init_attention(gen, d_model: int, cfg: AttnCfg):
    s = d_model ** -0.5
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    params = {
        "wq": _normal(gen, (d_model, H * hd), s),
        "wk": _normal(gen, (d_model, K * hd), s),
        "wv": _normal(gen, (d_model, K * hd), s),
        "wo": _normal(gen, (H * hd, d_model), (H * hd) ** -0.5),
    }
    roles = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
             "wv": ("embed", "kvheads"), "wo": ("qheads", "embed")}
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), dtype=DTYPE, device=gen.device)
        params["k_norm"] = torch.ones((hd,), dtype=DTYPE, device=gen.device)
        roles["q_norm"] = (None,)
        roles["k_norm"] = (None,)
    return params, roles


def _qkv(params, x, cfg: AttnCfg, positions, rope: bool = True):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = split_heads(layers.linear(x, params["wq"]), (B, S, H, hd))
    k = split_heads(layers.linear(x, params["wk"]), (B, S, K, hd))
    v = split_heads(layers.linear(x, params["wv"]), (B, S, K, hd))
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
    logits = logits.masked_fill(replicate_like(logits, ~m[None, None]),
                                NEG_INF)
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
    o = flash(q, k, v, causal=kind != "bidir", scale=scale,
              window=cfg.window if kind == "window" else 0)
    return layers.linear(merge_heads(o, (B, S, cfg.n_heads * cfg.head_dim)),
                         params["wo"])


def flash(q, k, v, *, causal: bool, scale: float, window: int = 0):
    """`gqa_flash_attention_kv` on plain tensors; on DTensors the same
    call on each rank's local shards (`on_local_shards`), so the kernel
    runs on the card under a DTensor as without one.  The batch goes over
    the data axes; the heads over 'model' in whole heads and whole GQA
    groups: q and k/v sharded as they are where K divides by the model
    axis, else K/V first repeated to lcm(K, model) heads (each q head
    keeps its K/V head) where that divides H, else every head stays on
    every rank of the model axis (the reference's merged head dims shard
    mid-head, and GSPMD regathers them; here the heads are made whole
    first)."""
    if not is_dtensor(q):
        return flash_ops.gqa_flash_attention_kv(q, k, v, causal=causal,
                                                scale=scale, window=window)
    from repro_torch.launch.mesh import axis_sizes
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    m = axis_sizes(q.device_mesh).get("model", 1)
    heads = H % m == 0 and m > 1
    if heads and K % m:
        kk = math.lcm(K, m)
        if H % kk:
            heads = False
        else:
            k = k.repeat_interleave(kk // K, dim=2)
            v = v.repeat_interleave(kk // K, dim=2)
    pl = batch_heads_placements(q.device_mesh, B, 2 if heads else None)

    def local(ql, kl, vl):
        return flash_ops.gqa_flash_attention_kv(ql, kl, vl, causal=causal,
                                                scale=scale, window=window)
    return on_local_shards(local, (q, k, v), (pl, pl, pl), pl)


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder / VLM image layers)
# ---------------------------------------------------------------------------

def cross_attention(params, x, memory, cfg: AttnCfg):
    """x: (B,Sq,D) queries; memory: (B,Skv,D) or precomputed (k, v), each
    (B,Skv,K,hd). Returns (B,Sq,D)."""
    B, Sq, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = split_heads(layers.linear(x, params["wq"]), (B, Sq, H, hd))
    if isinstance(memory, tuple):
        k, v = memory
    else:
        Skv = memory.shape[1]
        k = split_heads(layers.linear(memory, params["wk"]), (B, Skv, K, hd))
        v = split_heads(layers.linear(memory, params["wv"]), (B, Skv, K, hd))
    scale = cfg.softmax_scale or hd ** -0.5
    if Sq <= DECODE_MAX_Q and is_dtensor(q):
        # on each rank's rows, every head and key whole
        pl = batch_heads_placements(q.device_mesh, B)
        o = on_local_shards(lambda ql, kl, vl: attend(
            ql, _expand_kv(kl, H), _expand_kv(vl, H), "bidir", 0, scale),
            (q, k, v), (pl, pl, pl), pl)
    elif Sq <= DECODE_MAX_Q:
        o = attend(q, _expand_kv(k, H), _expand_kv(v, H), "bidir", 0, scale)
    else:
        o = flash(q, k, v, causal=False, scale=scale)
    return layers.linear(merge_heads(o, (B, Sq, H * hd)), params["wo"])


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
    q = split_heads(layers.linear(x, params["wq"]), (B, 1, H, hd))
    k_new = split_heads(layers.linear(x, params["wk"]), (B, 1, K, hd))
    v_new = split_heads(layers.linear(x, params["wv"]), (B, 1, K, hd))
    if cfg.qk_norm:
        q = layers.l2norm(q) * params["q_norm"]
        k_new = layers.l2norm(k_new) * params["k_norm"]
    pos = torch.full((1,), position, dtype=torch.int32, device=x.device)
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, pos, cfg.rope_theta)

    S = cache_k.shape[1]
    scale = cfg.softmax_scale or hd ** -0.5
    rep = H // K

    def attend(ql, kl, vl, ckl, cvl):
        return _attend_cache(ql.reshape(ql.shape[0], K, rep, hd), kl, vl, ckl,
                             cvl, position, window, scale)
    if not is_dtensor(q):
        ctx = attend(q, k_new, v_new, cache_k, cache_v)
        out = layers.linear(ctx.reshape(B, 1, H * hd), params["wo"])
        return out, k_new, v_new
    args = (q, k_new, v_new, cache_k, cache_v)
    pl = tuple(q.placements)
    if all(tuple(t.placements) == pl for t in args) and all(
            p.is_replicate() or p.is_shard(0) for p in pl):
        # each rank holds whole sequences and heads of its batch rows: the
        # plain tensors' path on them
        ctx = on_local_shards(attend, args, (pl,) * 5, pl)
        out = layers.linear(merge_heads(ctx, (B, 1, H * hd)), params["wo"])
        return out, k_new, v_new
    qg = split_heads(q.reshape(B, 1, H * hd), (B, 1, K, rep * hd)).reshape(
        B, 1, K, rep, hd)
    logits = torch.einsum("bokrd,bskd->bkrs", qg, cache_k).float() * scale
    new_logit = torch.einsum("bokrd,bokd->bkro", qg, k_new).float() * scale
    # on a sequence-sharded DTensor cache (flash-decoding) each rank
    # scores its part of the cache and the softmax reduces across ranks
    ki = replicate_like(logits, torch.arange(S, device=x.device))
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
    out = layers.linear(merge_heads(ctx, (B, 1, H * hd)), params["wo"])
    return out, k_new, v_new


def _attend_cache(qg, k_new, v_new, cache_k, cache_v, position: int,
                  window: int, scale: float):
    """`decode_attend`'s attention on plain tensors: qg (B, K, rep, hd)
    against the cache's valid entries and the new k/v (B, 1, K, hd) ->
    (B, K, rep, hd).  The cache is read as it lies, (B, S, K * hd): each
    product is one batched GEMM over the whole row, with the queries
    block-diagonal in the kv heads (head group k's rows zero outside kv
    head k's hd columns; K times the products of a per-head GEMM, which a
    decode step has to spare), where the einsum over (b, k) copied each
    layer's cache into a (b, k)-major layout first (at 128 sequences of
    mixtral-8x22b's ring, 1.07 GB a layer).  The softmax's f32 work is done
    in place; the sums are the einsum path's, in another order."""
    B, K, rep, hd = qg.shape
    S = cache_k.shape[1]
    eye = torch.eye(K, dtype=qg.dtype, device=qg.device)
    qd = (qg[:, :, :, None, :] * eye[:, None, :, None]).reshape(
        B, K * rep, K * hd)
    logits = torch.bmm(qd, cache_k.reshape(B, S, K * hd).transpose(1, 2))
    logits = logits.float().mul_(scale)                       # (B, K rep, S)
    new_logit = torch.einsum("bkrd,bokd->bkro", qg, k_new).float() * scale
    new_logit = new_logit.reshape(B, K * rep, 1)
    ki = torch.arange(S, device=qg.device)
    valid = ki < position
    if window:
        valid &= ki >= position - window
    logits.masked_fill_(~valid, NEG_INF)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), new_logit)
    p = logits.sub_(m).exp_()
    p_new = torch.exp(new_logit - m)
    denom = p.sum(dim=-1, keepdim=True) + p_new
    full = torch.bmm(p.div_(denom).to(qg.dtype),
                     cache_v.reshape(B, S, K * hd))       # (B, K rep, K hd)
    ctx = torch.diagonal(full.view(B, K, rep, K, hd), dim1=1, dim2=3)
    return (ctx.permute(0, 3, 1, 2)
            + (p_new / denom).to(qg.dtype).view(B, K, rep, 1)
            * v_new.reshape(B, K, 1, hd))
