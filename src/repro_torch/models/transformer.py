"""Block assembly (port of `repro/models/transformer.py`).

A block = (mixer, ffn) pair from the config pattern.  The reference stacks
each pattern position's parameters over the super-blocks and runs them with
`jax.lax.scan`; here the stack's `supers` is a list with one entry per
super-block (a dict of per-position block parameters), walked in a Python
loop.  `cfg.remat` wraps each super-block in `torch.utils.checkpoint`
(non-reentrant) where autograd records: "full" saves nothing inside it,
"block" keeps the products with no batch dims (`layers.linear`, as
`dots_with_no_batch_dims_saveable`), "collectives" only the block outputs
the reference names `mixer_out` / `ffn_out` (`checkpoint_name`), "none"
applies none; the kept outputs are handed back in the re-forward by a
`layers.RematStore`.  In the re-forward the attention and SSD kernels run
again.  `cfg.seq_shard` constrains the residual stream to ("data",
"model", None) at the reference's three places (`constrain` of
`sharding.context`; identity outside a sharding context).
Covered: mixers 'A'/'G' (causal attention), 'W'/'L' (sliding-window /
local attention; a ring-buffer decode cache of min(seq, window)), 'B'
(bidirectional attention, the encoder's), 'C' (causal self-attention, then
cross attention to a memory: the encoder's output or the image embeddings)
and 'M' (Mamba2), FFNs 'D' (dense SwiGLU or GELU), 'E' (mixture of experts)
and 'N' (none), leading dense blocks (`first_k_dense`), and a stack of
another pattern and depth (the encoder's).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mamba, moe
from repro_torch.models.layers import init_rmsnorm, rmsnorm
from repro_torch.sharding.context import (constrain, is_dtensor,
                                          on_local_shards, replicate_like)

MIXER_KIND = {"A": "causal", "G": "causal", "W": "window", "L": "window",
              "B": "bidir", "C": "causal"}
MIXERS = tuple(MIXER_KIND) + ("M",)
FFNS = ("D", "E", "N")


def check_block(mixer: str, ffn: str) -> None:
    if mixer not in MIXERS or ffn not in FFNS:
        raise ValueError(f"block ({mixer!r}, {ffn!r}): mixers are {MIXERS}, "
                         f"FFNs {FFNS}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, mixer: str, ffn: str):
    """(params, roles) of one block."""
    check_block(mixer, ffn)
    params, roles = {}, {}

    def put(name, pr):
        params[name], roles[name] = pr

    put("ln1", init_rmsnorm(cfg.d_model, gen.device))
    if mixer == "M":
        put("mixer", mamba.init_mamba(gen, cfg.d_model, cfg.ssm))
    else:
        put("mixer", attn_mod.init_attention(gen, cfg.d_model, cfg.attn))
    if mixer == "C":
        put("xattn", attn_mod.init_attention(gen, cfg.d_model, cfg.attn))
        put("ln_x", init_rmsnorm(cfg.d_model, gen.device))
    if ffn == "D":
        put("ln2", init_rmsnorm(cfg.d_model, gen.device))
        put("ffn", layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.swiglu))
    elif ffn == "E":
        put("ln2", init_rmsnorm(cfg.d_model, gen.device))
        put("ffn", moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.swiglu))
    return params, roles


def apply_block(params, x, cfg: ModelConfig, mixer: str, ffn: str,
                memory=None, positions=None):
    """x: (B,S,D); memory: (B,S_kv,D) for 'C' blocks (without it a 'C'
    block is its self-attention alone, as in the reference). Returns (x,
    aux); aux holds the MoE block's lb_loss."""
    check_block(mixer, ffn)
    seq_spec = ("data", "model", None)
    aux = {}
    if cfg.seq_shard:
        x = constrain(x, seq_spec)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer == "M":
        out = mamba.mamba_block(params["mixer"], h, cfg.ssm, cfg.d_model)
    else:
        out = attn_mod.self_attention(params["mixer"], h, cfg.attn,
                                      MIXER_KIND[mixer], positions)
    x = x + checkpoint_name(out, "mixer_out")
    if mixer == "C" and memory is not None:
        h = rmsnorm(params["ln_x"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attention(params["xattn"], h, memory, cfg.attn)
    if cfg.seq_shard:
        x = constrain(x, seq_spec)
    if ffn == "D":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        out = layers.mlp(params["ffn"], h, cfg.swiglu)
        x = x + checkpoint_name(out, "ffn_out")
    elif ffn == "E":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        out, moe_aux = moe.moe_ffn(params["ffn"], h, cfg.moe, cfg.swiglu)
        x = x + checkpoint_name(out, "ffn_out")
        aux["lb_loss"] = moe_aux["lb_loss"]
    if cfg.seq_shard:
        x = constrain(x, seq_spec)
    return x, aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def init_stack(gen, cfg: ModelConfig, pattern=None, n_super=None,
               first_k_dense=None):
    """(params, roles) of the decoder's stack, or (pattern, n_super,
    first_k_dense given) the encoder's.  Roles mirror params: a list per
    leading dense block and per super-block (the reference's roles carry a
    leading "layers" dim instead, for its stacked leaves;
    `sharding.policies.stack` folds the one into the other)."""
    pattern = cfg.pattern if pattern is None else pattern
    n_super = cfg.n_super if n_super is None else n_super
    first_k = cfg.first_k_dense if first_k_dense is None else first_k_dense
    first = [init_block(gen, cfg, pattern[0][0], "D")
             for _ in range(first_k)]
    supers = [[(str(i), init_block(gen, cfg, mx, ff))
               for i, (mx, ff) in enumerate(pattern)]
              for _ in range(n_super)]
    params = {"first": [p for p, _ in first],
              "supers": [{k: p for k, (p, _) in s} for s in supers]}
    roles = {"first": [r for _, r in first],
             "supers": [{k: r for k, (_, r) in s} for s in supers]}
    return params, roles


def apply_stack(params, x, cfg: ModelConfig, pattern=None, memory=None,
                positions=None):
    """Returns (x, {"lb_loss": the super-blocks' MoE losses summed}), as the
    reference (its leading dense blocks add nothing).  `memory` goes to
    every 'C' block's cross attention."""
    pattern = cfg.pattern if pattern is None else pattern
    for p in params["first"]:
        x, _ = apply_block(p, x, cfg, pattern[0][0], "D", memory, positions)
    lb_loss = replicate_like(x, torch.zeros((), device=x.device))

    def super_block(block_params, x, lb_loss, memory):
        for i, (mx, ff) in enumerate(pattern):
            x, aux = apply_block(block_params[str(i)], x, cfg, mx, ff,
                                 memory, positions)
            if "lb_loss" in aux:
                lb_loss = lb_loss + aux["lb_loss"]
        return x, lb_loss

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for block_params in params["supers"]:
        if remat:
            x, lb_loss = checkpoint(
                functools.partial(_remat_store(cfg.remat).run, super_block),
                block_params, x, lb_loss, memory, use_reentrant=False)
        else:
            x, lb_loss = super_block(block_params, x, lb_loss, memory)
    return x, {"lb_loss": lb_loss}


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "block", "collectives")
CHECKPOINT_NAMES = ("mixer_out", "ffn_out")


class _Named(torch.autograd.Function):
    """x, kept by the store of remat "collectives" (its gradient is g)."""

    @staticmethod
    def forward(ctx, x, store):
        return store.take(x.clone)

    @staticmethod
    def backward(ctx, g):
        return g, None


def checkpoint_name(x, name: str):
    """x, marked `name` (the reference's `jax.ad_checkpoint.checkpoint_name`
    of `CHECKPOINT_NAMES`): under remat "collectives" the output the
    re-forward takes back (`layers.RematStore`), else x as it is."""
    st = layers.remat_store("collectives")
    return x if st is None else _Named.apply(x, st)


def _remat_store(mode: str):
    """A new store for one super-block's checkpoint under a remat mode."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r}: one of {REMAT_MODES}")
    return layers.RematStore(mode)


# ---------------------------------------------------------------------------
# Decode stacks (single-token, with caches)
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    K, hd = cfg.attn.n_kv, cfg.attn.head_dim
    return {"k": torch.zeros((batch, seq, K, hd), dtype=layers.DTYPE,
                             device=device),
            "v": torch.zeros((batch, seq, K, hd), dtype=layers.DTYPE,
                             device=device)}


def _block_cache(cfg: ModelConfig, mixer: str, batch: int, seq: int, device,
                 memory_len: int = 0):
    if mixer == "M":
        return mamba.init_decode_state(batch, cfg.d_model, cfg.ssm, device)
    if _windowed(cfg, mixer):
        seq = min(seq, cfg.attn.window)
    cache = _attn_cache(cfg, batch, seq, device)
    if mixer == "C" and memory_len:
        x = _attn_cache(cfg, batch, memory_len, device)
        cache["xk"], cache["xv"] = x["k"], x["v"]
    return cache


def _windowed(cfg: ModelConfig, mixer: str) -> bool:
    return mixer in ("W", "L") and bool(cfg.attn.window)


def init_caches(cfg: ModelConfig, batch: int, seq: int, device,
                memory_len: int = 0) -> dict:
    """Cache tree for one decoder stack, laid out as the parameters.  With
    `memory_len`, each 'C' block also holds a cross-attention K/V cache
    `xk`/`xv` of memory_len entries, zeros, as the reference's (nothing in
    the reference's serving path fills it; ROADMAP.md, queue 3)."""
    for mx, ff in cfg.pattern:
        check_block(mx, ff)
    first = [_attn_cache(cfg, batch, seq, device)
             for _ in range(cfg.first_k_dense)]
    supers = [{str(i): _block_cache(cfg, mx, batch, seq, device, memory_len)
               for i, (mx, _) in enumerate(cfg.pattern)}
              for _ in range(cfg.n_super)]
    return {"first": first, "supers": supers}


def _write_slot(cache, wpos: int, new) -> None:
    """cache[:, wpos] = new[:, 0] in place.  A DTensor cache sharded over
    its sequence dim 1 is written by the rank that holds slot wpos, into
    its local shard (the batch split as the cache's)."""
    if not is_dtensor(cache):
        cache[:, wpos] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    pl = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    local_new = new.redistribute(mesh, pl).to_local()
    seq_dims = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    n_loc = cache.to_local().shape[1]
    block = 0
    for i in seq_dims:              # major to minor, in mesh order
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    lo = block * n_loc
    if lo <= wpos < lo + n_loc:
        cache.to_local()[:, wpos - lo] = local_new[:, 0].to(cache.dtype)


def _decode_attn_block(params, x, cache, position: int, cfg: ModelConfig,
                       mixer: str):
    """Writes the new K/V into the cache in place (the reference returns an
    updated copy).  Windowed mixers keep a ring buffer of min(seq, window)
    entries: the new entry goes to position % S, every live entry is inside
    the window by construction, so the mask only needs the fill count
    min(position, S).  Like the reference's dynamic_update_slice, a
    position past a full cache's end writes its last slot.  A 'C' block
    with a cross cache then attends to it (dense: one query)."""
    S = cache["k"].shape[1]
    windowed = _windowed(cfg, mixer)
    out, k_new, v_new = attn_mod.decode_attend(
        params["mixer"], rmsnorm(params["ln1"], x, cfg.norm_eps),
        cache["k"], cache["v"], min(position, S) if windowed else position,
        cfg.attn, window=0)
    wpos = position % S if windowed else min(position, S - 1)
    _write_slot(cache["k"], wpos, k_new)
    _write_slot(cache["v"], wpos, v_new)
    x = x + out
    if mixer == "C" and "xk" in cache:
        h = rmsnorm(params["ln_x"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attention(params["xattn"], h,
                                         (cache["xk"], cache["xv"]), cfg.attn)
    return x, cache


def decode_block(params, x, cache, position: int, cfg: ModelConfig, mixer,
                 ffn):
    check_block(mixer, ffn)
    if mixer == "M":
        h = rmsnorm(params["ln1"], x, cfg.norm_eps)
        out, cache = mamba.mamba_decode_step(params["mixer"], h, cache,
                                             cfg.ssm, cfg.d_model)
        x = x + out
    else:
        x, cache = _decode_attn_block(params, x, cache, position, cfg, mixer)
    if ffn == "D":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(params["ffn"], h, cfg.swiglu)
    elif ffn == "E":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        x = x + moe.moe_ffn(params["ffn"], h, cfg.moe, cfg.swiglu)[0]
    return x, cache


def decode_stack(params, x, caches, position: int, cfg: ModelConfig):
    """Single-token decode through the stack; returns (x, caches) with the
    caches updated (attention caches in place)."""
    first = []
    for p, c in zip(params["first"], caches["first"]):
        x, c = decode_block(p, x, c, position, cfg, cfg.pattern[0][0], "D")
        first.append(c)
    supers = []
    for block_params, block_caches in zip(params["supers"],
                                          caches["supers"]):
        new = {}
        for i, (mx, ff) in enumerate(cfg.pattern):
            x, new[str(i)] = decode_block(block_params[str(i)], x,
                                          block_caches[str(i)], position, cfg,
                                          mx, ff)
        supers.append(new)
    return x, {"first": first, "supers": supers}
