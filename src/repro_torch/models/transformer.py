"""Block assembly (port of `repro/models/transformer.py`).

A block = (mixer, ffn) pair from the config pattern.  The reference stacks
each pattern position's parameters over the super-blocks and runs them with
`jax.lax.scan`; here the stack's `supers` is a list with one entry per
super-block (a dict of per-position block parameters), walked in a Python
loop.  Remat, `checkpoint_name` and the sequence-sharding `constrain` of the
reference are training and sharding concerns and have no counterpart.
Covered: mixers 'A' (causal attention) and 'M' (Mamba2), FFNs 'D' (dense
SwiGLU) and 'N' (none); the others raise (ROADMAP.md, queue 1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mamba
from repro_torch.models.layers import init_rmsnorm, rmsnorm

MIXER_KIND = {"A": "causal", "G": "causal", "W": "window", "L": "window",
              "B": "bidir", "C": "causal"}
PORTED_MIXERS = ("A", "M")
PORTED_FFNS = ("D", "N")


def check_ported(mixer: str, ffn: str) -> None:
    if mixer not in PORTED_MIXERS or ffn not in PORTED_FFNS:
        raise NotImplementedError(
            f"repro_torch: block ({mixer!r}, {ffn!r}) is not ported yet (mixers"
            f" {PORTED_MIXERS}, FFNs {PORTED_FFNS}); see ROADMAP.md queue 1 "
            f"item 11")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    check_ported(mixer, ffn)
    params = {"ln1": init_rmsnorm(cfg.d_model, gen.device)}
    if mixer == "M":
        params["mixer"] = mamba.init_mamba(gen, cfg.d_model, cfg.ssm)
    else:
        params["mixer"] = attn_mod.init_attention(gen, cfg.d_model, cfg.attn)
    if ffn == "D":
        params["ln2"] = init_rmsnorm(cfg.d_model, gen.device)
        params["ffn"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                        cfg.swiglu)
    return params


def apply_block(params, x, cfg: ModelConfig, mixer: str, ffn: str,
                positions=None):
    """x: (B,S,D). Returns (x, aux)."""
    check_ported(mixer, ffn)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mixer == "M":
        out = mamba.mamba_block(params["mixer"], h, cfg.ssm, cfg.d_model)
    else:
        out = attn_mod.self_attention(params["mixer"], h, cfg.attn,
                                      MIXER_KIND[mixer], positions)
    x = x + out
    if ffn == "D":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(params["ffn"], h, cfg.swiglu)
    return x, {}


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def init_stack(gen, cfg: ModelConfig) -> dict:
    first = [init_block(gen, cfg, cfg.pattern[0][0], "D")
             for _ in range(cfg.first_k_dense)]
    supers = [{str(i): init_block(gen, cfg, mx, ff)
               for i, (mx, ff) in enumerate(cfg.pattern)}
              for _ in range(cfg.n_super)]
    return {"first": first, "supers": supers}


def apply_stack(params, x, cfg: ModelConfig, positions=None):
    for p in params["first"]:
        x, _ = apply_block(p, x, cfg, cfg.pattern[0][0], "D", positions)
    for block_params in params["supers"]:
        for i, (mx, ff) in enumerate(cfg.pattern):
            x, _ = apply_block(block_params[str(i)], x, cfg, mx, ff,
                               positions)
    # no MoE block is ported, so the load-balance loss is always 0
    return x, {"lb_loss": torch.zeros((), device=x.device)}


# ---------------------------------------------------------------------------
# Decode stacks (single-token, with caches)
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    K, hd = cfg.attn.n_kv, cfg.attn.head_dim
    return {"k": torch.zeros((batch, seq, K, hd), dtype=layers.DTYPE,
                             device=device),
            "v": torch.zeros((batch, seq, K, hd), dtype=layers.DTYPE,
                             device=device)}


def _block_cache(cfg: ModelConfig, mixer: str, batch: int, seq: int, device):
    if mixer == "M":
        return mamba.init_decode_state(batch, cfg.d_model, cfg.ssm, device)
    return _attn_cache(cfg, batch, seq, device)


def init_caches(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """Cache tree for one decoder stack, laid out as the parameters."""
    for mx, ff in cfg.pattern:
        check_ported(mx, ff)
    first = [_attn_cache(cfg, batch, seq, device)
             for _ in range(cfg.first_k_dense)]
    supers = [{str(i): _block_cache(cfg, mx, batch, seq, device)
               for i, (mx, _) in enumerate(cfg.pattern)}
              for _ in range(cfg.n_super)]
    return {"first": first, "supers": supers}


def _decode_attn_block(params, x, cache, position: int, cfg: ModelConfig):
    """Writes the new K/V into the cache in place (the reference returns an
    updated copy).  Like the reference's dynamic_update_slice, a position
    past the cache's end writes its last slot."""
    out, k_new, v_new = attn_mod.decode_attend(
        params["mixer"], rmsnorm(params["ln1"], x, cfg.norm_eps),
        cache["k"], cache["v"], position, cfg.attn)
    wpos = min(position, cache["k"].shape[1] - 1)
    cache["k"][:, wpos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, wpos] = v_new[:, 0].to(cache["v"].dtype)
    return x + out, cache


def decode_block(params, x, cache, position: int, cfg: ModelConfig, mixer,
                 ffn):
    check_ported(mixer, ffn)
    if mixer == "M":
        h = rmsnorm(params["ln1"], x, cfg.norm_eps)
        out, cache = mamba.mamba_decode_step(params["mixer"], h, cache,
                                             cfg.ssm, cfg.d_model)
        x = x + out
    else:
        x, cache = _decode_attn_block(params, x, cache, position, cfg)
    if ffn == "D":
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(params["ffn"], h, cfg.swiglu)
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
