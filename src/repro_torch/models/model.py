"""Unified model API (port of `repro/models/model.py`).

build_model(cfg, device) -> Model with:
  init(seed)                          -> params, drawn on the model's device
  apply(params, batch)                -> (hidden (B,S,D), aux)    [prefill]
  logits(params, hidden)              -> (.., V_padded)
  decode_step(params, token, caches, position) -> (logits (B,1,V), caches)
  init_caches(batch, seq)             -> cache tree
and count_params(cfg, active_only) beside it.

Batch layout: {"tokens": (B, S) int}.  Configs with an encoder or image
memory are not ported yet (ROADMAP.md, queue 1), nor is the
reference's `input_specs` (a dry-run helper).  `device` is where init and
init_caches allocate; it defaults to the card and does not drop to the CPU.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mamba, transformer
from repro_torch.models.layers import DTYPE


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    apply: Callable
    logits: Callable
    decode_step: Callable
    init_caches: Callable


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                ) -> Model:
    if cfg.encoder is not None or cfg.n_img_tokens:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs the encoder / image-memory "
            f"branch, which is not ported yet; see ROADMAP.md queue 1")
    for mx, ff in cfg.pattern:
        transformer.check_ported(mx, ff)
    dev = resolve_device(device)
    V = cfg.padded_vocab
    emb_scale = torch.tensor(cfg.d_model ** 0.5, dtype=DTYPE, device=dev)

    def init(seed: int = 0) -> dict:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"embed": layers.init_embedding(gen, V, cfg.d_model),
                  "decoder": transformer.init_stack(gen, cfg),
                  "ln_f": layers.init_rmsnorm(cfg.d_model, dev)}
        if not cfg.tie_embeddings:
            params["head"] = layers.init_lm_head(gen, cfg.d_model, V)
        return params

    def apply(params, batch):
        x = layers.embed(params["embed"], batch["tokens"]).to(DTYPE)
        x = x * emb_scale
        x, aux = transformer.apply_stack(params["decoder"], x, cfg)
        return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux

    def logits(params, hidden):
        if cfg.tie_embeddings:
            return hidden @ params["embed"]["table"].T
        return hidden @ params["head"]["w"]

    def init_caches(batch: int, seq: int) -> dict:
        return transformer.init_caches(cfg, batch, seq, dev)

    def decode_step(params, token, caches, position: int):
        """token: (B,1) int. Returns (logits (B,1,V), new caches)."""
        x = layers.embed(params["embed"], token).to(DTYPE)
        x = x * emb_scale
        x, caches = transformer.decode_stack(params["decoder"], x, caches,
                                             int(position), cfg)
        h = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits(params, h), caches

    return Model(cfg, dev, init, apply, logits, decode_step, init_caches)


# ---------------------------------------------------------------------------
# Parameter accounting (analytic, as the reference's)
# ---------------------------------------------------------------------------

def _block_params(cfg: ModelConfig, mixer: str, ffn: str,
                  active_only: bool = False) -> int:
    D = cfg.d_model
    n = 2 * D                       # ln1 + ln2-ish
    if mixer == "M":
        d_inner, H = mamba.dims(D, cfg.ssm)
        G, N = cfg.ssm.n_groups, cfg.ssm.d_state
        d_proj = 2 * d_inner + 2 * G * N + H
        n += D * d_proj + cfg.ssm.conv * (d_inner + 2 * G * N) + 3 * H \
            + d_inner + d_inner * D
    else:
        a = cfg.attn
        n += D * a.n_heads * a.head_dim * 2 + D * a.n_kv * a.head_dim * 2
    mult = 3 if cfg.swiglu else 2
    if ffn == "D":
        n += mult * D * cfg.d_ff
    elif ffn == "E":
        m = cfg.moe
        per_expert = mult * D * m.d_expert
        routed = (m.top_k if active_only else m.n_routed) * per_expert
        n += routed + m.n_shared * per_expert + D * m.n_routed
    return n


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the model; `active_only`: those one token meets (the
    top-k routed experts of each MoE block, not all of them)."""
    for mx, ff in cfg.pattern:
        transformer.check_ported(mx, ff)
    n = cfg.padded_vocab * cfg.d_model          # embedding
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * cfg.d_model     # head
    n += cfg.first_k_dense * _block_params(cfg, cfg.pattern[0][0], "D",
                                           active_only)
    for mx, ff in cfg.pattern:
        n += cfg.n_super * _block_params(cfg, mx, ff, active_only)
    return n
