"""Unified model API (port of `repro/models/model.py`).

build_model(cfg, device) -> Model with:
  init(seed)                          -> params, drawn on the model's device
  apply(params, batch)                -> (hidden (B,S,D), aux)    [prefill]
  logits(params, hidden)              -> (.., V_padded)
  decode_step(params, token, caches, position) -> (logits (B,1,V), caches)
  init_caches(batch, seq)             -> cache tree
and count_params(cfg, active_only), model_flops(cfg, shape) and
abstract_init(model) beside it.

Batch layout: {"tokens": (B, S) int}, plus per family the stubbed
frontend's output, as the reference's: encdec `enc_frames` (B, S_enc, D)
frame embeddings (the encoder's input), vlm `img_embed` (B, n_img, D)
patch embeddings (the cross attention's memory as they are).  The
reference's `input_specs` (a dry-run helper) has no counterpart.  `device`
is where init and init_caches allocate; it defaults to the card and does
not drop to the CPU.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.models import layers, mamba, transformer
from repro_torch.models.layers import DTYPE

ENCODER_PATTERN = (("B", "D"),)


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
    return _build_on(cfg, resolve_device(device))


def _build_on(cfg: ModelConfig, dev: torch.device) -> Model:
    for mx, ff in cfg.pattern:
        transformer.check_block(mx, ff)
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
        if cfg.encoder is not None:
            params["encoder"] = transformer.init_stack(
                gen, cfg, pattern=ENCODER_PATTERN,
                n_super=cfg.encoder.n_layers, first_k_dense=0)
            params["ln_enc"] = layers.init_rmsnorm(cfg.d_model, dev)
        return params

    def memory(params, batch):
        """The cross attention's memory: the encoder's output after ln_enc,
        or the image embeddings in bf16; None for a decoder alone."""
        if cfg.encoder is not None:
            enc, _ = transformer.apply_stack(
                params["encoder"], batch["enc_frames"].to(DTYPE), cfg,
                pattern=ENCODER_PATTERN)
            return layers.rmsnorm(params["ln_enc"], enc, cfg.norm_eps)
        if cfg.n_img_tokens:
            return batch["img_embed"].to(DTYPE)
        return None

    def apply(params, batch):
        x = layers.embed(params["embed"], batch["tokens"]).to(DTYPE)
        x = x * emb_scale
        x, aux = transformer.apply_stack(params["decoder"], x, cfg,
                                         memory=memory(params, batch))
        return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux

    def logits(params, hidden):
        if cfg.tie_embeddings:
            return hidden @ params["embed"]["table"].T
        return hidden @ params["head"]["w"]

    def init_caches(batch: int, seq: int) -> dict:
        """With an encoder or image memory, each 'C' block also gets a zero
        cross cache of n_img_tokens entries (else seq), as the
        reference's."""
        mem_len = 0
        if cfg.encoder is not None or cfg.n_img_tokens:
            mem_len = cfg.n_img_tokens or seq
        return transformer.init_caches(cfg, batch, seq, dev,
                                       memory_len=mem_len)

    def decode_step(params, token, caches, position: int):
        """token: (B,1) int. Returns (logits (B,1,V), new caches)."""
        x = layers.embed(params["embed"], token).to(DTYPE)
        x = x * emb_scale
        x, caches = transformer.decode_stack(params["decoder"], x, caches,
                                             int(position), cfg)
        h = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits(params, h), caches

    return Model(cfg, dev, init, apply, logits, decode_step, init_caches)


def abstract_init(model: Model) -> dict:
    """The parameter tree's shapes and dtypes without allocating anything:
    `model.init` traced under a `FakeTensorMode` (the random draws make no
    storage), every leaf returned as a tensor on the meta device
    (`.shape`, `.dtype`).  The reference also returns each leaf's sharding
    role; the port's `init` builds none, so roles wait for the sharding
    slice (ROADMAP.md queue 1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = _build_on(model.cfg, torch.device("cpu")).init(0)

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake)


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
        if mixer == "C":            # the cross attention's projections
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
    top-k routed experts of each MoE block, not all of them).  The
    encoder's blocks count; the norms are counted as the reference's."""
    for mx, ff in cfg.pattern:
        transformer.check_block(mx, ff)
    n = cfg.padded_vocab * cfg.d_model          # embedding
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * cfg.d_model     # head
    n += cfg.first_k_dense * _block_params(cfg, cfg.pattern[0][0], "D",
                                           active_only)
    for mx, ff in cfg.pattern:
        n += cfg.n_super * _block_params(cfg, mx, ff, active_only)
    if cfg.encoder is not None:
        n += cfg.encoder.n_layers * _block_params(cfg, "B", "D", active_only)
    return n


def model_flops(cfg: ModelConfig, shape: ShapeCfg) -> float:
    """MODEL_FLOPS, as the reference's: 6 N D for training (N the active
    parameters, D the tokens), 2 N D for an inference step, plus the
    attention score and value products written out (a causal layer at S / 2
    average context, a windowed one at min(window, S))."""
    n_active = count_params(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        mult = 3.0
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        mult = 1.0
    else:  # decode: one token, but attention reads the full cache
        tokens = B
        flops = 2.0 * n_active * tokens
        mult = 1.0
    a = cfg.attn
    attn_layers = sum(1 for mx, _ in cfg.pattern if mx in "AGWLCB")
    n_attn = cfg.n_super * attn_layers + cfg.first_k_dense
    if cfg.encoder is not None and shape.kind != "decode":
        n_attn += cfg.encoder.n_layers
    hdim = a.n_heads * a.head_dim
    if shape.kind == "decode":
        flops += mult * n_attn * 4.0 * B * S * hdim
    else:
        per_layer = 0.0
        for mx, _ in cfg.pattern:
            if mx in ("W", "L"):
                ctx = min(a.window, S)
            elif mx in ("A", "G", "C", "B"):
                ctx = S / 2
            else:
                continue
            per_layer += 4.0 * B * S * ctx * hdim
        flops += mult * cfg.n_super * per_layer
    return flops
