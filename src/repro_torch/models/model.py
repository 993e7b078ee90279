"""Unified model API (port of `repro/models/model.py`).

build_model(cfg, device) -> Model with:
  init(seed)                          -> (params, roles), drawn on the
                                         model's device
  apply(params, batch)                -> (hidden (B,S,D), aux)    [prefill]
  logits(params, hidden)              -> (.., V_padded)
  decode_step(params, token, caches, position) -> (logits (B,1,V), caches)
  init_caches(batch, seq)             -> cache tree
  input_specs(shape)                  -> the entry point's batch as meta
                                         tensors (no allocation)
and count_params(cfg, active_only), model_flops(cfg, shape) and
abstract_init(model) -> (shapes, roles) beside it.

Batch layout: {"tokens": (B, S) int}, plus per family the stubbed
frontend's output, as the reference's: encdec `enc_frames` (B, S_enc, D)
frame embeddings (the encoder's input), vlm `img_embed` (B, n_img, D)
patch embeddings (the cross attention's memory as they are), read from
whatever batch `apply` is given (in training, each microbatch's rows), and
differentiated with the rest of the model.  `device`
is where init and init_caches allocate; it defaults to the card and does
not drop to the CPU.  Every function takes DTensor params and batches
(`sharding/`) as well as plain tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.models import layers, mamba, transformer
from repro_torch.models.layers import DTYPE
from repro_torch.sharding.context import replicate_like

ENCODER_PATTERN = (("B", "D"),)


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable
    apply: Callable
    logits: Callable
    decode_step: Callable
    init_caches: Callable
    input_specs: Callable


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                ) -> Model:
    return _build_on(cfg, resolve_device(device))


def _build_on(cfg: ModelConfig, dev: torch.device) -> Model:
    for mx, ff in cfg.pattern:
        transformer.check_block(mx, ff)
    V = cfg.padded_vocab
    emb_scale = torch.tensor(cfg.d_model ** 0.5, dtype=DTYPE, device=dev)

    def init(seed: int = 0):
        """(params, roles), drawn from `seed` on the model's device."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params, roles = {}, {}

        def put(name, pr):
            params[name], roles[name] = pr

        put("embed", layers.init_embedding(gen, V, cfg.d_model))
        put("decoder", transformer.init_stack(gen, cfg))
        put("ln_f", layers.init_rmsnorm(cfg.d_model, dev))
        if not cfg.tie_embeddings:
            put("head", layers.init_lm_head(gen, cfg.d_model, V))
        if cfg.encoder is not None:
            put("encoder", transformer.init_stack(
                gen, cfg, pattern=ENCODER_PATTERN,
                n_super=cfg.encoder.n_layers, first_k_dense=0))
            put("ln_enc", layers.init_rmsnorm(cfg.d_model, dev))
        return params, roles

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
        x = x * replicate_like(x, emb_scale)
        x, aux = transformer.apply_stack(params["decoder"], x, cfg,
                                         memory=memory(params, batch))
        return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux

    def logits(params, hidden):
        if cfg.tie_embeddings:
            return layers.linear(hidden, params["embed"]["table"].T)
        return layers.linear(hidden, params["head"]["w"])

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
        x = x * replicate_like(x, emb_scale)
        x, caches = transformer.decode_stack(params["decoder"], x, caches,
                                             int(position), cfg)
        h = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits(params, h), caches

    def input_specs(shape: ShapeCfg) -> dict:
        """Meta-tensor stand-ins for the entry point's batch (no
        allocation), as the reference's: train/prefill tokens and labels
        (an encoder's decoder text of dec_seq tokens over S frames, image
        embeddings beside a VLM's tokens), decode one token, its position
        and caches of S entries."""
        return _input_specs(cfg, shape)

    return Model(cfg, dev, init, apply, logits, decode_step, init_caches,
                 input_specs)


def _input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.encoder is not None:
            return {"tokens": meta((B, cfg.encoder.dec_seq), i32),
                    "enc_frames": meta((B, S, cfg.d_model), DTYPE),
                    "labels": meta((B, cfg.encoder.dec_seq), i32)}
        batch = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        if cfg.n_img_tokens:
            batch["img_embed"] = meta((B, cfg.n_img_tokens, cfg.d_model),
                                      DTYPE)
        return batch
    caches = _build_on(cfg, torch.device("meta")).init_caches(B, S)
    return {"token": meta((B, 1), i32), "position": meta((), i32),
            "caches": caches}


def abstract_init(model: Model):
    """(shapes, roles) without allocating anything: `model.init` traced
    under a `FakeTensorMode` (the random draws make no storage), every
    leaf of `shapes` returned as a tensor on the meta device (`.shape`,
    `.dtype`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake, roles = _build_on(model.cfg, torch.device("cpu")).init(0)

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake), roles


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
