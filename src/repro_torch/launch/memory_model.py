"""Analytic HBM-traffic model per (arch x shape): the memory term of the
roofline (port of `repro/launch/memory_model.py`; every expression in the
reference's order, so each result is `==` to the reference's as a Python
float).

The reference keeps this documented analytic model beside its dry run,
whose compiled byte counts overcount the stacked scan operands.

Traffic model (bytes, global, one step; bf16 params/activations, fp32
grad-accum + optimizer moments):

TRAIN, with `mb` gradient-accumulation microbatches:
  per microbatch:
    weights     : 3 reads (fwd, remat re-fwd, bwd)          6*N
    grad accum  : fp32 read+write                           8*N
  once:
    optimizer   : m,v read+write (16*N') + grads read (4*N) + params rw (4*N)
                  N' = N (fp32 moments) or N/2-ish int8
  activations   : kappa_act * T * d_model * 2 per layer (fwd+bwd+remat I/O
                  incl. norms, residuals, projections)
  attention     : flash KV re-reads: 3 * n_attn * B * (S/cq) * ctx * 2*Kv*hd * 2
  lm head       : logits chunks hit HBM: ~6 * T * V * 4
PREFILL: weights 2*N, activations kappa/3, attention KV 1x, last-token logits.
DECODE : weights 2*N_active + full KV-cache read (+1 slot write) + SSM state rw.

`CHUNK_Q` is the reference's query chunk (`repro.models.attention`, which
switches to chunked attention above 2048).  The port's attention takes the
flash kernel at every length, with query tiles of its own; the constant
stays the reference's, so the model counts the same bytes on both sides.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.models.model import count_params

KAPPA_TRAIN = 45.0      # activation IO passes per layer (fwd+bwd+remat)
KAPPA_FWD = 15.0
CHUNK_Q = 512           # the reference's models.attention query chunk


def _attn_layers(cfg: ModelConfig) -> list[int]:
    """Effective attention context per attention layer instance."""
    ctxs = []
    for mx, _ in cfg.pattern:
        if mx in ("W", "L"):
            ctxs.append(-1)          # window
        elif mx in ("A", "G", "C", "B"):
            ctxs.append(0)           # full
    return ctxs


def memory_bytes(cfg: ModelConfig, shape: ShapeCfg, mb: int = 8,
                 quantized_opt: bool = False) -> float:
    N = count_params(cfg)
    Na = count_params(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq
    V = cfg.padded_vocab
    D = cfg.d_model
    Kv, hd = cfg.attn.n_kv, cfg.attn.head_dim
    L = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)

    if shape.kind == "decode":
        total = 2.0 * Na                           # weight reads (bf16)
        n_attn = (cfg.n_super * sum(1 for mx, _ in cfg.pattern
                                    if mx in "AGWLC") + cfg.first_k_dense)
        for mx, _ in cfg.pattern:
            if mx in ("W", "L") and cfg.attn.window:
                ctx = min(cfg.attn.window, S)
            elif mx in ("A", "G", "C"):
                ctx = S
            elif mx == "M":
                d_inner = cfg.ssm.expand * D
                H = d_inner // cfg.ssm.head_dim
                total += cfg.n_super * 2 * (B * H * cfg.ssm.d_state
                                            * cfg.ssm.head_dim * 4.0)
                continue
            else:
                continue
            total += cfg.n_super * B * ctx * 2 * Kv * hd * 2.0   # K+V read
        total += B * V * 4.0                        # logits
        return total

    T = B * S
    if cfg.encoder is not None:
        T = B * cfg.encoder.dec_seq
        T_enc = B * S
    else:
        T_enc = 0

    # attention KV re-read traffic (flash: K,V streamed per q-chunk)
    def kv_traffic(tokens, seq, passes):
        tr = 0.0
        for mx, _ in cfg.pattern:
            if mx in ("W", "L") and cfg.attn.window:
                ctx = min(cfg.attn.window + CHUNK_Q, seq)
            elif mx in ("A", "G", "C"):
                ctx = seq
            else:
                continue
            nq = max(seq // CHUNK_Q, 1)
            tr += cfg.n_super * (tokens / seq) * nq * ctx * 2 * Kv * hd * 2.0
        return tr * passes

    if shape.kind == "train":
        total = mb * (6.0 * N + 8.0 * N)
        opt_moment = 2.0 * N if quantized_opt else 8.0 * N
        total += 2 * opt_moment + 4.0 * N + 4.0 * N
        total += KAPPA_TRAIN * (T + T_enc) * D * 2.0 * L
        total += kv_traffic(T, min(S, 10**9), passes=3.0)
        total += 6.0 * T * V * 4.0
        return total

    # prefill
    total = 2.0 * N
    total += KAPPA_FWD * (T + T_enc) * D * 2.0 * L
    total += kv_traffic(T, S, passes=1.0)
    total += B * V * 4.0
    return total
