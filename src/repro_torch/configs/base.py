"""Architecture config system (copy of `repro/configs/base.py`; the port
imports nothing of the JAX package).

Every architecture is a `ModelConfig` built from composable parts: GQA
attention (full / sliding-window / local:global), SwiGLU or MoE FFNs,
Mamba2-SSD mixers (pure or hybrid interleave), optional encoder stack
(enc-dec) and cross-attention layers (VLM).  Layers are grouped into a
repeating *super-block* `pattern` (a tuple of (mixer, ffn) kind pairs); the
stack applies `n_layers / len(pattern)` super-blocks.

Mixer kinds: 'A' causal full attention | 'W' sliding-window attention |
             'L' local attention (window) | 'G' global full attention |
             'M' Mamba2 SSD | 'C' cross-attention (+causal self) |
             'B' bidirectional attention (encoder)
FFN kinds:   'D' dense SwiGLU | 'E' mixture-of-experts | 'N' none
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    window: int = 4096          # used by 'W' (SWA) and 'L' (local) mixers
    rope_theta: float = 1e4
    softmax_scale: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_routed: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_pre_softmax: bool = False   # deepseek-style: softmax over all, then top-k
    dispatch_groups: int = 1           # shard-local dispatch: set to the data-
                                       # parallel degree so routing/capacity are
                                       # computed per data shard (no global
                                       # gather of the dispatch buffers)
    prefer_tp: bool = False            # force TP-in-expert even when the expert
                                       # count divides the model axis (fine-
                                       # grained experts: no token exchange)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    """Auxiliary encoder stack (whisper). The modality frontend is a stub:
    input_specs() supplies precomputed frame embeddings (B, S_enc, d_model)."""
    n_layers: int = 32
    seq_frac: float = 1.0       # encoder seq = seq_frac * shape.seq
    dec_seq: int = 448          # decoder text length for train/prefill shapes


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnCfg
    pattern: tuple = (("A", "D"),)
    first_k_dense: int = 0      # leading layers forced to dense FFN (deepseek)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    encoder: Optional[EncoderCfg] = None
    n_img_tokens: int = 0
    norm_eps: float = 1e-6
    vocab_pad_to: int = 128
    tie_embeddings: bool = False
    swiglu: bool = True
    seq_shard: bool = False     # constrain the residual stream to
                                # ("data", "model", None) on a mesh
    source: str = ""
    long_context_ok: bool = False
    skip_decode: bool = False
    remat: str = "block"        # none | full | block | collectives
                                # (models/transformer.py)

    @property
    def padded_vocab(self) -> int:
        pad = self.vocab_pad_to
        return (self.vocab + pad - 1) // pad * pad

    @property
    def n_super(self) -> int:
        n = self.n_layers - self.first_k_dense
        if n % len(self.pattern):
            raise ValueError(f"{self.name}: {n} layers do not split into "
                             f"super-blocks of {len(self.pattern)}")
        return n // len(self.pattern)

    def param_count(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq: int
    global_batch: int
    kind: str       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# smoke-test shapes (reduced)
SMOKE_SHAPE = ShapeCfg("smoke", 128, 2, "train")


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason recorded when skipped."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, "pure full attention: 500k decode needs sub-quadratic attention"
    if shape.kind == "decode" and cfg.skip_decode:
        return False, "encoder-only: no decode step"
    return True, ""
