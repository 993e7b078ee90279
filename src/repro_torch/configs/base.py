"""Architecture config system (copy of `repro/configs/base.py`; the port
imports nothing of the JAX package).

Every architecture is a `ModelConfig` built from composable parts: GQA
attention, SwiGLU FFNs, Mamba2-SSD mixers.  Layers are grouped into a
repeating *super-block* `pattern` (a tuple of (mixer, ffn) kind pairs); the
stack applies `n_layers / len(pattern)` super-blocks.

Mixer kinds: 'A' causal full attention | 'W' sliding-window attention |
             'L' local attention (window) | 'G' global full attention |
             'M' Mamba2 SSD | 'C' cross-attention (+causal self) |
             'B' bidirectional attention (encoder)
FFN kinds:   'D' dense SwiGLU | 'E' mixture-of-experts | 'N' none
The port's model code covers mixers 'A' and 'M' and FFNs 'D' and 'N' (see
ROADMAP.md for the rest); `MoECfg` and `EncoderCfg` are kept as plain
dataclasses so that the configs read the same.
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
    router_pre_softmax: bool = False
    dispatch_groups: int = 1
    prefer_tp: bool = False


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
    n_layers: int = 32
    seq_frac: float = 1.0
    dec_seq: int = 448


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
    first_k_dense: int = 0      # leading layers forced to dense FFN
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    encoder: Optional[EncoderCfg] = None
    n_img_tokens: int = 0
    norm_eps: float = 1e-6
    vocab_pad_to: int = 128
    tie_embeddings: bool = False
    swiglu: bool = True
    seq_shard: bool = False     # a sharding hint of the reference; unused here
    source: str = ""
    long_context_ok: bool = False
    skip_decode: bool = False
    remat: str = "block"        # a training hint of the reference; unused here

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
