"""whisper-large-v3 [audio]: enc-dec, 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866. [arXiv:2212.04356; unverified]

The conv audio frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (B, S_enc, d_model). GELU MLPs (no SwiGLU).
20 heads do not divide the model axis: FSDP-fallback attention policy.
vocab padded 51866 -> 51968 (Megatron-style) for TP divisibility.
"""
from repro_torch.configs.base import AttnCfg, EncoderCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, d_ff=5120, vocab=51866,
    attn=AttnCfg(n_heads=20, n_kv=20, head_dim=64),
    pattern=(("C", "D"),),            # decoder: self + cross each layer
    encoder=EncoderCfg(n_layers=32, dec_seq=448),
    swiglu=False,
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=4, head_dim=16),
    pattern=(("C", "D"),),
    encoder=EncoderCfg(n_layers=2, dec_seq=16),
    swiglu=False, vocab_pad_to=16,
)
