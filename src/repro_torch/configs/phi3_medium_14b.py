"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.

RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]
40 heads / 10 kv heads do not divide the model axis (16): attention runs under
the FSDP fallback policy (weights sharded+gathered; MLP stays Megatron-TP).
"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, d_ff=17920, vocab=100352,
    attn=AttnCfg(n_heads=40, n_kv=10, head_dim=128),
    pattern=(("A", "D"),),
    source="[arXiv:2404.14219; unverified]",
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=80, d_ff=160, vocab=512,
    attn=AttnCfg(n_heads=5, n_kv=5, head_dim=16),
    pattern=(("A", "D"),), vocab_pad_to=16,
)
