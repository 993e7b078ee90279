"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers (every 5th layer).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB per the brief: input_specs() provides precomputed
patch embeddings (B, 1601, d_model) already projected to the text width.
"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, d_ff=14336, vocab=128256,
    attn=AttnCfg(n_heads=32, n_kv=8, head_dim=128, rope_theta=5e5),
    pattern=(("C", "D"),) + (("A", "D"),) * 4,   # 8 cross + 32 self layers
    n_img_tokens=1601,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16),
    pattern=(("C", "D"),) + (("A", "D"),) * 4,
    n_img_tokens=17, vocab_pad_to=16,
)
