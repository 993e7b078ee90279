"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local:global attention interleave (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, d_ff=15360, vocab=262144,
    attn=AttnCfg(n_heads=16, n_kv=8, head_dim=256, window=1024,
                 rope_theta=1_000_000.0),
    pattern=(("L", "D"),) * 5 + (("G", "D"),),
    tie_embeddings=True,
    long_context_ok=True,   # 5/6 of layers are local (linear); global layers decode O(S)
    source="[hf:google/gemma-3-1b-pt; unverified]",
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    n_layers=6, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16, window=32),
    pattern=(("L", "D"),) * 5 + (("G", "D"),),
    tie_embeddings=True, long_context_ok=True, vocab_pad_to=16,
)
