"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]

8 experts < model axis (16): experts run TP-in-expert (d_ff sharded), no EP.
"""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, d_ff=16384, vocab=32768,
    attn=AttnCfg(n_heads=48, n_kv=8, head_dim=128, window=4096),
    pattern=(("W", "E"),),
    moe=MoECfg(n_routed=8, top_k=2, d_expert=16384),
    long_context_ok=True,   # SWA: decode cache = sliding window
    source="[arXiv:2401.04088; hf]",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16, window=32),
    pattern=(("W", "E"),),
    moe=MoECfg(n_routed=4, top_k=2, d_expert=128),
    long_context_ok=True, vocab_pad_to=16,
)
