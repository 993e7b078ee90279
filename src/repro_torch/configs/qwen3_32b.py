"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, d_ff=25600, vocab=151936,
    attn=AttnCfg(n_heads=64, n_kv=8, head_dim=128, qk_norm=True),
    pattern=(("A", "D"),),
    source="[hf:Qwen/Qwen3-8B; hf]",
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke", family="dense",
    n_layers=2, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16, qk_norm=True),
    pattern=(("A", "D"),), vocab_pad_to=16,
)
