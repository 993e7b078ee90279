"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned nemotron. [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, d_ff=16384, vocab=256000,
    attn=AttnCfg(n_heads=32, n_kv=8, head_dim=128),
    pattern=(("A", "D"),),
    source="[arXiv:2407.14679; hf]",
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16),
    pattern=(("A", "D"),), vocab_pad_to=16,
)
