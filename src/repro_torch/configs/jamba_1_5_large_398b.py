"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.

[arXiv:2403.19887; hf]. Mamba blocks use the Mamba2/SSD formulation (DESIGN.md
hardware-adaptation note); MoE on every other layer, attention at position 3
of each 8-layer super-block.
"""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg, SSMCfg

_PATTERN = (
    ("M", "D"), ("M", "E"), ("M", "D"), ("A", "E"),
    ("M", "D"), ("M", "E"), ("M", "D"), ("M", "E"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, d_ff=24576, vocab=65536,
    attn=AttnCfg(n_heads=64, n_kv=8, head_dim=128),
    pattern=_PATTERN,
    moe=MoECfg(n_routed=16, top_k=2, d_expert=24576),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=128),
    long_context_ok=True,
    source="[arXiv:2403.19887; hf]",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, d_ff=128, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=2, head_dim=16),
    pattern=_PATTERN,
    moe=MoECfg(n_routed=4, top_k=2, d_expert=128),
    ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=32),
    long_context_ok=True, vocab_pad_to=16,
)
