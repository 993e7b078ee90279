"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained experts,
first layer dense. [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, d_ff=11264,     # dense first-layer FFN (8x expert)
    vocab=102400,
    attn=AttnCfg(n_heads=16, n_kv=16, head_dim=128),
    pattern=(("A", "E"),),
    first_k_dense=1,
    moe=MoECfg(n_routed=64, top_k=6, d_expert=1408, n_shared=2,
               router_pre_softmax=True),
    source="[arXiv:2401.06066; hf]",
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, d_ff=256, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=4, head_dim=16),
    pattern=(("A", "E"),), first_k_dense=1,
    moe=MoECfg(n_routed=8, top_k=2, d_expert=32, n_shared=2,
               router_pre_softmax=True),
    vocab_pad_to=16,
)
