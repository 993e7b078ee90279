"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, d_ff=0, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 2048, head_dim 64 => 32 SSD heads. No FFN blocks
(listed d_ff=0): each layer is a single Mamba2 mixer.
"""
from repro_torch.configs.base import AttnCfg, ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, d_ff=0, vocab=50280,
    attn=AttnCfg(n_heads=16, n_kv=16, head_dim=64),   # unused (attention-free)
    pattern=(("M", "N"),),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    long_context_ok=True,
    source="[arXiv:2405.21060; unverified]",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, d_ff=0, vocab=512,
    attn=AttnCfg(n_heads=4, n_kv=4, head_dim=16),
    pattern=(("M", "N"),),
    ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=32),
    tie_embeddings=True, long_context_ok=True, vocab_pad_to=16,
)
