"""Architecture registry of the port: the model-zoo archs ported so far.
Select with --arch <id>.  whisper-large-v3 and llama-3.2-vision-11b need
cross-attention, the encoder and the GELU MLP, which are not ported yet
(ROADMAP.md, queue 1)."""
from repro_torch.configs.base import (SHAPES, AttnCfg,  # noqa: F401
                                      EncoderCfg, ModelConfig, MoECfg,
                                      ShapeCfg, SSMCfg)

from repro_torch.configs import (deepseek_moe_16b, gemma3_12b,
                                 jamba_1_5_large_398b, mamba2_370m,
                                 minitron_8b, mixtral_8x22b, phi3_medium_14b,
                                 qwen3_32b)

_MODULES = {
    "gemma3-12b": gemma3_12b,
    "minitron-8b": minitron_8b,
    "phi3-medium-14b": phi3_medium_14b,
    "qwen3-32b": qwen3_32b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "mamba2-370m": mamba2_370m,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"repro_torch: arch {name!r} is not ported yet (ported:"
                       f" {', '.join(ARCHS)}); see ROADMAP.md, queue 1, for "
                       f"the order of the rest")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
