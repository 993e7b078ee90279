"""Architecture registry of the port: every model-zoo arch of the reference.
Select with --arch <id>."""
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPE,  # noqa: F401
                                      AttnCfg, EncoderCfg, ModelConfig,
                                      MoECfg, ShapeCfg, SSMCfg,
                                      shape_applicable)

from repro_torch.configs import (deepseek_moe_16b, gemma3_12b,
                                 jamba_1_5_large_398b,
                                 llama_3_2_vision_11b, mamba2_370m,
                                 minitron_8b, mixtral_8x22b, phi3_medium_14b,
                                 qwen3_32b, whisper_large_v3)

_MODULES = {
    "gemma3-12b": gemma3_12b,
    "minitron-8b": minitron_8b,
    "phi3-medium-14b": phi3_medium_14b,
    "qwen3-32b": qwen3_32b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "whisper-large-v3": whisper_large_v3,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "mamba2-370m": mamba2_370m,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"repro_torch: unknown arch {name!r} (archs: "
                       f"{', '.join(ARCHS)})")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {n: get_config(n, smoke) for n in ARCHS}
