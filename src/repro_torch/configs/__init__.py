"""Architecture registry of the port: the model-zoo archs ported so far.
Select with --arch <id>.  The reference's other eight archs need mixers and
FFNs the port does not have yet (ROADMAP.md, queue 1 item 11)."""
from repro_torch.configs.base import (SHAPES, AttnCfg,  # noqa: F401
                                      EncoderCfg, ModelConfig, MoECfg,
                                      ShapeCfg, SSMCfg)

from repro_torch.configs import mamba2_370m, minitron_8b

_MODULES = {
    "minitron-8b": minitron_8b,
    "mamba2-370m": mamba2_370m,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"repro_torch: arch {name!r} is not ported yet (ported:"
                       f" {', '.join(ARCHS)}); see ROADMAP.md, queue 1 item "
                       f"11, for the order of the rest")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
