"""PyTorch + CUDA port of the AIMM near-memory-processing simulator.

Mirrors the JAX package `repro` file for file (`repro_torch/nmp/engine.py`
matches `repro/nmp/engine.py`, and so on).  It imports torch and numpy only,
never jax and nothing of `repro`.  Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU; on the CPU every kernel
wrapper takes its plain-torch version, on the card it launches the
hand-written Hopper kernel in `repro_torch/csrc/`.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The run's device.  Asking for CUDA where there is none raises: nothing
    drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain-torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
