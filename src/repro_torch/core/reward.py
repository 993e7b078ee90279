"""AIMM reward function (port of `repro.core.reward`, paper §4.2): +1 / -1 / 0
for OPC improvement / degradation / no change beyond a relative deadband."""
from __future__ import annotations

import torch

DEADBAND = 1e-3  # relative OPC change treated as "no change"


def compute_reward(opc_now: torch.Tensor, opc_prev: torch.Tensor,
                   deadband: float = DEADBAND) -> torch.Tensor:
    rel = (opc_now - opc_prev) / torch.clamp(opc_prev, min=1e-9)
    one = torch.ones_like(rel)
    return torch.where(rel > deadband, one,
                       torch.where(rel < -deadband, -one,
                                   torch.zeros_like(rel)))
