"""AIMM action space (port of `repro.core.actions`, paper §4.2).

Eight actions: six data/computation remaps plus two agent-invocation-interval
adjustments.  Remap targets are relative to the hot page's compute cube:
"near" is a random topology neighbour, "far" the topology's far table.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng

# Action ids (paper order).
DEFAULT = 0            # (i)   no mapping change
NEAR_DATA = 1          # (ii)  migrate page to a random neighbour of the compute cube
FAR_DATA = 2           # (iii) migrate page to the diagonally opposite cube
NEAR_COMPUTE = 3       # (iv)  remap compute to a random neighbour cube
FAR_COMPUTE = 4        # (v)   remap compute to the diagonally opposite cube
SOURCE_COMPUTE = 5     # (vi)  remap compute to the host cube of the first source page
INC_INTERVAL = 6       # (vii) increase agent invocation interval
DEC_INTERVAL = 7       # (viii)decrease agent invocation interval

N_ACTIONS = 8

# Discrete invocation intervals, in cycles (paper §4.2).
INTERVALS = (100, 125, 167, 250)
N_INTERVALS = len(INTERVALS)


def random_neighbor(key: torch.Tensor, cube: torch.Tensor,
                    nbr: torch.Tensor, nbr_valid: torch.Tensor) -> torch.Tensor:
    """Uniformly pick one of each lane's cube's topology neighbours (B,).

    As the reference: a categorical draw over the D neighbour slots with
    probability proportional to validity (`jax.random.choice(key, D, p=)`,
    one key (B, 2) per lane), so an invalid slot is never picked."""
    cand = nbr[cube.long()]                              # (B, D)
    p = nbr_valid[cube.long()].to(torch.float32)
    p = p / torch.clamp(p.sum(dim=1, keepdim=True), min=1.0)
    d = prng.choice(key, cand.shape[1], p)
    return cand.gather(1, d[:, None])[:, 0]


def far_target(cube: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """The topology's "far" remap target for each lane's cube."""
    return far[cube.long()]


def adjust_interval(level: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Apply INC/DEC interval actions to the discrete interval level."""
    delta = torch.where(action == INC_INTERVAL, 1,
                        torch.where(action == DEC_INTERVAL, -1, 0))
    return torch.clamp(level + delta, 0, N_INTERVALS - 1).to(level.dtype)
