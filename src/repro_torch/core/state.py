"""AIMM state representation (port of `repro.core.state`, paper §4.2, Fig. 3).

State = [ system information | page information ]: per-cube NMP-table
occupancy and row-buffer hit rate, MC queues, global action history and
interval level; then the selected hot page's access rate, migrations per
access, hop / latency / migration / action histories and its host and
compute cubes (one-hot).  Inputs carry a leading lane axis B.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.actions import N_ACTIONS, N_INTERVALS


@dataclasses.dataclass(frozen=True)
class StateSpec:
    n_cubes: int
    n_mcs: int
    hop_hist: int = 8
    lat_hist: int = 8
    mig_hist: int = 4
    act_hist: int = 4       # per-page action history length
    global_act_hist: int = 8

    @property
    def dim(self) -> int:
        return (self.n_cubes + self.n_cubes + self.n_mcs
                + self.global_act_hist + N_INTERVALS + 2
                + self.hop_hist + self.lat_hist + self.mig_hist
                + self.act_hist + self.n_cubes + self.n_cubes)


def _recip(x: float) -> float:
    """float32 reciprocal: XLA turns the reference's division by a constant
    into a multiply by this value, and the port follows it."""
    return float(np.float32(1.0) / np.float32(x))


def build_state(spec: StateSpec, nmp_occ, rb_hit, mc_queue, global_actions,
                interval_level, page_access_rate, page_mig_per_access,
                page_hop_hist, page_lat_hist, page_mig_hist, page_act_hist,
                page_cube, compute_cube, *, occ_norm: float = 512.0,
                queue_norm: float = 64.0, hop_norm: float = 8.0,
                lat_norm: float = 500.0) -> torch.Tensor:
    """(B, spec.dim) state vectors (see module doc for the layout)."""
    dev = nmp_occ.device
    one_hot = lambda i, n: (torch.arange(n, device=dev)[None, :]
                            == i.long()[:, None]).to(torch.float32)
    parts = [
        torch.clamp(nmp_occ * _recip(occ_norm), 0, 2),
        rb_hit,
        torch.clamp(mc_queue * _recip(queue_norm), 0, 2),
        global_actions.to(torch.float32) * _recip(N_ACTIONS),
        one_hot(interval_level, N_INTERVALS),
        torch.clamp(page_access_rate, 0, 1)[:, None],
        torch.clamp(page_mig_per_access, 0, 2)[:, None],
        torch.clamp(page_hop_hist * _recip(hop_norm), 0, 2),
        torch.clamp(page_lat_hist * _recip(lat_norm), 0, 4),
        torch.clamp(page_mig_hist * _recip(lat_norm), 0, 4),
        page_act_hist.to(torch.float32) * _recip(N_ACTIONS),
        one_hot(page_cube, spec.n_cubes),
        one_hot(compute_cube, spec.n_cubes),
    ]
    s = torch.cat(parts, dim=1)
    assert s.shape[1] == spec.dim, (s.shape, spec.dim)
    return s
