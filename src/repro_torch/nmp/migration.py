"""Page migration model (port of `repro.nmp.migration`, paper §5.3).

The MDMA streams a 4 KB frame over the precomputed route old->new: its flits
load every link of the route in the next epoch, the DMA latency is recorded
in the page's migration history, and RW pages stall more than RO ones.
"""
from __future__ import annotations

import torch

from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.topology import TopoTensors


def migration_cost(old_cube: torch.Tensor, new_cube: torch.Tensor,
                   is_rw: torch.Tensor, touches: torch.Tensor,
                   cfg: NMPConfig, topo: TopoTensors
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-lane cost of migrating one page: (latency (B,), stall (B,),
    link loads (B, L)).  An exact no-op when old_cube == new_cube."""
    o, n = old_cube.long(), new_cube.long()
    hops = topo.hops[o, n].to(torch.float32)
    moving = (hops > 0).to(torch.float32)
    latency = moving * (cfg.page_flits + hops * cfg.t_router
                        + cfg.t_page_walk)
    stall_frac = torch.where(is_rw, 0.25, 0.05)
    stall = moving * (stall_frac * latency
                      + 4.0 * torch.clamp(touches.to(torch.float32),
                                          max=8.0))
    loads = topo.route_links[o, n] * cfg.page_flits * moving[:, None]
    return latency, stall, loads
