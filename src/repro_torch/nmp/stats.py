"""Summary statistics & the paper's energy model (port of `repro.nmp.stats`,
§7.7).  Reads an episode's final state once, after the epoch loop."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nmp.config import ENERGY_NJ
from repro_torch.nmp.engine import (EN_MDMA, EN_MEM_BITS, EN_MIG_Q,
                                    EN_NET_BIT_HOPS, EN_NMP_BUF,
                                    EN_PAGE_CACHE, EN_REPLAY, EN_STATE_BUF,
                                    EN_WEIGHT, EpisodeResult)


def summarize(res: EpisodeResult) -> dict[str, float]:
    env = res.env
    f = lambda x: float(x.item())
    cycles = max(f(env.cycles), 1.0)
    ops = f(env.ops_done)
    n_pages = env.mig_page_mask.shape[0]
    return {
        "cycles": cycles,
        "ops": ops,
        "opc": ops / cycles,
        "mean_hops": f(env.hops_sum) / max(ops, 1.0),
        "compute_util": f(env.util_sum) / max(f(env.epochs), 1.0),
        "migrations": f(env.mig_count),
        "frac_pages_migrated": f(env.mig_page_mask.sum()) / n_pages,
        "frac_access_migrated": (f(env.access_on_migrated)
                                 / max(f(env.access_total), 1.0)),
        "energy_nj": energy_nj(env.energy),
        "energy_breakdown": energy_breakdown(env.energy),
    }


def energy_breakdown(counters: torch.Tensor) -> dict[str, float]:
    c = counters.detach().cpu().numpy().astype(np.float64)
    return {
        "aimm_hw": float(
            c[EN_PAGE_CACHE] * ENERGY_NJ["page_cache_access"]
            + c[EN_NMP_BUF] * ENERGY_NJ["nmp_buffer_access"]
            + c[EN_MIG_Q] * ENERGY_NJ["mig_queue_access"]
            + c[EN_MDMA] * ENERGY_NJ["mdma_access"]
            + c[EN_WEIGHT] * ENERGY_NJ["weight_access"]
            + c[EN_REPLAY] * ENERGY_NJ["replay_access"]
            + c[EN_STATE_BUF] * ENERGY_NJ["state_buffer_access"]),
        "network": float(c[EN_NET_BIT_HOPS] * ENERGY_NJ["network_per_bit_hop"]),
        "memory": float(c[EN_MEM_BITS] * ENERGY_NJ["memory_per_bit"]),
    }


def energy_nj(counters: torch.Tensor) -> float:
    return float(sum(energy_breakdown(counters).values()))


def resample_opc(opc, valid, samples: int = 64) -> np.ndarray:
    """Order-preserving fixed-size resample of the valid-epoch OPC series
    (the paper's Fig. 9 convention); shared by the serial and sweep paths.
    Takes numpy arrays or tensors."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    opc = as_np(opc)[as_np(valid) > 0]
    if opc.size == 0:
        return np.zeros(samples)
    idx = np.linspace(0, opc.size - 1, samples).astype(int)
    return opc[idx]


def opc_timeline(res: EpisodeResult, samples: int = 64) -> np.ndarray:
    """Fixed-size resampled OPC timeline (paper Fig. 9 preserves order)."""
    return resample_opc(res.metrics["opc"], res.metrics["valid"], samples)
