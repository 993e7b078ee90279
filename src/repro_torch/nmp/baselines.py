"""NMP techniques and the TOM mapping baseline (port of `repro.nmp.baselines`,
paper §6.3).

Schedulers pick the compute cube of each windowed op:
  BNMP : compute at the destination operand's cube.
  LDB  : compute at the first source's cube.
  PEI  : if one source hits the CPU cache, offload to the other source's
         cube; if both hit, to src1's cube; if neither, like BNMP.
TOM profiles K candidate consecutive-page stride-hash mappings, one window
each, then commits the best co-locating one.  Tensors carry a leading lane
axis B.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nmp.config import NMPConfig

BNMP, LDB, PEI = "bnmp", "ldb", "pei"
TECHNIQUES = (BNMP, LDB, PEI)


def schedule(technique: str, dcube, s1cube, s2cube, hot1, hot2):
    """Compute-cube selection. hot1/hot2: bool PEI cache-hit flags."""
    if technique == BNMP:
        return dcube
    if technique == LDB:
        return s1cube
    if technique == PEI:
        neither = ~(hot1 | hot2)
        both = hot1 & hot2
        cc = torch.where(hot1, s2cube, s1cube)   # offload to the missing side
        cc = torch.where(both, s1cube, cc)
        cc = torch.where(neither, dcube, cc)
        return cc
    raise ValueError(technique)


def schedule_by_id(tech_id, dcube, s1cube, s2cube, hot1, hot2):
    """`schedule` with a per-lane technique id (tech_id: (B,), cubes (B, W)):
    all three policies are evaluated and each lane's one is selected."""
    t = tech_id[:, None]
    pei = schedule(PEI, dcube, s1cube, s2cube, hot1, hot2)
    return torch.where(t == TECHNIQUES.index(PEI), pei,
                       torch.where(t == TECHNIQUES.index(LDB), s1cube, dcube))


def tom_candidates(n_pages: int, cfg: NMPConfig, device: torch.device,
                   n_candidates: int = 6) -> torch.Tensor:
    """(K, n_pages) i32 candidate page->cube mappings: consecutive-page groups
    of stride 2^k hashed round-robin over the cubes."""
    pages = np.arange(n_pages)
    cands = np.stack([((pages // (1 << k)) % cfg.n_cubes).astype(np.int32)
                      for k in range(n_candidates)])
    return torch.from_numpy(cands).to(device)


def tom_score_constants(n_cubes: int) -> tuple[float, float]:
    """(1/C, 1/(1 - 1/C)) as float32 values.  XLA folds the reference's
    division by the constant (1 - 1/C) into a multiply by its float32
    reciprocal; the port does the same so scores agree bit for bit."""
    inv_c = np.float32(1.0 / n_cubes)
    recip = np.float32(1.0) / np.float32(1.0 - 1.0 / n_cubes)
    return float(inv_c), float(recip)


def tom_colocation_score(mapping: torch.Tensor, dest, src1, src2, valid,
                         n_cubes: int = 16) -> torch.Tensor:
    """(B,) score of one candidate mapping per lane: operand co-location
    fraction minus half the clipped load imbalance of per-cube op counts.
    mapping: (B, P) or (P,); dest/src1/src2: (B, W) i32; valid: (B, W) f32."""
    B = dest.shape[0]
    if mapping.dim() == 1:
        mapping = mapping.expand(B, -1)
    d = mapping.gather(1, dest.long())
    a = mapping.gather(1, src1.long())
    b = mapping.gather(1, src2.long())
    co = ((a == d).float() + (b == d).float()) * 0.5
    vsum = valid.sum(dim=1)
    total = torch.clamp(vsum, min=1.0)
    co_frac = (co * valid).sum(dim=1) / total
    ops_c = torch.zeros((B, n_cubes), dtype=torch.float32,
                        device=dest.device).scatter_add_(1, d.long(), valid)
    inv_c, recip = tom_score_constants(n_cubes)
    imb = (ops_c.max(dim=1).values / total - inv_c) * recip
    return co_frac - 0.5 * torch.clamp(imb, 0.0, 1.0)
