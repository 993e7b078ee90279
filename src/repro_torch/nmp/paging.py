"""Paging structures (port of `repro.nmp.paging`): the page->cube table
allocator and the pooled MC page-info cache (paper §5.1).

Every cache array carries a leading lane axis B: `run_episode` uses B = 1,
the batched engine of a later slice uses B lanes with the same functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.nmp.config import NMPConfig


def default_alloc(n_pages: int, cfg: NMPConfig, seed: int = 0) -> np.ndarray:
    """Round-robin page interleaving across cubes."""
    return (np.arange(n_pages) % cfg.n_cubes).astype(np.int32)


@dataclasses.dataclass
class PageInfoCache:
    """Pooled MC page-info cache (paper §5.1); arrays are (B, E, ...)."""
    tag: torch.Tensor       # (B, E) i32 page id, -1 = empty
    freq: torch.Tensor      # (B, E) f32 LFU counter
    accesses: torch.Tensor  # (B, E) f32 total access count for the page
    migrations: torch.Tensor
    hop_hist: torch.Tensor  # (B, E, hop_h) communication hop counts
    lat_hist: torch.Tensor  # (B, E, lat_h) round-trip packet latencies
    mig_hist: torch.Tensor  # (B, E, mig_h) migration latencies
    act_hist: torch.Tensor  # (B, E, act_h) actions taken on the page

    def replace(self, **kw) -> "PageInfoCache":
        return dataclasses.replace(self, **kw)


def init_page_cache(cfg: NMPConfig, batch: int, device: torch.device,
                    hop_h=None, lat_h=None, mig_h=None,
                    act_h=None) -> PageInfoCache:
    """Empty pooled caches for `batch` lanes.  History depths default to the
    config's `hop_hist`/`lat_hist`/`mig_hist`/`act_hist` fields."""
    hop_h = cfg.hop_hist if hop_h is None else hop_h
    lat_h = cfg.lat_hist if lat_h is None else lat_h
    mig_h = cfg.mig_hist if mig_h is None else mig_h
    act_h = cfg.act_hist if act_h is None else act_h
    B, E = batch, cfg.page_cache_entries
    z = lambda *s: torch.zeros((B, E) + s, dtype=torch.float32, device=device)
    return PageInfoCache(
        tag=torch.full((B, E), -1, dtype=torch.int32, device=device),
        freq=z(), accesses=z(), migrations=z(), hop_hist=z(hop_h),
        lat_hist=z(lat_h), mig_hist=z(mig_h), act_hist=z(act_h))


def lane_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every lane b (x: (B, E, ...), idx: (B,))."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def set_lane_rows(x: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[b, idx[b]] = val[b] (one index per lane, so no
    duplicate writes)."""
    out = x.clone()
    out[torch.arange(x.shape[0], device=x.device), idx.long()] = val
    return out


def lookup_or_insert(cache: PageInfoCache, page: torch.Tensor
                     ) -> tuple[PageInfoCache, torch.Tensor]:
    """Find each lane's `page` entry; on a miss LFU-evict (the victim's
    content is abandoned, §5.1).  Returns (cache, (B,) i32 entry index).

    `argmax`/`argmin` take the first index on ties, as jnp's do; the bool
    hit mask is cast first because CUDA's argmax refuses bool."""
    hit = cache.tag == page[:, None]
    found = hit.any(dim=1)
    hit_idx = torch.argmax(hit.to(torch.int32), dim=1)
    victim = torch.argmin(torch.where(cache.tag < 0,
                                      torch.full_like(cache.freq, -1.0),
                                      cache.freq), dim=1)
    idx = torch.where(found, hit_idx, victim).to(torch.int32)

    def keep_or_clear(arr):
        cleared = set_lane_rows(arr, idx,
                                torch.zeros_like(lane_rows(arr, idx)))
        f = found.reshape((-1,) + (1,) * (arr.dim() - 1))
        return torch.where(f, arr, cleared)

    cache = cache.replace(
        tag=set_lane_rows(cache.tag, idx, page.to(torch.int32)),
        freq=keep_or_clear(cache.freq),
        accesses=keep_or_clear(cache.accesses),
        migrations=keep_or_clear(cache.migrations),
        hop_hist=keep_or_clear(cache.hop_hist),
        lat_hist=keep_or_clear(cache.lat_hist),
        mig_hist=keep_or_clear(cache.mig_hist),
        act_hist=keep_or_clear(cache.act_hist),
    )
    return cache, idx


def push_hist(hist: torch.Tensor, idx: torch.Tensor,
              value: torch.Tensor) -> torch.Tensor:
    """Shift each lane's entry `idx` history left and append `value` (B,)."""
    row = lane_rows(hist, idx)
    row = torch.cat([row[:, 1:], value.to(torch.float32)[:, None]], dim=1)
    return set_lane_rows(hist, idx, row)
