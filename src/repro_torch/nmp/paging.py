"""Paging structures (port of `repro.nmp.paging`): the page->cube table
allocators (round-robin `default_alloc`, `random_alloc`, and the NMP-aware
HOARD `hoard_alloc` of §6.3: each program's pages on a contiguous span of
cubes) and the pooled MC page-info cache (paper §5.1).

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


def random_alloc(n_pages: int, cfg: NMPConfig, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.n_cubes, n_pages).astype(np.int32)


def hoard_alloc(n_pages: int, cfg: NMPConfig, program_of_page: np.ndarray,
                seed: int = 0) -> np.ndarray:
    """HOARD-style: thread/program-private chunks -> contiguous cube regions.

    Programs get contiguous spans of cubes proportional to their page counts;
    within a span, pages interleave across that span's cubes only.  Programs
    with zero pages (a program id gap, or a departed co-runner whose pages
    were freed) claim no cubes at all — every cube goes to the programs that
    actually hold pages, so a degenerate span can never starve them.  Spans
    are disjoint whenever the populated programs fit the cube count; with
    more populated programs than cubes, every program keeps a one-cube span
    and the spans wrap round-robin (overlap is then unavoidable, but stays
    balanced instead of piling onto cube 0).
    """
    program_of_page = np.asarray(program_of_page)
    if program_of_page.size != n_pages:
        raise ValueError(
            f"hoard_alloc: program_of_page has {program_of_page.size} "
            f"entries for n_pages={n_pages}; one owner per page expected")
    if n_pages == 0:
        # zero-page trace (e.g. every co-runner departed): nothing to place
        return np.zeros(0, np.int32)
    n_prog = int(program_of_page.max()) + 1
    counts = np.bincount(program_of_page, minlength=n_prog).astype(np.float64)
    pop = np.flatnonzero(counts > 0)          # populated programs only
    share = np.zeros(n_prog, int)
    share[pop] = np.maximum(
        np.round(counts[pop] / counts.sum() * cfg.n_cubes), 1).astype(int)
    while share.sum() > cfg.n_cubes and (share[pop] > 1).any():
        share[pop[np.argmax(share[pop])]] -= 1
    while share.sum() < cfg.n_cubes:
        share[pop[np.argmin(share[pop])]] += 1
    start = np.concatenate([[0], np.cumsum(share)[:-1]])
    table = np.zeros(n_pages, np.int32)
    for p in pop:
        idx = np.where(program_of_page == p)[0]
        span = max(share[p], 1)
        table[idx] = (start[p] + (np.arange(idx.size) % span)) % cfg.n_cubes
    return table


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
