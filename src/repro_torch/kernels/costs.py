"""What the step-cost counter (`launch/roofline.count_step_costs`) needs of
the kernel wrappers: the switch that routes the flash and SSD wrappers
through their custom ops, which `FlopCounterMode` sees as one op each, and
the FLOP formulas those ops are counted by.

The formulas count what the kernels' bounds in `chip_smoke.py` count: for
flash, 4 hd FLOP for each visible (query, key) pair of each head (the
causal half with its window, or S x S_kv), the backward 2.5 times the
forward; for the SSD scan, the causal half of C.B^T per chunk and per
head the intra product, the inter term and the state update (forward), and
the backward's products from its kernels' loops.  The count is then the
same whatever implements the op: the card's kernel, the plain version on
the CPU (which computes the whole S x S square and masks it), or nothing
on `meta`.

Inside `sharding.context.on_local_shards` an op sees one rank's local
shard and is counted at that size: the counter counts each rank's own
work.
"""
from __future__ import annotations

import contextlib

_STATE = {"counting": 0, "mark": None}


@contextlib.contextmanager
def counting():
    """Route the flash and SSD wrappers through their custom ops."""
    _STATE["counting"] += 1
    try:
        yield
    finally:
        _STATE["counting"] -= 1


def active() -> bool:
    return _STATE["counting"] > 0


@contextlib.contextmanager
def marking(fn):
    """`mark()` calls fn() while the context is open (the counter's
    snapshot of its running totals)."""
    old = _STATE["mark"]
    _STATE["mark"] = fn
    try:
        yield
    finally:
        _STATE["mark"] = old


def mark() -> None:
    """A boundary the counter snapshots (the train step's microbatches)."""
    if _STATE["mark"] is not None:
        _STATE["mark"]()


def visible_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs, within `window` of the query if set."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_flops(B: int, S: int, S_kv: int, H: int, hd: int, causal: bool,
                window: int) -> int:
    """The forward's products: 4 hd per visible pair per head."""
    pairs = visible_pairs(S, window) if causal else S * S_kv
    return 4 * hd * H * B * pairs


FLASH_BWD_FACTOR = 2.5      # the backward: 2.5 x the forward's products


def ssd_flops(B: int, L: int, H: int, P: int, N: int, chunk: int) -> int:
    """The forward: per chunk the causal half of C.B^T once (shared by the
    heads); per head the causal intra product, the inter term C.R for
    every chunk but the first and the state update for every chunk but
    the last."""
    Q = chunk
    nc = L // Q
    return B * (nc * Q * (Q + 1) * N
                + H * (nc * P * Q * (Q + 1) + (nc - 1) * 4 * Q * N * P))


def ssd_bwd_flops(B: int, L: int, H: int, P: int, N: int,
                  chunk: int) -> int:
    """The backward, 2 x its multiply-adds: the reverse state (chunks
    1..), per head C R and B G, M = dy x^T and (CB E dt)^T dy over the
    causal half, the head-summed dC / dB state terms, and dCB's two
    products over the causal half."""
    Q = chunk
    nc = L // Q
    half = Q * (Q + 1) // 2
    macs = B * (5 * (nc - 1) * H * Q * N * P + 2 * H * nc * half * P
                + 2 * nc * half * N)
    return 2 * macs
