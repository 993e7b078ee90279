"""threefry2x32 and the `jax.random` draws built on it, in plain torch ops.

The plain version of `csrc/threefry.cu`: the CPU path of
`repro_torch.core.prng`, and the yardstick the kernel is held to on the
card.  It follows jax 0.9.0 with its live flags
(`jax_default_prng_impl=threefry2x32`, `jax_threefry_partitionable=True`):

  hash      : Threefry-2x32 with 20 rounds (jax/_src/prng.py
              `_threefry2x32_lowering`), five groups of four rounds with a
              key injection after each group;
  counters  : a draw of shape `shape` hashes the 64-bit row-major index of
              each element, split into (hi, lo) 32-bit halves
              (`iota_2x32_shape`);
  split     : the two hash words of counter j are new key j
              (`_threefry_split_foldlike`);
  bits      : 32-bit draws are the xor of the two hash words
              (`_threefry_random_bits_partitionable`);
  uniform   : the top 23 bits as a mantissa in [1, 2), minus 1, scaled
              (jax/_src/random.py `_uniform`);
  randint   : two 32-bit draws from the key's two halves, combined as
              (hi mod span) * (2^32 mod span) + (lo mod span), mod span
              (`_randint`);
  choice    : cumsum(p), r = cumsum[-1] * (1 - uniform), searchsorted
              (`choice` with `p` and replacement).

Keys are int64 tensors of shape (..., 2) holding the two uint32 key words;
the 32-bit arithmetic runs in int64 under a 0xFFFFFFFF mask (torch has no
uint32 arithmetic on both devices), so every result is exact.  A leading
batch of keys gives a leading batch of draws: each key draws `shape`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of counter words (x1, x2) under key
    words (k1, k2); all int64 in [0, 2^32), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def _counters(shape: tuple[int, ...], device) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(hi, lo) words of the 64-bit row-major index of every element."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def _hash(keys: torch.Tensor, shape: tuple[int, ...]):
    """Hash words of every counter of `shape` under each key: (..., *shape)."""
    hi, lo = _counters(shape, keys.device)
    lead = keys.shape[:-1] + (1,) * len(shape)
    k1 = keys[..., 0].reshape(lead)
    k2 = keys[..., 1].reshape(lead)
    return threefry2x32(k1, k2, hi, lo)


def key(seed) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for int32 seeds (a Python int or an int
    tensor): the key words (seed >> 32, seed & 0xFFFFFFFF) of the seed as a
    32-bit integer, so (0, seed mod 2^32)."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    lo = s.to(torch.int32).to(torch.int64) & M32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) keys -> (..., num, 2) new keys."""
    a, b = _hash(keys, (num,))
    return torch.stack([a, b], dim=-1)


def bits(keys: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """32-bit draws (..., *shape), int64 in [0, 2^32)."""
    a, b = _hash(keys, tuple(shape))
    return a ^ b


def bits_to_uniform(b: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """float32 in [minval, maxval) from 32-bit draws, as jax's `_uniform`
    (the bounds and their difference rounded to float32 first)."""
    mant = ((b >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(f * span + float(lo), min=float(lo))


def uniform(keys: torch.Tensor, shape: tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    return bits_to_uniform(bits(keys, shape), minval, maxval)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval,
                      maxval, n_shape: int = 0) -> torch.Tensor:
    """jax's `_randint` from its two 32-bit draws; minval/maxval are int32
    values: Python ints, or tensors of the keys' batch shape (the draws'
    leading dimensions before the last `n_shape`)."""
    def bound(v):
        if not isinstance(v, torch.Tensor):
            return int(v)
        v = v.to(device=higher.device, dtype=torch.int64)
        return v.reshape(v.shape + (1,) * n_shape) if v.dim() else v

    lo, hi = bound(minval), bound(maxval)
    if isinstance(lo, int) and isinstance(hi, int):
        span = 1 if hi <= lo else (hi - lo) & M32
    else:
        span = torch.where(hi <= lo, 1, (hi - lo) & M32)
    mult = 65536 % span
    mult = ((mult * mult) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    return (lo + off).to(torch.int32)


def randint(keys: torch.Tensor, shape: tuple[int, ...], minval,
            maxval) -> torch.Tensor:
    """int32 draws in [minval, maxval) (..., *shape); minval/maxval broadcast
    against the keys' batch shape."""
    k = split(keys, 2)
    return randint_from_bits(bits(k[..., 0, :], shape),
                             bits(k[..., 1, :], shape), minval, maxval,
                             len(shape))


def choice(keys: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One index per key drawn with probabilities p (..., n), float32 (the
    weights need not be normalised: r scales by their sum).  int64 (...)."""
    cum = torch.cumsum(p.to(torch.float32), dim=-1)
    u = uniform(keys, ())
    r = cum[..., -1] * (1.0 - u)
    return torch.searchsorted(cum.contiguous(), r[..., None].contiguous(),
                              right=False)[..., 0]
