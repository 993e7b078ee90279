"""`jax.random` with threefry2x32 keys, bit for bit (port of the draws the
reference makes through `jax.random`).

Mirrors jax 0.9.0 under its live flags (`jax_default_prng_impl=threefry2x32`,
`jax_threefry_partitionable=True`): a key is an int64 tensor (..., 2) of
the two uint32 key words, carried in the engine's state like the
reference's `rng` fields, and every function takes a leading batch of keys
(the reference's `jax.vmap` over keys written out: each key draws `shape`).

`PRNGKey`, `split`, `bits`, `uniform`, `randint` and `choice(p=)` equal
jax's integer and float results exactly; each is one call of
`kernels/threefry/ops.py` (one kernel launch on the card, the plain version
on the CPU).  `normal` (agent init only) is `uniform` then the inverse error
function in torch ops on both devices: XLA evaluates `erf_inv` with Giles'
single-precision polynomial, which `erf_inv` below repeats with each Horner
step rounded once (XLA's CPU backend contracts it into an FMA), but
torch's `log1p` and XLA's differ in the last bit on some inputs.  So
`erf_inv` stays within 2 ulp of `jax.lax.erf_inv` and `normal` (one more
rounding, the product by sqrt 2) within 3 ulp of `jax.random.normal`
(tests/test_torch_prng.py measures both over 2^22 draws).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.threefry import ops, ref

split = ops.split
bits = ops.bits
uniform = ops.uniform
randint = ops.randint


def PRNGKey(seed, device: str | torch.device = "cuda") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for int32 seeds: (2,) for an int, (..., 2)
    for a tensor of seeds."""
    dev = (seed.device if isinstance(seed, torch.Tensor)
           else resolve_device(device))
    return ref.key(seed).to(dev)


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """`jax.random.choice(key, n, p=p)` (one draw, with replacement) per key;
    p (..., n) float32.  int64 (...)."""
    if p.shape[-1] != n:
        raise ValueError(f"choice: p has {p.shape[-1]} entries, n={n}")
    return ops.choice(key, p)


# Giles, "Approximating the erfinv function" (GPU Computing Gems), single
# precision: the coefficients XLA's ErfInv uses for float32.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, as XLA's `erf_inv` (see module doc)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(
        lt, torch.tensor(np.float32(_ERFINV_LT5[i]), device=x.device),
        torch.tensor(np.float32(_ERFINV_GE5[i]), device=x.device))
    p = coef(0)
    w64 = w.to(torch.float64)
    for i in range(1, len(_ERFINV_LT5)):
        # c + p * w rounded once: the product of two float32 values is exact
        # in float64, so only the float64 sum and the cast round
        p = (coef(i).to(torch.float64) + p.to(torch.float64) * w64
             ).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """Standard normal float32 draws (..., *shape), as jax's `_normal_real`:
    uniform in (-1, 1), then sqrt(2) * erf_inv (within 3 ulp, module doc)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)
