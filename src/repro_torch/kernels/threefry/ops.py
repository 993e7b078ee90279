"""Wrappers of the threefry2x32 kernel (csrc/threefry.cu).

Each `jax.random` draw the engine makes is one call here: `split`, `bits`,
`uniform`, `randint` and `choice` over a batch of keys (..., 2).  A call
takes the plain version (ref.py) for CPU tensors and launches the CUDA
kernel, once, for CUDA tensors; anything else raises, and there is no
fallback from kernel to plain.  `launches` counts kernel launches and
nothing else; `launches_by_mode` splits them by draw, `launches_by_shape`
by draw and number of keys B.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.threefry import ref

MODES = ("split", "bits", "uniform", "randint", "choice")
launches = {"threefry": 0}
launches_by_mode: dict[str, int] = {}
launches_by_shape: dict[str, int] = {}     # "split B=45": draw, keys


def reset_launches() -> None:
    launches["threefry"] = 0
    launches_by_mode.clear()
    launches_by_shape.clear()


def _lib():
    lib = build.load("threefry")
    fn = lib.threefry_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(keys: torch.Tensor) -> bool:
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"threefry: keys must be int64 (..., 2), got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry: unsupported device {keys.device}")
    return keys.device.type == "cpu"


def _launch(mode: str, keys: torch.Tensor, n: int, out: torch.Tensor, *,
            lo: float = 0.0, span: float = 1.0, hi_tab=None, hi: int = 0,
            lo_int: int = 0, p=None) -> torch.Tensor:
    flat = keys.reshape(-1, 2).contiguous()
    B = flat.shape[0]
    if B == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch._C._cuda_getCurrentRawStream(keys.device.index)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = lib.threefry_launch(flat.data_ptr(), B, n, MODES.index(mode),
                               out.data_ptr(), lo, span, ptr(hi_tab), hi,
                               lo_int, ptr(p), 0 if p is None else
                               p.shape[-1], stream)
    build.check(lib, code, "threefry")
    launches["threefry"] += 1
    launches_by_mode[mode] = launches_by_mode.get(mode, 0) + 1
    key = f"{mode} B={B}"
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def _empty(keys, shape, dtype):
    return torch.empty(keys.shape[:-1] + tuple(shape), dtype=dtype,
                       device=keys.device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) keys -> (..., num, 2)."""
    if _on_cpu(keys):
        return ref.split(keys, num)
    return _launch("split", keys, num, _empty(keys, (num, 2), torch.int64))


def bits(keys: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """32-bit draws (..., *shape) as int64 in [0, 2^32)."""
    if _on_cpu(keys):
        return ref.bits(keys, shape)
    return _launch("bits", keys, math.prod(shape),
                   _empty(keys, shape, torch.int64))


def uniform(keys: torch.Tensor, shape: tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 draws in [minval, maxval) (..., *shape)."""
    if _on_cpu(keys):
        return ref.uniform(keys, shape, minval, maxval)
    lo, hi = np.float32(minval), np.float32(maxval)
    return _launch("uniform", keys, math.prod(shape),
                   _empty(keys, shape, torch.float32), lo=float(lo),
                   span=float(hi - lo))


def randint(keys: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval) -> torch.Tensor:
    """int32 draws in [minval, maxval) (..., *shape); `maxval` is an int or
    an int tensor with the keys' batch shape (one bound per key)."""
    if _on_cpu(keys):
        return ref.randint(keys, shape, minval, maxval)
    hi_tab, hi = None, 0
    if isinstance(maxval, torch.Tensor):
        hi_tab = maxval.to(torch.int32).expand(keys.shape[:-1]).contiguous()
        if hi_tab.device != keys.device:
            raise ValueError("threefry: maxval and keys on different devices")
    else:
        hi = int(maxval)
    return _launch("randint", keys, math.prod(shape),
                   _empty(keys, shape, torch.int32), hi_tab=hi_tab, hi=hi,
                   lo_int=int(minval))


def choice(keys: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One index per key drawn with weights p (..., D): int64 (...)."""
    if _on_cpu(keys):
        return ref.choice(keys, p)
    if p.shape[:-1] != keys.shape[:-1] or p.device != keys.device:
        raise ValueError(f"threefry: p {tuple(p.shape)} on {p.device} does "
                         f"not match keys {tuple(keys.shape)}")
    pf = p.to(torch.float32).contiguous()
    return _launch("choice", keys, 1, _empty(keys, (), torch.int64), p=pf)
