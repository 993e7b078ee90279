"""Wrapper of the SSD-scan kernel (the entry point of
`repro/kernels/ssd_scan/ops.py`).

`ssd` takes the plain chunked version (ref.py) for CPU tensors and launches
the CUDA kernel (csrc/ssd_scan.cu) for CUDA tensors; anything else raises,
and there is no fallback from kernel to plain.  The reference wrapper's
VMEM head-group split is the TPU's concern and has no counterpart: the CUDA
kernel sizes its work by shared memory and registers (one head and chunk
per block, 64 x 64 tiles, products on the tensor cores as a 3xTF32 split).
One launch runs the kernel's stages (the in-chunk cumsum and C.B^T once
for all heads, the chunk states, the in-order state recurrence, then
y = intra + inter) on the current stream; the wrapper allocates their scratch.
`launches` counts launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_HEAD_DIM = 64       # P: one 64-column tile
MAX_D_STATE = 128       # N

launches = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssd(x, b, c, dt, a, *, chunk: int = 128):
    """x: (B, L, H, P); b, c: (B, L, N); dt: (B, L, H); a: (H,).

    Returns y (B, L, H, P) in x's dtype; float32 math throughout."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    if (b.shape != (Bsz, L, N) or c.shape != b.shape
            or dt.shape != (Bsz, L, H) or a.shape != (H,)):
        raise ValueError(f"ssd: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)} do not fit together")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: L={L} is not a multiple of chunk={chunk}")
    dev = x.device
    if any(t.device != dev for t in (b, c, dt, a)):
        raise ValueError("ssd: tensors on more than one device")
    if dev.type == "cpu":
        return ssd_chunked(x, b, c, dt, a, chunk=chunk).to(x.dtype)
    if dev.type != "cuda":
        raise ValueError(f"ssd: unsupported device {dev}")
    if P > MAX_HEAD_DIM or N > MAX_D_STATE:
        raise ValueError(f"ssd: head_dim {P} > {MAX_HEAD_DIM} or d_state {N}"
                         f" > {MAX_D_STATE}: outside the kernel's tiles")
    xs = [t.to(torch.float32).contiguous() for t in (x, b, c, dt, a)]
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, L, H, P), **f32)
    nc = L // chunk
    states = torch.empty((Bsz, nc, H, N, P), **f32)    # S_c, then R_c
    seg_end = torch.empty((Bsz, nc, H), **f32)
    seg = torch.empty((Bsz, L, H), **f32)             # in-chunk cumsum
    cb = torch.empty((Bsz, nc, chunk, chunk), **f32)   # C_i . B_j per chunk
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ssd_scan_launch(*[t.data_ptr() for t in xs], y.data_ptr(),
                               states.data_ptr(), seg_end.data_ptr(),
                               seg.data_ptr(), cb.data_ptr(), Bsz, L, H, P,
                               N, chunk, stream)
    build.check(lib, code, "ssd_scan")
    launches["ssd_scan"] += 1
    return y.to(x.dtype)
