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

Training.  Where autograd needs a gradient of a CUDA call (grad mode on
and any input requiring one), the call goes through `SSDScan`, a
`torch.autograd.Function`: its forward is the same launch and keeps the
scratch it leaves behind (R_c, the state entering each chunk, in
`states`; seg, seg_end and C.B^T), its backward is one launch of
csrc/ssd_scan_bwd.cu (`launches["ssd_scan_bwd"]`), which returns dx, db,
dc, ddt and da in the inputs' dtypes.  The backward takes chunks that are
a multiple of 32 up to 256 (`BWD_MAX_CHUNK`) and raises
NotImplementedError for others.  On the CPU autograd runs through
`ssd_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_HEAD_DIM = 64       # P: one 64-column tile
MAX_D_STATE = 128       # N
BWD_MAX_CHUNK = 256     # the backward's chunk: a multiple of 32 up to this

launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _forward(xs, chunk):
    """One launch of the scan on float32 contiguous CUDA inputs xs = (x,
    b, c, dt, a).  Returns y and the scratch the launch leaves: states
    (R_c, the state entering each chunk), seg_end, seg, cb."""
    x = xs[0]
    Bsz, L, H, P = x.shape
    N = xs[1].shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, L, H, P), **f32)
    nc = L // chunk
    states = torch.empty((Bsz, nc, H, N, P), **f32)    # S_c, then R_c
    seg_end = torch.empty((Bsz, nc, H), **f32)
    seg = torch.empty((Bsz, L, H), **f32)             # in-chunk cumsum
    cb = torch.empty((Bsz, nc, chunk, chunk), **f32)   # C_i . B_j per chunk
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ssd_scan_launch(*[t.data_ptr() for t in xs], y.data_ptr(),
                               states.data_ptr(), seg_end.data_ptr(),
                               seg.data_ptr(), cb.data_ptr(), Bsz, L, H, P,
                               N, chunk, stream)
    build.check(lib, code, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, states, seg_end, seg, cb


def ssd_backward(xs, dy, states, seg_end, seg, cb, chunk):
    """dx, db, dc, ddt, da (float32) of the scan on CUDA tensors: one
    launch of csrc/ssd_scan_bwd.cu over the forward's inputs xs and the
    scratch its launch left."""
    x, b = xs[0], xs[1]
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    if chunk % 32 or chunk > BWD_MAX_CHUNK:
        raise NotImplementedError(
            f"ssd backward on the card: chunk {chunk} is not ported (a "
            f"multiple of 32 up to {BWD_MAX_CHUNK} is; ROADMAP.md queue 1)")
    dy = dy.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = L // chunk
    gst = torch.empty((Bsz, nc, H, N, P), **f32)
    dcb = torch.empty((Bsz, nc, H, chunk, chunk), **f32)
    dap = torch.empty((Bsz, nc, H), **f32)
    grads = [torch.empty_like(t) for t in xs]
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ssd_scan_bwd_launch(
        *[t.data_ptr() for t in (*xs, dy, states, seg, seg_end, cb, gst, dcb,
                                 dap, *grads)],
        Bsz, L, H, P, N, chunk, stream)
    build.check(lib, code, "ssd_scan_bwd")
    launches["ssd_scan_bwd"] += 1
    return grads


class SSDScan(torch.autograd.Function):
    """The CUDA scan with a gradient through csrc/ssd_scan_bwd.cu."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a, chunk):
        xs = [t.to(torch.float32).contiguous() for t in (x, b, c, dt, a)]
        y, states, seg_end, seg, cb = _forward(xs, chunk)
        ctx.chunk = chunk
        ctx.dtypes = [t.dtype for t in (x, b, c, dt, a)]
        ctx.save_for_backward(*xs, states, seg_end, seg, cb)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        *xs, states, seg_end, seg, cb = ctx.saved_tensors
        grads = ssd_backward(xs, dy, states, seg_end, seg, cb, ctx.chunk)
        return (*[g.to(d) for g, d in zip(grads, ctx.dtypes)], None)


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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, b, c, dt, a)):
        return SSDScan.apply(x, b, c, dt, a, chunk)
    xs = [t.to(torch.float32).contiguous() for t in (x, b, c, dt, a)]
    return _forward(xs, chunk)[0].to(x.dtype)
