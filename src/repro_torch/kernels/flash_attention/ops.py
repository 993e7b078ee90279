"""Wrapper of the flash-attention kernel: GQA, layout and the padding rule of
`repro/kernels/flash_attention/ops.py`.

Two entries, one kernel.  `gqa_flash_attention_kv` is what the model layers
call: q (B, S, H, hd) against k, v (B, S_kv, K, hd), causal (S_kv == S) or
not (any S and S_kv, the encoder's bidirectional and the decoder's cross
attention); the kernel masks keys at or past S_kv, so nothing is padded.
`gqa_flash_attention` keeps the reference wrapper's contract: S_kv == S,
and a non-causal S off the reference kernel's block multiple is refused
(the reference's model never meets that refusal: it runs dense `attend`
up to DENSE_MAX_S).  Both take the plain version (ref.py, on the
GQA-expanded K/V) for CPU tensors and launch the CUDA kernel
(csrc/flash_attention.cu) for CUDA tensors; anything else raises, and
there is no fallback from kernel to plain.  Which CUDA kernel runs follows
from dtype and head dim alone (`kernel_for`): bf16 at hd 64, 128 and 256
(the models' widths) takes the wgmma + TMA kernel, bf16 at hd 16 and 32
the mma.sync kernel, float32 the CUDA-core kernel.  `window` > 0 (causal
only) is the reference model's sliding-window / local mask: key j is
hidden from query i when j <= i - window; every kernel takes it.  The
kernel reads K/V at head h // (H / K) itself, so nothing is expanded on
the card.  `launches` counts kernel launches and nothing else;
`kernel_launches` splits that count by kernel.

Training.  Where autograd needs a gradient of a CUDA call (grad mode on
and any of q, k, v requiring one), the call goes through `FlashAttention`,
a `torch.autograd.Function`: its forward launches the same kernel with the
row log-sum-exp stored (`flash_attention_lse_launch`), its backward the
kernels of csrc/flash_attention_bwd.cu (`launches["flash_attention_bwd"]`
counts them, one per backward).  The backward takes causal attention
without a window, S_kv == S, hd 64 or 128 (`BWD_HEAD_DIMS`), bf16 or f32;
any other variant's forward runs as before and its backward raises
NotImplementedError (ROADMAP queue 1): there is no plain fallback on the
card.  On the CPU autograd runs through `attention_ref` for every variant.
Without grad (prefill, `inference_mode`) nothing changes: the kernel runs
without the store.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

BLOCK_Q = 128           # the reference kernel's blocks: they set which
BLOCK_KV = 256          # non-causal S it refuses (the CUDA kernels tile
                        # on their own)
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (64, 128)       # what the backward kernels take
# the C launcher's kernel ids
KERNELS = {"cuda_core_f32": 0, "mma_sync_bf16": 1, "wgmma_bf16": 2}

launches = {"flash_attention": 0, "flash_attention_bwd": 0}
kernel_launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for name in kernel_launches:
        kernel_launches[name] = 0


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel a (dtype, head dim) pair takes: by shape only."""
    if dtype == torch.float32:
        return "cuda_core_f32"
    return "wgmma_bf16" if hd >= 64 else "mma_sync_bf16"


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lse = lib.flash_attention_lse_launch
        lse.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lse.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def backward_supported(S: int, S_kv: int, hd: int, causal: bool,
                       window: int, scale: float) -> str | None:
    """None if the backward kernels take this variant, else why not."""
    if not causal:
        return "non-causal attention"
    if window:
        return f"a causal window ({window})"
    if S_kv != S:
        return f"S_kv {S_kv} != S {S}"
    if hd not in BWD_HEAD_DIMS:
        return f"head dim {hd} (the backward takes {BWD_HEAD_DIMS})"
    if not scale > 0:
        return f"scale {scale} <= 0"
    return None


def _forward(q, k, v, scale, causal, window, lse=None):
    """One launch of the forward kernel on CUDA tensors (contiguous,
    16-byte aligned); with `lse` (B, H, S) f32 also the rows' log-sum-exp.
    Returns the output."""
    B, S, H, hd = q.shape
    S_kv, K = k.shape[1], k.shape[2]
    kernel = kernel_for(q.dtype, hd)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lse is None:
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            S_kv, H, K, hd, float(scale), int(causal), int(window),
            KERNELS[kernel], stream)
    else:
        code = lib.flash_attention_lse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, K, hd, float(scale), KERNELS[kernel],
            stream)
    build.check(lib, code, f"flash_attention ({kernel})")
    launches["flash_attention"] += 1
    kernel_launches[kernel] += 1
    return out


def flash_backward(q, k, v, o, lse, do, scale):
    """dq, dk, dv of causal attention on CUDA tensors: one launch of the
    backward kernels (csrc/flash_attention_bwd.cu).  q, o, do (B, S, H, hd),
    k, v (B, S, K, hd), lse (B, H, S) f32 from the forward's store."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    do = do.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, H, K, hd, float(scale),
        int(q.dtype == torch.bfloat16), stream)
    build.check(lib, code, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel with a gradient: forward with the log-sum-exp
    stored where the backward kernels take the variant, backward through
    them; any other variant's backward raises NotImplementedError."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        S, S_kv, hd = q.shape[1], k.shape[1], q.shape[3]
        why = backward_supported(S, S_kv, hd, causal, window, scale)
        lse = None
        if why is None:
            lse = torch.empty((q.shape[0], q.shape[2], S),
                              dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, scale, causal, window, lse)
        ctx.why, ctx.scale = why, scale
        if why is None:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.why is not None:
            raise NotImplementedError(
                f"gqa_flash_attention backward on the card: {ctx.why} is not"
                f" ported (causal without a window, S_kv == S, head dim in "
                f"{BWD_HEAD_DIMS} is; ROADMAP.md queue 1)")
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None, None, None


def gqa_flash_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with H % K == 0; `window` 0
    (none) or > 0 with causal; a non-causal S on the reference kernel's
    block multiple.

    Returns (B, S, H, hd) in q's dtype."""
    S = q.shape[1]
    if k.ndim != 4 or k.shape[1] != S:
        raise ValueError(f"gqa_flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: need k/v (B, S, K, hd)")
    bq, bkv = min(BLOCK_Q, S), min(BLOCK_KV, S)
    if not causal and S % max(bq, bkv):
        raise ValueError("gqa_flash_attention: non-causal requires a "
                         f"block-aligned seq len, got S={S}")
    return gqa_flash_attention_kv(q, k, v, causal=causal, scale=scale,
                                  window=window)


def gqa_flash_attention_kv(q, k, v, *, causal: bool = True,
                           scale: float | None = None, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S_kv, K, hd) with H % K == 0 and
    S_kv >= 1; causal needs S_kv == S, and `window` (0 or > 0) needs
    causal.  Any S and S_kv otherwise.

    Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    S_kv, K = k.shape[1], k.shape[2]
    if k.shape != (B, S_kv, K, hd) or v.shape != k.shape or K == 0 \
            or H % K or S_kv == 0:
        raise ValueError(f"gqa_flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need k/v "
                         f"(B, S_kv, K, hd) with H % K == 0, S_kv >= 1")
    if causal and S_kv != S:
        raise ValueError(f"gqa_flash_attention: causal attention needs "
                         f"S_kv == S, got S={S}, S_kv={S_kv}")
    if window < 0 or (window and not causal):
        raise ValueError(f"gqa_flash_attention: window {window} needs to be 0"
                         f", or > 0 with causal=True")
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"gqa_flash_attention: tensors on {dev}, {k.device}"
                         f", {v.device}")
    if dev.type == "cpu":
        rep = H // K
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), scale=scale, causal=causal,
                            window=window)
        return out.transpose(1, 2)
    if dev.type != "cuda":
        raise ValueError(f"gqa_flash_attention: unsupported device {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"gqa_flash_attention: q/k/v must all be bfloat16 or"
                         f" all float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gqa_flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                    int(window))
    return _forward(q, k, v, scale, causal, window)
