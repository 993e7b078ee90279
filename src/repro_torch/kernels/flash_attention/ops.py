"""Wrapper of the flash-attention kernel: GQA, layout and the padding rule of
`repro/kernels/flash_attention/ops.py`.

`gqa_flash_attention` takes the plain version (ref.py, on the GQA-expanded
K/V) for CPU tensors and launches the CUDA kernel (csrc/flash_attention.cu)
for CUDA tensors; anything else raises, and there is no fallback from kernel
to plain.  Which CUDA kernel runs follows from dtype and head dim alone
(`kernel_for`): bf16 at hd 64 and 128 (the models' widths) takes the
wgmma + TMA kernel, bf16 at hd 16 and 32 the mma.sync kernel, float32 the
CUDA-core kernel.  The kernel reads K/V at head h // (H / K) itself, so nothing is
expanded on the card, and it masks keys at or past S.  Neither path pads:
a causal ragged S gives the padded reference's result as it stands, and
only the reference's refusal of a non-causal S off its block multiple is
kept, so a caller sees the reference's contract.  `launches` counts kernel
launches and nothing else; `kernel_launches` splits that count by kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

BLOCK_Q = 128           # the reference kernel's blocks: they set which
BLOCK_KV = 256          # non-causal S it refuses; the CUDA kernels tile
HEAD_DIMS = (16, 32, 64, 128)
# the C launcher's kernel ids
KERNELS = {"cuda_core_f32": 0, "mma_sync_bf16": 1, "wgmma_bf16": 2}

launches = {"flash_attention": 0}
kernel_launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    launches["flash_attention"] = 0
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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def gqa_flash_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with H % K == 0.

    Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"gqa_flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need k/v "
                         f"(B, S, K, hd) with H % K == 0")
    scale = hd ** -0.5 if scale is None else scale
    bq, bkv = min(BLOCK_Q, S), min(BLOCK_KV, S)
    if not causal and S % max(bq, bkv):
        raise ValueError("gqa_flash_attention: non-causal requires a "
                         f"block-aligned seq len, got S={S}")
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
                            v.transpose(1, 2), scale=scale, causal=causal)
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
    kernel = kernel_for(q.dtype, hd)
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, K,
        hd, float(scale), int(causal), KERNELS[kernel], stream)
    build.check(lib, code, f"flash_attention ({kernel})")
    launches["flash_attention"] += 1
    kernel_launches[kernel] += 1
    return out
