"""Wrapper of the agents' clipped AdamW kernel (csrc/adamw_lanes.cu).

`adamw_lanes` takes the plain version (ref.py) for CPU tensors and launches
the CUDA kernel, once, for CUDA tensors; anything else raises, and there is
no fallback from kernel to plain.  `launches` counts kernel launches and
nothing else; `launches_by_shape` splits them by agents G and elements an
agent.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adamw_lanes import ref

launches = {"adamw_lanes": 0}
launches_by_shape: dict[str, int] = {}     # "G=45 n=31369"
MAX_LEAVES = 16      # the kernel's leaf table
MAX_ROWS = 1664      # 256-element rows of the leaves an agent (shared memory)


def reset_launches() -> None:
    launches["adamw_lanes"] = 0
    launches_by_shape.clear()


def _lib():
    lib = build.load("adamw_lanes")
    fn = lib.adamw_lanes_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return lib


def adamw_lanes(grads: dict, m: dict, v: dict, params: dict,
                bc1: torch.Tensor, bc2: torch.Tensor, lr_t: torch.Tensor, *,
                b1: float, b2: float, eps: float, weight_decay: float,
                grad_clip: float) -> tuple[dict, dict, dict]:
    """ref.adamw_lanes; on the card one launch for all agents and leaves,
    the same bits as the plain version's torch ops on the card."""
    dev = bc1.device
    if dev.type == "cpu":
        return ref.adamw_lanes(grads, m, v, params, bc1, bc2, lr_t, b1=b1,
                               b2=b2, eps=eps, weight_decay=weight_decay,
                               grad_clip=grad_clip)
    if dev.type != "cuda":
        raise ValueError(f"adamw_lanes: unsupported device {dev}")
    keys = sorted(params)
    if not 1 <= len(keys) <= MAX_LEAVES or any(
            set(t) != set(keys) for t in (grads, m, v)):
        raise ValueError(f"adamw_lanes: 1 to {MAX_LEAVES} leaves, the same "
                         f"in grads, moments and params")
    G = bc1.shape[0]
    bc1, bc2, lr_t = (t.contiguous() for t in (bc1, bc2, lr_t))
    for t in (bc1, bc2, lr_t):
        if t.device != dev or t.dtype != torch.float32 or t.shape != (G,):
            raise ValueError(f"adamw_lanes: bc1, bc2, lr_t must be float32 "
                             f"({G},) on {dev}")
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    ins = []
    for k in keys:
        ts = (grads[k], m[k], v[k], params[k])
        if any(t.device != dev or t.dtype != torch.float32
               or t.shape != params[k].shape or t.shape[0] != G for t in ts):
            raise ValueError(f"adamw_lanes: leaf {k} must be float32 "
                             f"{tuple(params[k].shape)} (G = {G}) on {dev} "
                             f"in grads, moments and params")
        ins.append([t.detach().contiguous() for t in ts])
    n = [params[k].numel() // G for k in keys]
    if sum(-(-e // 256) for e in n) > MAX_ROWS:
        raise ValueError(f"adamw_lanes: {sum(n)} elements an agent beyond "
                         f"the kernel's shared memory")
    outs = {k: [torch.empty_like(params[k],
                                 memory_format=torch.contiguous_format)
                for _ in range(3)] for k in keys}
    ptrs = (ctypes.c_void_p * (7 * len(keys)))(*[
        t.data_ptr() for k, i in zip(keys, ins) for t in i + outs[k]])
    sizes = (ctypes.c_longlong * len(keys))(*n)
    consts = (ctypes.c_float * 7)(b1, 1 - b1, b2, 1 - b2, eps, grad_clip,
                                  weight_decay)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.adamw_lanes_launch(ptrs, sizes, len(keys), G, consts,
                                  bc1.data_ptr(), bc2.data_ptr(),
                                  lr_t.data_ptr(), stream)
    build.check(lib, code, "adamw_lanes")
    launches["adamw_lanes"] += 1
    key = f"G={G} n={sum(n)}"
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return ({k: outs[k][0] for k in params}, {k: outs[k][1] for k in params},
            {k: outs[k][2] for k in params})
