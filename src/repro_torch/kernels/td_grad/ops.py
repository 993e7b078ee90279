"""Wrapper of the agents' TD-step kernel (csrc/td_grad.cu).

`td_grad` takes the plain version (ref.py) for CPU tensors and launches the
CUDA kernel, once, for CUDA tensors; anything else raises, and there is no
fallback from kernel to plain.  `covers` is the shape rule the caller
routes by: the kernel takes the paper's network (dueling head over two
hidden layers of 128, 8 actions) at 64 replay rows and a state of at most
`MAX_STATE` features; `dqn.td_loss_and_grads` sends every other shape to
the plain version, which on the card runs `batched_linear`'s products.
`launches` counts kernel launches and nothing else; `launches_by_shape`
splits them by agents G and state width S.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.td_grad import ref

launches = {"td_grad": 0}
launches_by_shape: dict[str, int] = {}     # "G=45 S=106"

KEYS = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")
ROWS, HIDDEN, ACTIONS = 64, 128, 8
MAX_STATE = 300     # the kernel's shared-memory plan holds S <= 300


def reset_launches() -> None:
    launches["td_grad"] = 0
    launches_by_shape.clear()


def covers(params: dict, s: torch.Tensor) -> bool:
    """Whether the kernel takes this network and minibatch s (G, N, S)."""
    if set(params) != set(KEYS) or s.dim() != 3:
        return False
    G, N, S = s.shape
    want = {"w0": (G, S, HIDDEN), "b0": (G, HIDDEN),
            "w1": (G, HIDDEN, HIDDEN), "b1": (G, HIDDEN),
            "w_v": (G, HIDDEN, 1), "b_v": (G, 1),
            "w_a": (G, HIDDEN, ACTIONS), "b_a": (G, ACTIONS)}
    return (N == ROWS and 1 <= S <= MAX_STATE
            and all(tuple(params[k].shape) == v for k, v in want.items()))


def _lib():
    lib = build.load("td_grad")
    fn = lib.td_grad_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (bulk copies need both)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def td_grad(params: dict, s: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
            w: torch.Tensor, ready: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss (G,), gradients) of ref.td_grad; on the card one launch for
    all G agents, each agent's results the same bits at any G."""
    dev = s.device
    if dev.type == "cpu":
        return ref.td_grad(params, s, a, y, w, ready, cfg)
    if dev.type != "cuda":
        raise ValueError(f"td_grad: unsupported device {dev}")
    if not covers(params, s):
        raise ValueError(f"td_grad: the kernel does not cover state "
                         f"{tuple(s.shape)} with leaves "
                         f"{ {k: tuple(t.shape) for k, t in params.items()} }")
    G, _, S = s.shape
    floats = [s, y, w, ready] + [params[k] for k in KEYS]
    if any(t.device != dev or t.dtype != torch.float32 for t in floats) or (
            a.device != dev or a.dtype != torch.int32):
        raise ValueError("td_grad: float32 tensors and int32 actions on one "
                         "device expected")
    if a.shape != (G, ROWS) or y.shape != (G, ROWS) or w.shape != (G, ROWS) \
            or ready.shape != (G,):
        raise ValueError(f"td_grad: a, y, w must be ({G}, {ROWS}) and ready "
                         f"({G},)")
    ins = [_aligned(t.detach()) for t in (s, a, y, w, ready)] + [
        _aligned(params[k].detach()) for k in KEYS]
    loss = torch.empty((G,), dtype=torch.float32, device=dev)
    grads = {k: torch.empty_like(params[k], dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k in KEYS}
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.td_grad_launch(*[t.data_ptr() for t in ins], loss.data_ptr(),
                              *[grads[k].data_ptr() for k in KEYS], G, S,
                              stream)
    build.check(lib, code, "td_grad")
    launches["td_grad"] += 1
    key = f"G={G} S={S}"
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return loss, {k: grads[k] for k in params}
