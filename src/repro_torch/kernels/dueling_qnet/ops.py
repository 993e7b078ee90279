"""Wrapper of the fused dueling-qnet kernel.

`qnet_forward` takes the plain version (ref.py) for CPU tensors and launches
the CUDA kernel (csrc/dueling_qnet.cu) for CUDA tensors; anything else
raises.  There is no fallback from kernel to plain.  `launches` counts the
kernel's launches and nothing else; `launches_by_rows` splits them by the
batch's row count N, `launches_by_shape` by agents G and rows N.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref

launches = {"dueling_qnet": 0}
launches_by_rows: dict[int, int] = {}
launches_by_shape: dict[str, int] = {}     # "G=45 N=64": agents, rows

_KEYS = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")


def reset_launches() -> None:
    launches["dueling_qnet"] = 0
    launches_by_rows.clear()
    launches_by_shape.clear()


def _lib():
    lib = build.load("dueling_qnet")
    fn = lib.dueling_qnet_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def qnet_forward(params: dict, states: torch.Tensor) -> torch.Tensor:
    """params: dueling param dict (w0, b0, w1, b1, w_v, b_v, w_a, b_a), each
    with a leading agent axis G; states: (G, N, S).  Returns Q (G, N, A)."""
    ws = [params[k] for k in _KEYS]
    if states.device.type == "cpu":
        return dueling_qnet_ref(states, *ws)
    if states.device.type != "cuda":
        raise ValueError(f"qnet_forward: unsupported device {states.device}")
    G, N, S = states.shape
    H1, H2, A = ws[0].shape[2], ws[2].shape[2], ws[6].shape[2]
    expect = [(G, S, H1), (G, H1), (G, H1, H2), (G, H2), (G, H2, 1), (G, 1),
              (G, H2, A), (G, A)]
    x = states.to(torch.float32).contiguous()
    ws = [w.detach().contiguous() for w in ws]
    for k, w, shape in zip(_KEYS, ws, expect):
        if (w.device != states.device or w.dtype != torch.float32
                or tuple(w.shape) != shape):
            raise ValueError(f"qnet_forward: {k} must be float32 {shape} on "
                             f"{states.device}, got {w.dtype} "
                             f"{tuple(w.shape)} on {w.device}")
    q = torch.empty((G, N, A), dtype=torch.float32, device=states.device)
    if N == 0:
        return q
    lib = _lib()
    stream = torch.cuda.current_stream(states.device).cuda_stream
    code = lib.dueling_qnet_launch(x.data_ptr(), *[w.data_ptr() for w in ws],
                                   q.data_ptr(), G, N, S, H1, H2, A, stream)
    build.check(lib, code, "dueling_qnet")
    launches["dueling_qnet"] += 1
    launches_by_rows[N] = launches_by_rows.get(N, 0) + 1
    key = f"G={G} N={N}"
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return q
