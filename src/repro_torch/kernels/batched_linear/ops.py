"""Wrappers of the batch-invariant TD-step kernels (csrc/batched_linear.cu).

`bgemm`, `bgemm_colsum` and `sq_norm` take the plain version (ref.py) for
CPU tensors and launch their CUDA kernel, once, for CUDA tensors; anything
else raises, and there is no fallback from kernel to plain.  `linear` is
the dense layer of the agents' Q network with its gradient: on the card an
autograd function whose forward (product and bias) is one launch and whose
backward is one launch for the input gradient and one for the weight and
bias gradients together, so agent g's gradients are the same bits whether
it trains alone or beside 44 other agents; on the CPU the plain
`x @ w + b`.  `launches` counts kernel launches and nothing else;
`launches_by_shape` splits them by kernel and shape.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched_linear import ref

launches = {"batched_linear": 0}
launches_by_shape: dict[str, int] = {}
MAX_LEAVES = 16     # sq_norm's leaves per launch (the kernel's table)

_ARGTYPES = {
    "bgemm_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
    "sq_norm_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2,
}
_FNS: dict[str, object] = {}     # launcher name -> ctypes function


def reset_launches() -> None:
    launches["batched_linear"] = 0
    launches_by_shape.clear()


def _call(name: str, key: str, dev: torch.device, *args) -> None:
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("batched_linear"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    code = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if code:
        build.check(build.load("batched_linear"), code, name)
    launches["batched_linear"] += 1
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"batched_linear: unsupported device {dev}")
    for t in ts:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"batched_linear: float32 tensors on one device "
                             f"expected, got {t.dtype} on {t.device}")
    return dev.type == "cpu"


def _bgemm(a, b, bias, colsum: bool):
    G, M, K = a.shape
    if b.shape[0] != G or b.shape[1] != K or (
            bias is not None and bias.shape != (G, b.shape[2])):
        raise ValueError(f"bgemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[2]
    c = torch.empty((G, M, N), dtype=torch.float32, device=a.device)
    s = (torch.empty((G, N), dtype=torch.float32, device=a.device)
         if colsum else None)
    bias = None if bias is None else bias.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    _call("bgemm_launch", f"bgemm{'+colsum' if colsum else ''}"
          f"{'+bias' if bias is not None else ''} G={G} {M}x{K}x{N}",
          a.device, a.data_ptr(), b.data_ptr(), ptr(bias), c.data_ptr(),
          ptr(s), G, M, N, K, *a.stride(), *b.stride())
    return c, s


def bgemm(a: torch.Tensor, b: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) [+ bias (G, N) on every row] -> (G, M, N);
    `a` and `b` may be transposed views (any strides)."""
    if _on_cpu(a, b, *(() if bias is None else (bias,))):
        return ref.bgemm(a, b, bias)
    return _bgemm(a, b, bias, False)[0]


def bgemm_colsum(a: torch.Tensor, b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a @ b (G, M, N), b summed over its K axis (G, N)) in one launch:
    a layer's weight gradient x^T dy and bias gradient sum_n dy."""
    if _on_cpu(a, b):
        return ref.bgemm_colsum(a, b)
    return _bgemm(a, b, None, True)


def sq_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """(G,) sqrt of the sum, over the leaves (G, ...) in order, of each
    agent's sum of squares."""
    if _on_cpu(*leaves):
        return ref.sq_norm(leaves)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"sq_norm: 1 to {MAX_LEAVES} leaves, got "
                         f"{len(leaves)}")
    G = leaves[0].shape[0]
    if any(t.shape[0] != G for t in leaves):
        raise ValueError("sq_norm: leaves with different agent counts")
    leaves = [t.contiguous() for t in leaves]
    out = torch.empty((G,), dtype=torch.float32, device=leaves[0].device)
    L = len(leaves)
    ptrs = (ctypes.c_void_p * L)(*(t.data_ptr() for t in leaves))
    sizes = (ctypes.c_longlong * L)(*(t.numel() // max(G, 1)
                                       for t in leaves))
    _call("sq_norm_launch", f"sq_norm G={G} leaves={L}", out.device, ptrs,
          sizes, L, G, out.data_ptr())
    return out


class _Linear(torch.autograd.Function):
    """y = x @ w + b with the kernels' products and sums both ways."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _bgemm(x, w, b, False)[0]

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (_bgemm(dy, w.transpose(1, 2), None, False)[0]
              if ctx.needs_input_grad[0] else None)
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _bgemm(x.transpose(1, 2), dy, None, True)
        return dx, dw, db


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (G, N, K) @ w (G, K, H) + b (G, H), differentiable."""
    if _on_cpu(x, w, b):
        return ref.linear(x, w, b)
    return _Linear.apply(x, w, b)
