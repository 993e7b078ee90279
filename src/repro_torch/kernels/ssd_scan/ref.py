"""Plain-torch versions of the SSD scan (layout of
`repro/kernels/ssd_scan/ref.py`).

`ssd_ref` is the sequential state-space recurrence, the oracle:

    y_t = C_t . S_t   with   S_t = exp(dt_t * A) S_{t-1} + B_t (x) (dt_t x_t)

`ssd_chunked` computes the same function chunk by chunk, in the order of the
Pallas kernel (`_ssd_kernel`) and of the model's `chunk_step`
(`repro/models/mamba.py`): it is the CPU path of `ops.ssd` and the plain
version the CUDA kernel (csrc/ssd_scan.cu) is held to.  (The D-skip and the
gating live outside the kernel, in the model layer.)
"""
from __future__ import annotations

import torch

CLIP = 60.0


def ssd_ref(x, b, c, dt, a):
    """x: (B, L, H, P); b, c: (B, L, N); dt: (B, L, H); a: (H,) negative.
    Returns (B, L, H, P), float32."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    x, b, c, dt, a = (t.float() for t in (x, b, c, dt, a))
    S = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * a)                          # (B, H)
        S = S * decay[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", b[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], S))
    return torch.stack(ys, dim=1)


def _clip_exp(z):
    return torch.exp(torch.clamp(z, -CLIP, 0.0))


def ssd_chunked(x, b, c, dt, a, *, chunk: int):
    """The chunked SSD scan in float32; same arguments as `ssd_ref`, with
    L % chunk == 0.  Returns (B, L, H, P), float32."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    Q = chunk
    nc = L // Q
    xc = x.float().reshape(Bsz, nc, Q, H, P)
    bc = b.float().reshape(Bsz, nc, Q, N)
    cc = c.float().reshape(Bsz, nc, Q, N)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    a = a.float()
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    R = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        x_i, B_i, C_i, dt_i = xc[:, ci], bc[:, ci], cc[:, ci], dtc[:, ci]
        seg = torch.cumsum(dt_i * a, dim=1)                      # (B, Q, H)
        seg_end = seg[:, -1:, :]
        # intra-chunk masked quadratic (the "attention-like" SSD term)
        CB = torch.einsum("bin,bjn->bij", C_i, B_i)              # (B, Q, Q)
        decay = _clip_exp(seg[:, :, None, :] - seg[:, None, :, :])
        att = CB[..., None] * decay * mask[None, ..., None]      # (B,Q,Q,H)
        att = att * dt_i[:, None, :, :]                          # weight dt_j
        y_intra = torch.einsum("bijh,bjhp->bihp", att, x_i)
        # contribution of the running inter-chunk state
        y_inter = torch.einsum("bin,bih,bhnp->bihp", C_i, _clip_exp(seg), R)
        # update the running state
        state_w = _clip_exp(seg_end - seg) * dt_i
        S = torch.einsum("bjn,bjh,bjhp->bhnp", B_i, state_w, x_i)
        R = R * _clip_exp(seg_end[:, 0, :])[:, :, None, None] + S
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P)


def ssd_grads_ref(x, b, c, dt, a, dy, *, chunk: int):
    """The plain version of the backward: dx, db, dc, ddt, da by autograd
    through `ssd_chunked`, on whatever device the inputs are."""
    xs = [t.detach().requires_grad_() for t in (x, b, c, dt, a)]
    with torch.enable_grad():
        y = ssd_chunked(*xs, chunk=chunk)
        return torch.autograd.grad(y, xs, dy)
