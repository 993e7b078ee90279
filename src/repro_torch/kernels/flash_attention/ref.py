"""Plain-torch version of the flash-attention kernel: dense masked softmax
attention in float32, the CPU path and the yardstick the CUDA kernel
(csrc/flash_attention.cu) is held to.  Layout of
`repro/kernels/flash_attention/ref.py`."""
from __future__ import annotations

import torch

MASK_VALUE = -1e30
# Above S x S_kv = 4096 x 4096 scores a head, `attention_ref` takes
# BLOCK_ROWS query rows at a time (`_blocks`): a prefill at S 32768 would
# hold 4.3 GB of f32 scores a head at once
DENSE_MAX_SCORES = 4096 * 4096
BLOCK_ROWS = 1024

# The kernel's bars against attention_ref, by input dtype.  Elementwise:
# |got - want| <= atol + rtol |want|.  Relative L2: ||got - want|| / ||want||
# over the whole output, and over each output row (one query, one head),
# worst row.  float32 keeps the reference's 2e-5.  bfloat16 keeps its rtol
# 2e-2; the bf16 kernel also rounds P to bf16 for its P.V product, which
# moves a row with few keys by up to ~2^-9 |v|.  The bars sit at about
# twice what an f32 emulation of that rounding needs, and a kernel that
# drops one 64-key tile from a few late rows fails them
# (tests/test_torch_flash_attention.py, test_bf16_bars_*).
BARS = {torch.float32: dict(rtol=2e-5, atol=2e-5, rel_l2=1e-5,
                            row_rel_l2=1e-4),
        torch.bfloat16: dict(rtol=2e-2, atol=3e-3, rel_l2=5e-3,
                             row_rel_l2=1.5e-2)}


def compare(got, want) -> dict:
    """The kernel's output against the plain version's on the same inputs:
    max abs error, relative L2 overall and of the worst row, and whether
    all three bars of `BARS[want.dtype]` hold."""
    bar = BARS[want.dtype]
    g, w = got.double(), want.double()
    d = g - w
    row = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    out = dict(max_abs_err=float(d.abs().max()),
               rel_l2=float(d.norm() / w.norm().clamp_min(1e-30)),
               row_rel_l2=float(row.max()))
    out["ok"] = bool(
        (d.abs() <= bar["atol"] + bar["rtol"] * w.abs()).all()
        and out["rel_l2"] <= bar["rel_l2"]
        and out["row_rel_l2"] <= bar["row_rel_l2"])
    return out


# The backward kernels' bars against autograd through `attention_ref`, by
# input dtype, on each of dq, dk, dv: elementwise |got - want| <= atol_frac
# x max |want| + rtol |want|, and relative L2 over the whole tensor.  A dK
# or dV entry sums up to H/K x S products (16384 at minitron-8b's shape)
# in another order than autograd's, so the absolute error of the small
# entries scales with the tensor's range, not with each entry: float32
# keeps BARS[float32]'s rtol and relative L2 (2e-5, 1e-5) and takes its
# atol as 1e-5 x max |want| (the card read 3.8e-5 max abs, relative L2
# 2.5e-6 at that shape, against an atol of 2e-5 fixed).  The per-row part
# is left out: the first query's dq row is exactly 0 (one visible key),
# and the kernel's D and dP round it to ~1e-7.  bfloat16: the kernel
# takes D = rowsum(dO o) from the bf16 output o, where autograd uses its
# float32 value, and both round the gradients to bf16; an f32 emulation of
# the kernel reads 2.7e-3 relative L2 and 0.0042 x max |want| at S 1024
# (tests/test_torch_backward.py holds it), the bars sit about 3x above.
GRAD_BARS = {torch.float32: dict(rtol=2e-5, atol_frac=1e-5, rel_l2=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol_frac=1e-2, rel_l2=1e-2)}


def compare_grad(got, want) -> dict:
    """A backward kernel's gradient against the plain version's: max abs
    error, relative L2, and whether both bars of `GRAD_BARS[want.dtype]`
    hold."""
    bar = GRAD_BARS[want.dtype]
    g, w = got.double(), want.double()
    d = g - w
    atol = bar["atol_frac"] * float(w.abs().max())
    out = dict(max_abs_err=float(d.abs().max()),
               rel_l2=float(d.norm() / w.norm().clamp_min(1e-30)))
    out["ok"] = bool((d.abs() <= atol + bar["rtol"] * w.abs()).all()
                     and out["rel_l2"] <= bar["rel_l2"])
    return out


def visible(sq: int, skv: int, window: int = 0, device=None):
    """(sq, skv) bool: key j is visible to query i iff j <= i and, with a
    window, j > i - window (the reference's `_mask`,
    src/repro/models/attention.py:72-80)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    m = ki <= qi
    if window:
        m &= ki > qi - window
    return m


def attention_ref(q, k, v, scale: float | None = None, causal: bool = True,
                  window: int = 0):
    """q: (B, H, S, hd), k, v: (B, H, S_kv, hd) -> (B, H, S, hd), float32
    math, output in q's dtype.  Causal needs S_kv == S; `window` > 0
    (causal only) also hides key j from query i when j <= i - window.
    Dense up to DENSE_MAX_SCORES scores a head, then BLOCK_ROWS query rows
    at a time (`_blocks`), so the f32 scores stay (B, H, BLOCK_ROWS, S_kv)
    at most."""
    S, S_kv, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    if window and not causal:
        raise ValueError("attention_ref: a window needs causal=True")
    if causal and S_kv != S:
        raise ValueError(f"attention_ref: causal attention needs S_kv == S, "
                         f"got S={S}, S_kv={S_kv}")
    if S * S_kv > DENSE_MAX_SCORES:
        return _blocks(q, k, v, scale, causal, window, BLOCK_ROWS)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~visible(S, S, window, q.device), MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _blocks(q, k, v, scale, causal, window, rows: int):
    """`attention_ref` `rows` query rows at a time (`_rows`)."""
    S = q.shape[2]
    return torch.cat([_rows(q, k, v, scale, causal, window, r0,
                            min(r0 + rows, S))
                      for r0 in range(0, S, rows)], dim=2)


def _rows(q, k, v, scale, causal, window, r0, r1):
    """Query rows r0..r1 - 1 of `attention_ref` against only the keys they
    can see (causal: up to r1 - 1, with a window from r0's oldest key):
    the same rows summed over fewer (masked) zeros.  Made for long S on
    the CPU: the scale is applied inside the product (`baddbmm`'s alpha)
    and the mask written in place over the keys it can hide, each a pass
    over the scores less."""
    B, H, _, hd = q.shape
    lo, hi = 0, k.shape[2]
    if causal:
        hi = r1
        if window:
            lo = max(0, r0 - window + 1)
    n, m = r1 - r0, hi - lo
    qb = q[:, :, r0:r1].float().reshape(B * H, n, hd)
    kb = k[:, :, lo:hi].float().reshape(B * H, m, hd)
    s = torch.baddbmm(qb.new_zeros(1, 1, 1), qb, kb.transpose(1, 2), beta=0,
                      alpha=scale).view(B, H, n, m)
    if causal:
        c0 = lo if window else r0       # keys left of c0 are all visible
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        ki = torch.arange(c0, hi, device=q.device)[None, :]
        hidden = ki > qi
        if window:
            hidden |= ki <= qi - window
        s[..., c0 - lo:].masked_fill_(hidden, MASK_VALUE)
    p = torch.softmax(s, dim=-1).view(B * H, n, m)
    vb = v[:, :, lo:hi].float().reshape(B * H, m, hd)
    return torch.bmm(p, vb).view(B, H, n, hd).to(q.dtype)


def attention_grads_ref(q, k, v, do, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """The plain version of the backward: out, dq, dk, dv by autograd
    through `attention_ref` on the GQA-expanded K/V (layout (B, S, heads,
    hd), as `gqa_flash_attention_kv`), on whatever device the inputs are."""
    H, K = q.shape[2], k.shape[2]
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
        out = attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                            vv.transpose(1, 2), scale=scale, causal=causal,
                            window=window).transpose(1, 2)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    return out.detach(), dq, dk, dv
