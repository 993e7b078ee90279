"""Plain-torch version of the flash-attention kernel: dense masked softmax
attention in float32, the CPU path and the yardstick the CUDA kernel
(csrc/flash_attention.cu) is held to.  Layout of
`repro/kernels/flash_attention/ref.py`."""
from __future__ import annotations

import torch

MASK_VALUE = -1e30

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
    (causal only) also hides key j from query i when j <= i - window."""
    S, S_kv, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    if window and not causal:
        raise ValueError("attention_ref: a window needs causal=True")
    if causal and S_kv != S:
        raise ValueError(f"attention_ref: causal attention needs S_kv == S, "
                         f"got S={S}, S_kv={S_kv}")
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~visible(S, S, window, q.device), MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
