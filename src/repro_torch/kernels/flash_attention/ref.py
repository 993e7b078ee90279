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


def attention_ref(q, k, v, scale: float | None = None, causal: bool = True):
    """q, k, v: (B, H, S, hd) -> (B, H, S, hd), float32 math, output in
    q's dtype."""
    S, hd = q.shape[2], q.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
