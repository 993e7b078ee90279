"""Fundamental layers, forward only (port of `repro/models/layers.py`):
RMSNorm, RoPE, the SwiGLU and GELU MLPs, embeddings.

Pure functions over explicit parameter dicts.  Parameters are bf16; norms
and softmax accumulate in fp32.  The `init_*` functions draw from a
`torch.Generator` on the given device and return (params, roles), as the
reference's: `roles` mirrors params, each leaf a tuple naming the semantic
axis of each tensor dim, which `sharding/policies.py` maps onto a mesh:

  embed      d_model                  vocab     (padded) vocabulary
  ff         dense FFN hidden         qheads    merged H * hd
  kvheads    merged K * hd            inner     mamba d_inner
  inner_proj mamba in-projection      conv_ch   mamba conv channels
  experts    MoE expert index         expert_ff MoE expert hidden
  heads      per-head vectors         None      never sharded

The reference's custom VJP of RMSNorm has no counterpart (autograd
differentiates the same ops).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import (is_dtensor, on_local_shards,
                                          replicate_like)

DTYPE = torch.bfloat16


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(DTYPE)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device):
    return ({"scale": torch.ones((d,), dtype=DTYPE, device=device)},
            {"scale": ("embed",)})


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


def l2norm(x, eps=1e-6):
    """Per-head qk-norm (qwen3)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,) or broadcastable."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (S, hd/2)
    cos = replicate_like(x, torch.cos(angles)[..., :, None, :])  # (S,1,hd/2)
    sin = replicate_like(x, torch.sin(angles)[..., :, None, :])
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Remat's saved outputs
# ---------------------------------------------------------------------------

_REMAT = {"store": None}


class RematStore:
    """The outputs that a remat policy keeps of one checkpointed
    super-block: the products of `linear` (mode "block", the reference's
    `dots_with_no_batch_dims_saveable`) or the outputs named by
    `checkpoint_name` (mode "collectives").  The checkpoint's forward
    records them; its re-forward in the backward takes them back in the
    same order instead of computing them, and computes the rest again.
    Only the marked sites look at the store: no dispatch mode sees the
    other ops."""

    def __init__(self, mode: str):
        self.mode = mode
        self.outs = []
        self.recorded = False
        self.pos = None             # None: recording; else replaying

    def run(self, fn, *args):
        """fn(*args) with this store active (the checkpoint's function):
        the first call records, a later one replays."""
        old = _REMAT["store"]
        _REMAT["store"] = self
        self.pos = 0 if self.recorded else None
        try:
            return fn(*args)
        finally:
            _REMAT["store"] = old
            self.recorded = True

    def take(self, compute):
        """compute()'s output, recorded; in the re-forward, the recorded
        one (each handed back once)."""
        if self.pos is None:
            y = compute()
            self.outs.append(y.detach())
            return y
        y, self.outs[self.pos] = self.outs[self.pos], None
        self.pos += 1
        return y


def remat_store(mode: str):
    """The active store when it keeps `mode`'s outputs and autograd
    records, else None."""
    st = _REMAT["store"]
    if st is None or st.mode != mode or not torch.is_grad_enabled():
        return None
    return st


class _SavedProduct(torch.autograd.Function):
    """x @ w (both 2-D), its output kept by a `RematStore`; the backward
    is autograd's own for `mm` (the transposed forms where an operand is
    column-major, as `mm_mat1_backward` / `mm_mat2_backward`)."""

    @staticmethod
    def forward(ctx, x, w, store):
        ctx.save_for_backward(x, w)
        return store.take(lambda: x @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (w.mm(g.t()).t() if _column_major(x)
                  else g.mm(w.t()))
        if ctx.needs_input_grad[1]:
            gw = (g.t().mm(x).t() if _column_major(w)
                  else x.t().mm(g))
        return gx, gw, None


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def _column_major(t) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def _product(x2, w):
    """x2 @ w of 2-D x2, kept under remat "block"."""
    st = remat_store("block")
    if st is None:
        return x2 @ w
    return _SavedProduct.apply(x2, w, st)


def linear(x, w):
    """x @ w over x's last dim.  A DTensor x of more than two dims is folded
    to rows here, and the product's rows are gathered over any mesh dim
    whose sharding of them x's leading dim does not divide: DTensor's
    matmul may cut the folded rows over an axis (a batch of 16 rows over
    32 data ranks, each holding half a sequence) that its view back to
    (B, S, F) cannot express.  Plain tensors: x @ w.  Under remat "block"
    the product is kept (`RematStore`)."""
    if x.ndim <= 2:
        return _product(x, w)
    if not is_dtensor(x):
        if remat_store("block") is None:
            return x @ w
        lead = tuple(x.shape[:-1])
        return _product(x.reshape(-1, x.shape[-1]), w).view(
            lead + (w.shape[-1],))
    lead = tuple(x.shape[:-1])
    mesh = x.device_mesh
    x2 = x.reshape(-1, x.shape[-1])
    n_data = 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n_data *= mesh.size(i) if name != "model" else 1
    if lead[0] % n_data:
        # the fold's gradient held to x's placements: the backward's
        # unflatten never meets rows cut across a batch row
        pl = tuple(x2.placements)
        x2 = on_local_shards(lambda t: t, (x2,), (pl,), pl)
    y = _product(x2, w)
    cut = [i for i, p in enumerate(y.placements) if p.is_shard(0)]
    n = 1
    for i in cut:
        n *= mesh.size(i)
    if cut and lead[0] % n:
        # (a pending partial sum is reduced with it: a redistribution may
        # not lead back to Partial in the backward)
        from torch.distributed.tensor import Replicate
        y = y.redistribute(mesh, [Replicate() if i in cut or p.is_partial()
                                  else p for i, p in enumerate(y.placements)])
    return y.reshape(lead + (w.shape[-1],))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, swiglu: bool = True):
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    params = {"w_gate": _normal(gen, (d_model, d_ff), s_in)} if swiglu else {}
    params["w_up"] = _normal(gen, (d_model, d_ff), s_in)
    params["w_down"] = _normal(gen, (d_ff, d_model), s_out)
    roles = {k: ("embed", "ff") for k in params}
    roles["w_down"] = ("ff", "embed")
    return params, roles


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh approximation (torch's own default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(params, x, swiglu: bool = True):
    """SwiGLU, or (swiglu False, whisper) gelu(x w_up) w_down."""
    if not swiglu:
        return linear(gelu(linear(x, params["w_up"])),
                      params["w_down"]).to(x.dtype)
    g = F.silu(linear(x, params["w_gate"]))
    return linear(g * linear(x, params["w_up"]), params["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab_padded: int, d_model: int):
    return ({"table": _normal(gen, (vocab_padded, d_model), 1.0)},
            {"table": ("vocab", "embed")})


def embed(params, tokens):
    """The table's rows.  On a DTensor table the gather runs on each
    rank's local shards (the same gather, and backward, as without a
    mesh): a vocabulary sharded over mesh dims is gathered from each
    rank's slice of it, the tokens outside the slice giving zero rows, and
    the rows are a partial sum over those dims with one term, as
    Megatron's vocab-parallel embedding, reduced at once; the table's
    other dims are gathered whole first (FSDP).  (DTensor's own `F.embedding` rule keeps
    a masked partial that torch 2.11 cannot reduce twice, as a block and
    its remat re-forward do.)"""
    table = params["table"]
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.context import batch_heads_placements
    mesh = table.device_mesh
    rows = batch_heads_placements(mesh, tokens.shape[0])
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    t_in = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    t_grad = tuple(Shard(0) if i in vocab else Partial() if r.is_shard()
                   else Replicate() for i, r in enumerate(rows))
    out = tuple(Partial() if i in vocab else r for i, r in enumerate(rows))
    n_loc, block = table.shape[0], 0
    for i in vocab:                 # major to minor, in mesh order
        n_loc //= mesh.size(i)
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    lo = block * n_loc

    def local(t, idx):
        if not vocab:
            return t[idx]
        j = idx - lo
        inside = (j >= 0) & (j < n_loc)
        got = t[j.clamp(0, n_loc - 1)]
        return got * inside[..., None].to(got.dtype)

    got = on_local_shards(local, (table, tokens), (t_in, rows), out,
                          (t_grad, rows))
    # the one-term sum taken at once: a block's input replicated over the
    # vocabulary's dims (left partial, DTensor's later choices for the
    # residual stream moved 1.60 TB of collectives a card in minitron-8b's
    # dry run on (16, 16) under torch 2.11, against 0.27 TB reduced here)
    return got.redistribute(mesh, rows) if vocab else got


def init_lm_head(gen, d_model: int, vocab_padded: int):
    return ({"w": _normal(gen, (d_model, vocab_padded), d_model ** -0.5)},
            {"w": ("embed", "vocab")})
