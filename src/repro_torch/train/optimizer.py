"""Optimizers in plain torch (port of `repro/train/optimizer.py`).

  - adamw(lr, ...)            AdamW with an optional schedule
  - quantized_adamw(...)      AdamW whose moments are stored as blockwise
                              int8 (+ f32 scales): 4x less optimizer state
  - sgd(lr)                   plain SGD
  - cosine_schedule, constant_schedule, global_norm

All follow the reference's (init, update) protocol:
    state = init(params)
    new_params, new_state = update(grads, state, params, step)
over trees of nested dicts and lists of tensors (a model's parameters, in
the port's layout).  The math is the reference's, op for op, in float32.

`adamw` has two forms, told apart by the rank of `step`.  With a 0-d step
(the trainer's) it is the reference's: one global norm over every leaf
clips the gradients.  With a (B,) step it is the agent's: every leaf of a
flat dict carries a leading agent axis B, each agent clips by its own norm
(`lane_global_norm`, one `batched_linear.sq_norm` launch on the card), as
the reference's per-lane vmap does; that form is unchanged from the agent's
port and held `==` by its tests.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.batched_linear.ops import sq_norm

Tree = Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


# ---------------------------------------------------------------------------
# Schedules and norms
# ---------------------------------------------------------------------------

# the tree form of adamw updates a leaf in flat pieces of at most this many
# elements, and global_norm squares it so, so the temporaries of the
# largest leaf (an embedding of 1e9 values) stay a few hundred MB
UPDATE_PIECE = 1 << 26


def constant_schedule(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def cosine_schedule(lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (min_frac + (1 - min_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return sched


def global_norm(tree: Tree) -> torch.Tensor:
    """The 0-d L2 norm over every leaf of `tree`, in float32, the squares
    summed leaf by leaf in the reference's leaf order (a leaf of more than
    UPDATE_PIECE values piece by piece, so its f32 square is never made
    whole)."""
    total = None
    for leaf in tree_leaves(tree):
        for piece in leaf.reshape(-1).split(UPDATE_PIECE):
            sq = torch.sum(torch.square(piece.to(torch.float32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def lane_global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) global L2 norm of each agent's leaves, summed in the reference's
    leaf order (sorted keys, as jax.tree flattens a dict), as one
    `batched_linear.sq_norm`: on the card one launch whose order does not
    depend on the number of agents B."""
    return sq_norm([tree[k].to(torch.float32) for k in sorted(tree)])


def _clip_scale(grads: Tree, grad_clip: float):
    """The reference's global-norm clip factor of the gradients (float32),
    or None without clipping."""
    if grad_clip <= 0:
        return None
    return torch.clamp(grad_clip / (global_norm(grads) + 1e-9), max=1.0)


def _f32_grad(g: torch.Tensor, scale) -> torch.Tensor:
    g = g.to(torch.float32)
    return g if scale is None else g * scale


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update_tree(grads, state, params, step):
        """The reference's update, leaf by leaf and in flat pieces, writing
        the new moments and parameters into `state` and `params` in place
        (the reference's arrays are immutable; updating in place spares a
        second copy of the 12 bytes of a parameter's f32 moments and its
        weights).  Returns them."""
        scale = _clip_scale(grads, grad_clip)
        t = step.to(torch.float32) + 1.0
        lr_t = sched(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def upd(p, g, m, v):
            pieces = [x.view(-1).split(UPDATE_PIECE) for x in (p, m, v)]
            for ps, gs, ms, vs in zip(pieces[0],
                                      g.reshape(-1).split(UPDATE_PIECE),
                                      pieces[1], pieces[2]):
                gs = _f32_grad(gs, scale)
                ms.mul_(b1).add_((1 - b1) * gs)
                vs.mul_(b2).add_((1 - b2) * gs * gs)
                delta = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
                if weight_decay:
                    delta = delta + weight_decay * ps.to(torch.float32)
                ps.copy_((ps.to(torch.float32) - lr_t * delta).to(p.dtype))
            return p

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    def update_lanes(grads, state, params, step):
        grads = {k: g.to(torch.float32) for k, g in grads.items()}
        if grad_clip > 0:
            gnorm = lane_global_norm(grads)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            grads = {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                     for k, g in grads.items()}
        t = step.to(torch.float32) + 1.0
        lr_t = sched(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            shape = (-1,) + (1,) * (g.dim() - 1)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            mh = m / bc1.reshape(shape)
            vh = v / bc2.reshape(shape)
            delta = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32)
                        - lr_t.reshape(shape) * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}

    def update(grads, state, params, step):
        if step.dim() == 0:
            return update_tree(grads, state, params, step)
        return update_lanes(grads, state, params, step)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Int8 blockwise-quantized AdamW (optimizer-state compression)
# ---------------------------------------------------------------------------

_QBLOCK = 256
_VLOG_FLOOR = 1e-16


def quantizable(shape) -> bool:
    """Blockwise-int8 eligible: the last dim divides into blocks of 256 (a
    local reshape, so sharding on every other dim would survive)."""
    return len(shape) >= 1 and shape[-1] % _QBLOCK == 0


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 along the last dim: x (..., F) -> q (...,
    F/256, 256) int8, scale (..., F/256) f32."""
    F = x.shape[-1]
    xb = x.reshape(*x.shape[:-1], F // _QBLOCK, _QBLOCK)
    scale = xb.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).reshape(shape)


def _q8_log(x: torch.Tensor):
    """Blockwise asymmetric int8 in log space, for the non-negative second
    moment (a linear code would zero its small entries and blow up 1 /
    sqrt(v)).  x (..., F) >= 0 -> q int8, lo, scale (..., F/256) f32."""
    F = x.shape[-1]
    lx = torch.log(x.reshape(*x.shape[:-1], F // _QBLOCK, _QBLOCK)
                   + _VLOG_FLOOR)
    lo = lx.amin(dim=-1)
    hi = lx.amax(dim=-1)
    scale = (hi - lo) / 254.0 + 1e-12
    q = torch.clamp(torch.round((lx - lo[..., None]) / scale[..., None])
                    - 127, -127, 127)
    return q.to(torch.int8), lo.to(torch.float32), scale.to(torch.float32)


def _dq8_log(q, lo, scale, shape) -> torch.Tensor:
    lx = (q.to(torch.float32) + 127.0) * scale[..., None] + lo[..., None]
    return torch.clamp(torch.exp(lx) - _VLOG_FLOOR, min=0.0).reshape(shape)


def quantized_adamw(lr: float | Callable = 1e-3, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0,
                    grad_clip: float = 0.0) -> Optimizer:
    """AdamW whose m / v moments are stored as blockwise int8 (+ f32
    scales): per leaf {mq, ms, vq, v_lo, v_sc} where the last dim divides
    into blocks of 256, else plain f32 {m, v}.  Dequantize, update,
    requantize each step (a 0-d step)."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        def one(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if quantizable(p.shape):
                q, s = _q8(z)
                vq, vlo, vsc = _q8_log(z)
                return {"mq": q, "ms": s, "vq": vq, "v_lo": vlo, "v_sc": vsc}
            return {"m": z, "v": z.clone()}

        return tree_map(one, params)

    def update(grads, state, params, step):
        """The reference's update, written into `params` and `state` in
        place, a quantized leaf by slices of whole rows (at most
        UPDATE_PIECE values; the int8 blocks run along the last dim, so a
        slice quantizes as the whole would) and a plain one in flat
        pieces.  Returns them."""
        scale = _clip_scale(grads, grad_clip)
        t = step.to(torch.float32) + 1.0
        lr_t = sched(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def adam(p, g, m, v):
            """New (p, m, v) of f32 m, v and a piece of p and g."""
            g = _f32_grad(g, scale)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * delta).to(p.dtype), m, v

        def upd(p, g, st):
            if "mq" not in st:
                pieces = [x.view(-1).split(UPDATE_PIECE)
                          for x in (p, st["m"], st["v"])]
                for ps, gs, ms, vs in zip(pieces[0],
                                          g.reshape(-1).split(UPDATE_PIECE),
                                          pieces[1], pieces[2]):
                    for old, new in zip((ps, ms, vs), adam(ps, gs, ms, vs)):
                        old.copy_(new)
                return p
            F = p.shape[-1]
            R = p.numel() // F
            rows = max(1, UPDATE_PIECE // F)
            p2, g2 = p.view(R, F), g.reshape(R, F)
            mq, vq = (st[k].view(R, F // _QBLOCK, _QBLOCK) for k in ("mq",
                                                                     "vq"))
            ms, vlo, vsc = (st[k].view(R, F // _QBLOCK)
                            for k in ("ms", "v_lo", "v_sc"))
            for r0 in range(0, R, rows):
                sl = slice(r0, r0 + rows)
                n = p2[sl].shape[0]
                m = _dq8(mq[sl], ms[sl], (n, F))
                v = _dq8_log(vq[sl], vlo[sl], vsc[sl], (n, F))
                newp, m, v = adam(p2[sl], g2[sl], m, v)
                p2[sl].copy_(newp)
                for dst, src in zip((mq[sl], ms[sl]), _q8(m)):
                    dst.copy_(src)
                for dst, src in zip((vq[sl], vlo[sl], vsc[sl]), _q8_log(v)):
                    dst.copy_(src)
            return p

        tree_map(upd, params, grads, state)
        return params, state

    return Optimizer(init, update)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        return tree_map(lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype),
                        params, grads), state

    return Optimizer(init, update)
