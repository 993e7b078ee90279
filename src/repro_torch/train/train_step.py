"""Training step (port of `repro/train/train_step.py`): chunked
cross-entropy (big-vocab safe), z-loss, the MoE load-balancing term,
gradient accumulation over microbatches, optional int8 gradient
compression.

The LM head over a 256k vocabulary would make (B S, V) logits at once;
the loss instead walks token chunks of CE_CHUNK, and each chunk's logits
are recomputed in the backward (`torch.utils.checkpoint`, as the
reference's `jax.checkpoint`), so only one chunk's (chunk, V) logits live
at a time.  The head's product stays `torch.matmul`, as the reference
leaves it to XLA.  On the card the model's attention and SSD layers run
their kernels forward and backward (`kernels/*/ops.py`); gradients come
from `torch.autograd.grad` over every parameter leaf.

On a mesh (`sharding/`) params, optimizer state and batch are DTensors:
each microbatch is held to `batch_shardings`, the float32 gradient
accumulator to `grad_shardings` (the ZeRO placements of
`policies.zero_shard_specs`), and the loss is a parallel loss over the
vocab-sharded head (`chunked_ce_loss`).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels import costs
from repro_torch.models.model import Model
from repro_torch.sharding.context import (batch_heads_placements, is_dtensor,
                                          on_local_shards, row_block)
from repro_torch.train.compression import compress_decompress
from repro_torch.train.optimizer import Optimizer, global_norm

CE_CHUNK = 512
# the step-cost counter (`launch/roofline.count_step_costs`) walks the loss
# in chunks this many times larger where T divides into them: the same
# products and collective bytes (bar a few scalar all-reduces of 4 bytes a
# chunk) in fewer ops to trace
COUNT_CHUNKS = 32


def chunked_ce_loss(model: Model, params, hidden, labels,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """hidden (B, S, D); labels (B, S), -100 = ignore.  Mean CE over the
    counted tokens plus z_loss x mean lse^2 (a trailing T % chunk is
    dropped, as the reference's scan does).  DTensor hidden: the same
    chunks, each rank walking its rows of every data shard, the logits
    sharded over the vocabulary with the head (`_target_logit`)."""
    B, S, D = hidden.shape
    T = B * S
    chunk = min(CE_CHUNK, T)
    if costs.active() and T % (COUNT_CHUNKS * CE_CHUNK) == 0:
        chunk = COUNT_CHUNKS * CE_CHUNK
    n_chunks = T // chunk
    if is_dtensor(hidden):
        return _sharded_ce_loss(model, params, hidden, labels, z_loss, chunk)
    hf = hidden.reshape(T, D)[:n_chunks * chunk].reshape(n_chunks, chunk, D)
    lf = labels.reshape(T)[:n_chunks * chunk].reshape(n_chunks, chunk)

    def body(h, lab):
        logits = model.logits(params, h).to(torch.float32)     # (chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, 1, lab.clamp_min(0)[:, None])[:, 0]
        mask = (lab >= 0).to(torch.float32)
        return (torch.sum((lse - tgt) * mask),
                torch.sum(torch.square(lse) * mask), torch.sum(mask))

    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    loss_sum, z_sum, count = zero, zero, zero
    for i in range(n_chunks):
        ls, zs, c = checkpoint(body, hf[i], lf[i], use_reentrant=False)
        loss_sum, z_sum, count = loss_sum + ls, z_sum + zs, count + c
    count = torch.clamp(count, min=1.0)
    return loss_sum / count + z_loss * z_sum / count


def _target_logit(logits, lab):
    """logits (dp, chunk, V) f32, the vocabulary maybe over 'model';
    labels (dp, chunk): each token's logit at its label, from the rank
    whose vocabulary slice holds it (the others add 0): Partial over
    'model' where the vocabulary is sharded."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    model_dim = (mesh.mesh_dim_names.index("model")
                 if "model" in mesh.mesh_dim_names else None)
    vocab_sharded = model_dim is not None and \
        logits.placements[model_dim] == Shard(2)
    V = logits.shape[-1]
    base = batch_heads_placements(mesh, logits.shape[0])
    l_pl = tuple(Shard(2) if i == model_dim and vocab_sharded else p
                 for i, p in enumerate(base))
    out_pl = tuple(Partial() if i == model_dim and vocab_sharded else p
                   for i, p in enumerate(base))
    n_loc = V // mesh.size(model_dim) if vocab_sharded else V
    lo = mesh.get_local_rank(model_dim) * n_loc if vocab_sharded else 0

    def local(lg, lb):
        idx = lb.clamp_min(0) - lo
        inside = (idx >= 0) & (idx < n_loc)
        got = torch.gather(lg, 2, idx.clamp(0, n_loc - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    return on_local_shards(local, (logits, lab), (l_pl, base), out_pl)


def _sharded_ce_loss(model, params, hidden, labels, z_loss, chunk):
    """`chunked_ce_loss` on DTensors: with dp data ranks and T tokens the
    rows split (dp, T / dp); each chunk step takes `chunk / dp` rows of
    every shard at once, so the steps cover the unsharded chunks' tokens
    (where T / dp divides into them)."""
    B, S, D = hidden.shape
    T = B * S
    pl = batch_heads_placements(hidden.device_mesh, B)
    dp = 1
    for i, p in enumerate(pl):
        dp *= hidden.device_mesh.size(i) if p.is_shard() else 1
    n_chunks = T // chunk
    T_used = n_chunks * chunk
    hidden = hidden.redistribute(hidden.device_mesh, pl)
    labels = labels.redistribute(labels.device_mesh, pl)
    if T_used != T or chunk % dp:
        dp = 1              # chunks that do not split over the shards
    hf = hidden.reshape(dp, T // dp, D)
    lf = labels.reshape(dp, T // dp)
    c = chunk // dp

    def body(h, lab):
        logits = model.logits(params, h).to(torch.float32)  # (dp, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = _target_logit(logits, lab)
        mask = (lab >= 0).to(torch.float32)
        return (torch.sum((lse - tgt) * mask),
                torch.sum(torch.square(lse) * mask), torch.sum(mask))

    loss_sum = z_sum = count = None
    for i in range(n_chunks):
        ls, zs, cn = checkpoint(body, hf[:, i * c:(i + 1) * c],
                                lf[:, i * c:(i + 1) * c], use_reentrant=False)
        if loss_sum is None:
            loss_sum, z_sum, count = ls, zs, cn
        else:
            loss_sum, z_sum, count = loss_sum + ls, z_sum + zs, count + cn
    count = torch.clamp(count, min=1.0)
    return loss_sum / count + z_loss * z_sum / count


def make_loss_fn(model: Model, z_loss: float = 1e-4,
                 lb_coef: float = 1e-2) -> Callable:
    """loss_fn(params, batch) -> (loss, aux): chunked CE, plus lb_coef x
    the MoE load-balancing loss over n_layers for an MoE model."""
    def loss_fn(params, batch):
        hidden, aux = model.apply(params, batch)
        loss = chunked_ce_loss(model, params, hidden, batch["labels"], z_loss)
        if model.cfg.moe is not None:
            loss = loss + lb_coef * aux.get("lb_loss", 0.0) / max(
                model.cfg.n_layers, 1)
        return loss, aux

    return loss_fn


def make_train_step(model: Model, opt: Optimizer, microbatches: int = 1,
                    grad_compression: str = "none",
                    grad_shardings: Any = None,
                    batch_shardings: Any = None) -> Callable:
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics {"loss", "grad_norm"}), `step` a 0-d tensor.

    microbatches > 1: the batch splits on axis 0 and the gradients add up in
    float32 over the microbatches, then divide (the same mathematical
    batch, a microbatch's activation memory).  grad_compression "int8":
    every gradient goes through `compress_decompress`.  On a mesh (DTensor
    params, state and batch), each microbatch is held to `batch_shardings`
    (a tree of `policies.Sharding` over the batch's keys) and the float32
    accumulator, or the gradients of one microbatch, to `grad_shardings`
    (over params: the ZeRO placements).  `adamw`'s tree form updates
    `params` and `opt_state` in place (see there)."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: 'none' or "
                         f"'int8'")
    loss_fn = make_loss_fn(model)

    def compute_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss, _ = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    def hold(tree, shardings):
        """DTensor leaves redistributed to their shardings' placements."""
        if shardings is None:
            return tree
        return tree_map(lambda t, s: t.redistribute(t.device_mesh,
                                                    s.placements)
                        if is_dtensor(t) and tuple(t.placements)
                        != s.placements else t, tree, shardings)

    def accumulator(p, s):
        """A float32 zero of p's shape, in s's placements on p's mesh."""
        if not is_dtensor(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        from torch.distributed.tensor import DTensor
        pl = p.placements if s is None else s.placements
        mesh = p.device_mesh
        shape = list(p.shape)
        for i, q in enumerate(pl):
            if q.is_shard():
                shape[q.dim] //= mesh.size(i)
        local = torch.zeros(shape, dtype=torch.float32,
                            device=p.to_local().device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=p.shape, stride=p.stride())

    def train_step(params, opt_state, batch, step):
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            per = B // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            if grad_shardings is None:
                grads = tree_map(lambda p: accumulator(p, None), params)
            else:
                grads = tree_map(accumulator, params, grad_shardings)
            for i in range(microbatches):
                mb = hold({k: _rows(v, i * per, per)
                           for k, v in batch.items()}, batch_shardings)
                mb_loss, mb_grads = compute_grads(params, mb)
                loss = loss + _plain(mb_loss)
                tree_map(lambda acc, g: acc.add_(
                    g.redistribute(acc.device_mesh, acc.placements)
                    if is_dtensor(g) else g), grads, mb_grads)
                del mb_grads
                costs.mark()        # the step-cost counter's boundary
            loss = loss / microbatches
            grads = tree_map(lambda g: g.div_(microbatches), grads)
        else:
            loss, grads = compute_grads(params, hold(batch, batch_shardings))
            loss = _plain(loss)
            grads = hold(grads, grad_shardings)
        if grad_compression == "int8":
            grads = tree_map(compress_decompress, grads)
        gnorm = global_norm(grads)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _rows(v, lo: int, n: int):
    """v[lo:lo + n] of a batch leaf.  A DTensor cut over its rows (dim 0)
    is not gathered whole: each rank puts the rows of the slice it holds
    into zeros, and the sum over the ranks (a reduce-scatter or all-reduce
    of the slice alone) places it as the batch is placed."""
    if not is_dtensor(v):
        return v[lo:lo + n]
    from torch.distributed.tensor import DTensor, Partial
    mesh, pl = v.device_mesh, tuple(v.placements)
    local = v.to_local()
    cut = [i for i, p in enumerate(pl) if p.is_shard(0)]
    shape = (n,) + tuple(v.shape[1:])
    if not cut:
        return DTensor.from_local(local[lo:lo + n], mesh, pl,
                                  run_check=False)
    from torch.distributed.tensor import Replicate
    block, dp = row_block(mesh, pl)
    n_loc = local.shape[0]
    start = block * n_loc
    a, b = max(lo, start), min(lo + n, start + n_loc)
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    if a < b:
        out[a - lo:b - lo] = local[a - start:b - start]
    partial = tuple(Partial() if i in cut else p for i, p in enumerate(pl))
    whole = torch.empty(shape, device="meta")
    got = DTensor.from_local(out, mesh, partial, run_check=False,
                             shape=whole.shape, stride=whole.stride())
    return got.redistribute(mesh, pl if n % dp == 0 else tuple(
        Replicate() if i in cut else p for i, p in enumerate(pl)))


def _plain(x):
    """A replicated 0-d DTensor as the plain tensor every rank holds."""
    return x.full_tensor() if is_dtensor(x) else x
