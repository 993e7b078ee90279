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
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.train.compression import compress_decompress
from repro_torch.train.optimizer import Optimizer, global_norm

CE_CHUNK = 512


def chunked_ce_loss(model: Model, params, hidden, labels,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """hidden (B, S, D); labels (B, S), -100 = ignore.  Mean CE over the
    counted tokens plus z_loss x mean lse^2 (a trailing T % chunk is
    dropped, as the reference's scan does)."""
    B, S, D = hidden.shape
    T = B * S
    chunk = min(CE_CHUNK, T)
    n_chunks = T // chunk
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
    every gradient goes through `compress_decompress`.  The sharding
    arguments belong to the multi-device slice and are taken only as None
    (ROADMAP.md queue 1 item 2).  `adamw`'s tree form updates `params` and
    `opt_state` in place (see there)."""
    if grad_shardings is not None or batch_shardings is not None:
        raise NotImplementedError(
            "make_train_step: grad_shardings / batch_shardings need the "
            "sharding slice, not ported yet (ROADMAP.md queue 1 item 2)")
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

    def train_step(params, opt_state, batch, step):
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            per = B // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                mb_loss, mb_grads = compute_grads(params, mb)
                loss = loss + mb_loss
                tree_map(lambda acc, g: acc.add_(g), grads, mb_grads)
                del mb_grads
            loss = loss / microbatches
            grads = tree_map(lambda g: g.div_(microbatches), grads)
        else:
            loss, grads = compute_grads(params, batch)
        if grad_compression == "int8":
            grads = tree_map(compress_decompress, grads)
        gnorm = global_norm(grads)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step
