"""Fault-tolerant training loop (port of `repro/train/loop.py`).

Wraps a train step with periodic and final checkpoints
(`train.checkpoint.CheckpointManager`), restart from the last commit on a
RuntimeError (failures are injected with `elastic.SimulatedFailures`),
straggler flagging and deterministic data resume.  A step ends with a read
of its loss to the host (the reference's `jax.block_until_ready`), so its
wall time is the device's.

The checkpointed tree is the reference's `(params, opt_state)`: given the
model's config (`model_cfg`), both are written in the reference's
parameter layout (`models.convert.to_reference_layout`, super-blocks
stacked), so the reference's `CheckpointManager` restores a port
checkpoint onto its own `(params, opt_state)` and the port restores one of
the reference's.

On a mesh (DTensor state, `launch/train.py`) the ranks run the loop in
step: a checkpoint gathers each leaf whole on every rank, in one leaf
order on the main thread, and only rank 0 writes it, in the reference's
one-host format (`shard_0.npz`); before any rank reads a checkpoint, rank
0 finishes its writes and tells every rank the newest step; each rank then
reads the whole arrays and copies its own slices into its shards.  So a
checkpoint written on one mesh resumes on any other.  A failure must
strike every rank at the same step (`SimulatedFailures` does): a rank
failing alone leaves the others waiting in a collective.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.convert import (from_reference_layout,
                                        opt_state_from_reference,
                                        opt_state_to_reference,
                                        to_reference_layout)
from repro_torch.sharding.context import is_dtensor
from repro_torch.sharding.policies import local_slice
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import SimulatedFailures, StragglerWatchdog


@dataclasses.dataclass
class LoopConfig:
    """`checkpoint_every` 0: no checkpoint at all, periodic or final (a
    failure then restarts from step 0 with the state kept, as without a
    committed checkpoint)."""
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


def _to_disk(model_cfg, params, opt_state, writer: bool = True
             ) -> list | None:
    """The checkpointed tree, a copy on the host (the reference's layout
    is stacked there, not on the device).  A DTensor leaf is gathered
    whole first, which every rank of its mesh must join; only the
    `writer` keeps the tree (None elsewhere)."""
    def whole(t):
        t = t.full_tensor() if is_dtensor(t) else t
        return t.detach().to("cpu", copy=True) if writer else None

    host = tree_map(whole, [params, opt_state])
    if not writer:
        return None
    if model_cfg is None:
        return host
    return [to_reference_layout(model_cfg, host[0]),
            opt_state_to_reference(model_cfg, host[1])]


def _from_disk(model_cfg, tree: list) -> tuple:
    params, opt_state = tree
    if model_cfg is None:
        return params, opt_state
    return (from_reference_layout(model_cfg, params),
            opt_state_from_reference(model_cfg, opt_state))


def _load_into(params, opt_state, tree: list) -> None:
    """Copies a restored state (`_from_disk`'s, whole on the host) into the
    state's own tensors, leaf by leaf (a DTensor's local shard takes its
    own slice): the device never holds two copies of the state, whoever
    else keeps a reference to it (the caller's `params` and `opt_state`
    are these very tensors, since the optimizers update in place)."""
    def put(dst, src):
        if is_dtensor(dst):
            dst.to_local().copy_(local_slice(src, dst.device_mesh,
                                             dst.placements))
        else:
            dst.copy_(src)
    tree_map(put, [params, opt_state], tree)


def _ranks(params) -> tuple[int, int]:
    """(ranks, this rank) of the default group for a DTensor state, whose
    mesh spans them all (`launch/train.py`); (1, 0) for plain tensors."""
    if not any(is_dtensor(t) for t in tree_leaves(params)):
        return 1, 0
    import torch.distributed as dist
    return dist.get_world_size(), dist.get_rank()


def _agree(obj, world: int):
    """Rank 0's `obj` on every rank (`obj` itself alone)."""
    if world == 1:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def train_loop(train_step: Callable, params, opt_state,
               dataset: SyntheticDataset, cfg: LoopConfig,
               failures: SimulatedFailures | None = None,
               log: Callable = print,
               model_cfg: ModelConfig | None = None) -> dict:
    """Runs to cfg.total_steps, surviving injected failures by a restart
    from the last committed checkpoint, which is read into `params` and
    `opt_state` in place.  Returns the final params and opt_state, the
    step, the losses of every step run (a step replayed after a restart
    appears twice), restarts, stragglers and each step's wall seconds."""
    ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
    watchdog = StragglerWatchdog()
    device = dataset.device
    world, rank = _ranks(params)
    writer = rank == 0
    # the restore template: structure, shapes and dtypes only
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), [params, opt_state])
    template = (meta if model_cfg is None else
                [to_reference_layout(model_cfg, meta[0]),
                 opt_state_to_reference(model_cfg, meta[1])])
    restarts, step, losses = 0, 0, []

    def restore(params, opt_state) -> int:
        tree, extras = ckpt.restore(template, device="cpu")
        dataset.restore({"step": extras.get("data_step", extras["step"])})
        _load_into(params, opt_state, list(_from_disk(model_cfg, tree)))
        return extras["step"]

    def latest() -> int | None:
        """The newest committed step once rank 0's writes are done: no
        rank reads a checkpoint before this."""
        ckpt.wait()
        return _agree(ckpt.latest_step(), world)

    def save(step: int) -> None:
        tree = _to_disk(model_cfg, params, opt_state, writer)
        if writer:
            ckpt.save(step, tree,
                      extras={"data_step": dataset.state()["step"]})

    if latest() is not None:
        step = restore(params, opt_state)
        log(f"[loop] resumed from step {step}")

    while step < cfg.total_steps:
        try:
            batch = next(dataset)
            if failures is not None:
                failures.check(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(
                params, opt_state, batch,
                torch.tensor(step, dtype=torch.int32, device=device))
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if is_dtensor(loss)
                         else loss)         # waits for the device
            dt = time.perf_counter() - t0
            if watchdog.observe(dt):
                log(f"[loop] straggler flagged at step {step}: "
                    f"{dt:.3f}s vs median {watchdog.median:.3f}s")
            losses.append(loss)
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            step += 1
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                save(step)
            continue
        except NotImplementedError:
            raise                   # a missing port, not a node failure
        except RuntimeError as e:
            restarts += 1
            log(f"[loop] FAILURE: {e} -> restart {restarts}/{cfg.max_restarts}")
            if restarts > cfg.max_restarts:
                raise
        # restart outside the handler, so that the failed step's frames
        # (and their tensors) are gone before the state is read back
        batch = None
        if latest() is not None:
            step = restore(params, opt_state)
        else:       # as the reference: the data from 0, the state kept
            step = 0
            dataset.restore({"step": 0})

    if cfg.checkpoint_every and latest() != step:
        # the final commit; the reference writes it again even when the
        # last periodic save was this very step, which would only rewrite
        # the same state
        save(step)
        ckpt.wait()
    return {"params": params, "opt_state": opt_state, "step": step,
            "losses": losses, "restarts": restarts,
            "stragglers": watchdog.flagged, "step_times": watchdog.times}
