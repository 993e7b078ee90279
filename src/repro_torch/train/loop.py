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
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models.convert import (from_reference_layout,
                                        opt_state_from_reference,
                                        opt_state_to_reference,
                                        to_reference_layout)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.elastic import SimulatedFailures, StragglerWatchdog


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


def _to_disk(model_cfg, params, opt_state) -> list:
    """The checkpointed tree, on the host (the reference's layout is
    stacked there, not on the device)."""
    host = tree_map(lambda t: t.detach().cpu(), [params, opt_state])
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
    """Copies a restored state (`_from_disk`'s, on the host) into the
    state's own tensors, leaf by leaf: the device never holds two copies
    of the state, whoever else keeps a reference to it (the caller's
    `params` and `opt_state` are these very tensors, since the optimizers
    update in place)."""
    tree_map(lambda dst, src: dst.copy_(src), [params, opt_state], tree)


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

    if ckpt.latest_step() is not None:
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
            loss = float(metrics["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            if watchdog.observe(dt):
                log(f"[loop] straggler flagged at step {step}: "
                    f"{dt:.3f}s vs median {watchdog.median:.3f}s")
            losses.append(loss)
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            step += 1
            if step % cfg.checkpoint_every == 0:
                ckpt.save(step, _to_disk(model_cfg, params, opt_state),
                          extras={"data_step": dataset.state()["step"]})
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
        ckpt.wait()
        if ckpt.latest_step() is not None:
            step = restore(params, opt_state)
        else:       # as the reference: the data from 0, the state kept
            step = 0
            dataset.restore({"step": 0})

    ckpt.wait()
    if ckpt.latest_step() != step:
        # the final commit; the reference writes it again even when the
        # last periodic save was this very step, which would only rewrite
        # the same state
        ckpt.save(step, _to_disk(model_cfg, params, opt_state),
                  extras={"data_step": dataset.state()["step"]})
        ckpt.wait()
    return {"params": params, "opt_state": opt_state, "step": step,
            "losses": losses, "restarts": restarts,
            "stragglers": watchdog.flagged, "step_times": watchdog.times}
