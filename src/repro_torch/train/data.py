"""Deterministic synthetic LM data pipeline (port of `repro/train/data.py`).

Tokens are a stateless hash of (seed, step, position), so any host can make
exactly its shard of any step without coordination, and a run resumed at
step k sees the same global batch bit for bit.  The stream has learnable
structure (a periodic pattern 75% of the time), so a small model's loss
falls visibly.  The blocks are made with numpy, as the reference's, and
handed out as torch tensors on an explicit device, or on a mesh as
DTensors whose local shards each rank makes for itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    structure: int = 97          # period of the learnable component


def _hash(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 16)) * np.uint64(0x45d9f3b)
    x = (x ^ (x >> 16)) * np.uint64(0x45d9f3b)
    return x ^ (x >> 16)


def global_batch_np(cfg: DataConfig, step: int) -> np.ndarray:
    """The full (B, S+1) int32 token block for `step` (labels = tokens
    shifted by one)."""
    B, S = cfg.global_batch, cfg.seq + 1
    idx = np.arange(B * S, dtype=np.uint64).reshape(B, S)
    base = _hash(idx + np.uint64(step * 1_000_003 + cfg.seed * 7_777_777))
    noise = (base % np.uint64(cfg.vocab)).astype(np.int64)
    pos = np.arange(S, dtype=np.int64)[None, :] % cfg.structure
    pattern = (pos * 31 + 7) % cfg.vocab
    use_pattern = (base >> np.uint64(32)) % np.uint64(4) != 0   # 75% pattern
    return np.where(use_pattern, pattern, noise).astype(np.int32)


def host_shard(cfg: DataConfig, step: int, host_id: int, n_hosts: int
               ) -> np.ndarray:
    """This host's rows of the global batch (contiguous row sharding)."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    per = cfg.global_batch // n_hosts
    return global_batch_np(cfg, step)[host_id * per:(host_id + 1) * per]


class SyntheticDataset:
    """Iterator over {"tokens", "labels"} batches, deterministic in (seed,
    step): int64 tensors of (B / n_hosts, seq) on `device`.  On a `mesh`,
    each leaf is a DTensor of the global (B, seq) in `placements` (the
    batch's, `policies.batch_specs`), and this rank makes the rows of its
    data coordinate, `host_shard(cfg, step, index, blocks)`
    (`sharding.context.row_block`)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1,
                 device: str | torch.device = "cuda", mesh=None,
                 placements: tuple | None = None):
        self.cfg = cfg
        self.step = start_step
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        self.mesh = mesh
        self.placements = placements
        if mesh is not None:
            from repro_torch.sharding.context import row_block
            self.host_id, self.n_hosts = row_block(mesh, placements)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        block = torch.from_numpy(host_shard(self.cfg, self.step, self.host_id,
                                            self.n_hosts).astype(np.int64))
        self.step += 1
        block = block.to(self.device)
        batch = {"tokens": block[:, :-1], "labels": block[:, 1:]}
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor
        shape = (self.cfg.global_batch, self.cfg.seq)
        # contiguous: a DTensor's view rules read its global strides
        return {k: DTensor.from_local(v.contiguous(), self.mesh,
                                      self.placements,
                                      run_check=False, shape=shape,
                                      stride=(self.cfg.seq, 1))
                for k, v in batch.items()}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
