"""Serving: batched decode with KV caches and simple continuous batching
(slot-based request admission), and temperature / top-k sampling; port of
`repro/train/serve_step.py`."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.model import Model
from repro_torch.sharding.context import is_dtensor

_TINY = float(np.finfo(np.float32).tiny)


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, token, caches, position) -> (next_token, caches).

    Greedy decode of one token for the whole batch (argmax in float32)."""
    def serve_step(params, token, caches, position):
        logits, caches = model.decode_step(params, token, caches, position)
        last = logits[:, -1].float()
        if is_dtensor(last):    # the argmax reads the whole vocabulary
            from torch.distributed.tensor import Replicate
            last = last.redistribute(last.device_mesh,
                                     [Replicate()] * last.device_mesh.ndim)
        nxt = torch.argmax(last, dim=-1)
        return nxt[:, None].to(torch.int32), caches

    return serve_step


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature + top-k sampling in float32: one draw over the last axis
    for every leading index, with `key` ((2,), the port's threefry key).
    `jax.random.categorical` as jax 0.9 draws it: the argmax of logits plus
    Gumbel noise -log(-log(u)), u uniform in [tiny, 1) from the key over
    the logits' shape (its "low" mode).  int64 (...)."""
    lg = logits.to(torch.float32) / max(temperature, 1e-5)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e9), lg)
    u = prng.uniform(key, tuple(lg.shape), _TINY, 1.0)
    return torch.argmax(-torch.log(-torch.log(u)) + lg, dim=-1)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 32
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchServer:
    """Minimal continuous-batching server: fixed B slots, per-slot position,
    prefill via teacher-forced decode, greedy generation."""

    def __init__(self, model: Model, params, batch: int, max_seq: int):
        self.model = model
        self.params = params
        self.B = batch
        self.max_seq = max_seq
        self.caches = model.init_caches(batch, max_seq)
        self.positions = [0] * batch
        self.slots: list[Request | None] = [None] * batch
        self._step = make_serve_step(model)

    def admit(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                self.positions[i] = 0
                return True
        return False

    def _tokens_now(self) -> torch.Tensor:
        toks = []
        for i, s in enumerate(self.slots):
            if s is None:
                toks.append(0)
            elif self.positions[i] < len(s.prompt):
                toks.append(s.prompt[self.positions[i]])
            else:
                toks.append(s.generated[-1] if s.generated else s.prompt[-1])
        return torch.tensor(toks, dtype=torch.long,
                            device=self.model.device)[:, None]

    def step(self) -> torch.Tensor:
        """One lockstep decode across slots (the batch shares a position
        counter in this minimal variant: positions advance together)."""
        pos = max(self.positions)
        nxt, self.caches = self._step(self.params, self._tokens_now(),
                                      self.caches, pos)
        nxt = nxt[:, 0]
        host = nxt.tolist()                     # one device sync per step
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            self.positions[i] += 1
            if self.positions[i] >= len(s.prompt):
                s.generated.append(host[i])
                if len(s.generated) >= s.max_new:
                    s.done = True
                    self.slots[i] = None
        return nxt
