"""Serving: batched decode with KV caches and simple continuous batching
(slot-based request admission); port of `repro/train/serve_step.py`."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.model import Model


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, token, caches, position) -> (next_token, caches).

    Greedy decode of one token for the whole batch (argmax in float32)."""
    def serve_step(params, token, caches, position):
        logits, caches = model.decode_step(params, token, caches, position)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1)
        return nxt[:, None].to(torch.int32), caches

    return serve_step


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
