"""Holding one run of a model against another: the MoE route replay and the
model zoo's bf16 bar, shared by `chip_smoke.py` and the tests.  Nothing on
the model path imports this module.

Routes are a discontinuity.  Two runs round bf16 at other places (card
against CPU, the port against the reference), so a token whose top-k
router scores nearly tie in some MoE layer can pick another expert in one
of them, and its hidden state then differs by a whole expert's output.  So
a whole model is held to the bar on one run's routes: `RouteReplay`
records the expert choices of one run (or takes them from elsewhere,
`push`) and makes the next run take them in the same order, while it
counts how many routed tokens that run's own top-k would have sent to the
same experts anyway.  `check` holds that share to MIN_ROUTE_AGREEMENT.
A remat'd block routes again in the backward's re-forward, on the same
logits: there both modes run the forward's ops and return the choice the
forward made for those logits (bit for bit), and nothing is queued or
taken.
"""
from __future__ import annotations

import contextlib
import hashlib

import torch

from repro_torch.models import moe

# The share of routed tokens whose own top-k expert set must equal the
# replayed one: near-ties flip a few tokens, a fault in the router flips
# most of them.
MIN_ROUTE_AGREEMENT = 0.95
# The zoo's bf16 bar: rtol, and atol as this times max |reference|.
BF16_RTOL = 2e-2


class RouteReplay:
    """The MoE routers' expert choices of one run, replayed in the next."""

    def __init__(self):
        self.queue: list[torch.Tensor] = []
        self.same = self.seen = 0
        self.chosen: dict[str, torch.Tensor] = {}

    def _again(self, logits):
        """The forward's choice for these logits when called in the
        backward (a remat re-forward), else None."""
        if torch._C._current_graph_task_id() == -1:
            return None
        key = self._key(logits)
        if key not in self.chosen:
            raise AssertionError("re-forward of an MoE layer on logits the "
                                 "forward did not route")
        return self.chosen[key].to(logits.device)

    def _remember(self, logits, idx) -> None:
        self.chosen[self._key(logits)] = idx.detach().cpu()

    @staticmethod
    def _key(logits) -> str:
        t = logits.detach().float().cpu().contiguous()
        return hashlib.sha1(t.numpy().tobytes()).hexdigest()

    def push(self, expert_idx) -> None:
        """Queue one router call's (T, top_k) expert indices."""
        self.queue.append(torch.as_tensor(expert_idx).long().cpu())

    @contextlib.contextmanager
    def record(self):
        """Route as usual, queueing each call's choice."""
        select = moe.select_experts

        def recording(logits, cfg):
            gates, idx = select(logits, cfg)
            if self._again(logits) is None:
                self.push(idx)
                self._remember(logits, idx)
            return gates, idx
        with _patched(recording):
            yield self

    @contextlib.contextmanager
    def replay(self):
        """Take the queued choices in order, the gates from this run's own
        logits, and count the tokens this run would have routed alike."""
        select = moe.select_experts

        def replaying(logits, cfg):
            own = select(logits, cfg)[1]
            again = self._again(logits)
            if again is not None:       # the same ops as the forward's
                return moe.gates_for(logits, again, cfg), again
            idx = self.queue.pop(0).to(logits.device)
            self._remember(logits, idx)
            if idx.shape != own.shape:
                raise AssertionError(f"replayed routes {tuple(idx.shape)} "
                                     f"against {tuple(own.shape)}")
            self.same += int((own.sort(-1).values == idx.sort(-1).values
                              ).all(-1).sum())
            self.seen += own.shape[0]
            return moe.gates_for(logits, idx, cfg), idx
        with _patched(replaying):
            yield self

    def agreement(self) -> float:
        return self.same / max(self.seen, 1)

    def check(self, what: str) -> str:
        """Raise unless every queued choice was replayed and the share of
        tokens routed alike is at least MIN_ROUTE_AGREEMENT."""
        if self.queue:
            raise AssertionError(f"{what}: {len(self.queue)} recorded MoE "
                                 f"calls were not replayed")
        if self.same < MIN_ROUTE_AGREEMENT * self.seen:
            raise AssertionError(f"{what}: own routes agree on {self.same}/"
                                 f"{self.seen} tokens, below "
                                 f"{MIN_ROUTE_AGREEMENT}")
        return (f"routes {self.same}/{self.seen} the same on both"
                if self.seen else "no MoE layer")


@contextlib.contextmanager
def _patched(fn):
    select = moe.select_experts
    moe.select_experts = fn
    try:
        yield
    finally:
        moe.select_experts = select


def hold_bf16(got, want, what: str) -> str:
    """The zoo's bf16 bar: rtol BF16_RTOL, atol BF16_RTOL x max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    atol = BF16_RTOL * float(want.abs().max())
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=BF16_RTOL, atol=atol):
        raise AssertionError(f"{what}: differs beyond rtol {BF16_RTOL}, "
                             f"atol {atol:.3g}: max abs {err:.3g}")
    rel = float((got - want).norm() / want.norm())
    return f"max abs err {err:.4g} (atol {atol:.3g}), relative L2 {rel:.3g}"


def tree_to(tree, device):
    """A params tree of dicts and lists, its tensors moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
