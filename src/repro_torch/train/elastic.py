"""Elastic mesh arithmetic and straggler mitigation (port of
`repro/train/elastic.py`).

`factor_mesh` / `largest_viable_mesh` are the control plane's pure logic:
pick a (pod, data, model) mesh from the devices that remain, the model
(tensor-parallel) degree fixed so parameter shardings survive a resize.
`StragglerWatchdog` flags slow steps, `SimulatedFailures` injects node
losses for tests and examples.  Plain Python: nothing here touches a
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def factor_mesh(n_devices: int, model_parallel: int,
                prefer_pods: int = 1) -> tuple[int, ...] | None:
    """(pod, data, model) for a device count and a fixed TP degree; None if
    n_devices does not take the TP degree."""
    if n_devices % model_parallel:
        return None
    rest = n_devices // model_parallel
    pods = prefer_pods
    while pods > 1 and rest % pods:
        pods -= 1
    return (pods, rest // pods, model_parallel)


def largest_viable_mesh(n_devices: int, model_parallel: int,
                        batch_divisor: int) -> tuple[int, ...] | None:
    """The largest mesh (<= n_devices) whose data axis divides the global
    batch."""
    for n in range(n_devices, model_parallel - 1, -1):
        shape = factor_mesh(n, model_parallel)
        if shape is None:
            continue
        _, data, _ = shape
        if batch_divisor % data == 0:
            return shape
    return None


@dataclasses.dataclass
class StragglerWatchdog:
    """Per-step wall times; flags a step slower than `factor` x the rolling
    median of the last `window`."""
    factor: float = 2.0
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def observe(self, step_time: float) -> bool:
        med = float(np.median(self.times[-self.window:])) if self.times else None
        self.times.append(step_time)
        if med is not None and step_time > self.factor * med:
            self.flagged += 1
            return True
        return False

    @property
    def median(self) -> float:
        return float(np.median(self.times[-self.window:])) if self.times else 0.0


class SimulatedFailures:
    """Deterministic failure injector: raises RuntimeError at each of the
    given steps, once (a node loss the loop must survive)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")
