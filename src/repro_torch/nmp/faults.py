"""Deterministic fault-injection harness for the serving and continual stack
(port of `repro.nmp.faults`).

A seeded `FaultPlan` injects the fault classes the serving layer must
survive, at explicit hook points in `serving.MappingServer` and
`continual.run_stream`; with no plan armed every hook site is a plain
`is not None` check.

Fault classes (`FaultEvent.kind`):

  poison_agent       NaN-fill the float param leaves of a lineage's warm
                     agent (serving: the warm batch cell at dispatch;
                     run_stream: the stored PolicyStore snapshot): the input
                     the per-tick divergence guard must catch.
  poison_trace       corrupt a tenant trace (NaN/Inf for float arrays,
                     negative page ids otherwise): the input the `submit()`
                     boundary validation must reject.
  fail_tick          raise `InjectedFault` at dispatch (a crashed service
                     tick), optionally attributed to one tenant.
  stall_tick         sleep `stall_s` on the host at dispatch: exceeds the
                     server's per-phase deadline and is attributed to the
                     stalling tenant.
  corrupt_checkpoint flip bytes of the newest on-disk checkpoint step (meta
                     or shard file): what the crash-safe
                     `CheckpointManager.restore` must detect and fall back
                     from.
  shrink_devices     shrink the server's mesh to its first `keep_devices`
                     ranks (`nmp.partition`); the ranks it drops hold no
                     slots but keep joining the gathers.  A lone process
                     runs the degenerate 1 -> 1 case.

Events are one-shot and fire deterministically: serving events at
dispatch-attempt ordinal `at` (retries advance the ordinal), stream events
at phase ordinal `at`, checkpoint events at save ordinal `at`.  In a
process group every rank holds the same plan, and since every event is
keyed on ordinals it fires on every rank alike (a checkpoint is corrupted
by the rank that wrote it).  Byte
positions for disk corruption come from the plan's seeded generator, so a
corruption run is reproducible from `(seed, events)` alone.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

KINDS = ("poison_agent", "poison_trace", "fail_tick", "stall_tick",
         "corrupt_checkpoint", "shrink_devices")


class InjectedFault(RuntimeError):
    """An injected tick/phase failure.  `tenant` attributes the fault to one
    tenant/lineage (None = whole-tick fault); the serving layer uses it to
    degrade only the affected tenant."""

    def __init__(self, msg: str, tenant: str | None = None,
                 kind: str = "fail_tick"):
        super().__init__(msg)
        self.tenant = tenant
        self.kind = kind


@dataclasses.dataclass
class FaultEvent:
    """One armed fault (see module docstring for the `kind` taxonomy)."""
    kind: str
    at: int = 0                      # dispatch-attempt / phase / save ordinal
    tenant: str | None = None        # target tenant or lineage tag
    stall_s: float = 0.2             # stall_tick host sleep
    n_bytes: int = 16                # corrupt_checkpoint bytes to flip
    target: str = "shard"            # corrupt_checkpoint: "shard" | "meta"
    step: int | None = None          # corrupt_checkpoint step (None = newest)
    keep_devices: int = 1            # shrink_devices survivor count
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


class FaultPlan:
    """A seeded, deterministic schedule of `FaultEvent`s.

    Pass one to `MappingServer(faults=...)` or `run_stream(faults=...)`; the
    hook methods below are called from the explicit injection points and do
    nothing when no unfired event matches.  `injected` logs every fired
    event as `(kind, at, tenant)`."""

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events = list(events)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.injected: list[tuple[str, int, str | None]] = []
        self._saves = 0                  # checkpoint-save ordinal counter

    def arm(self, event: FaultEvent) -> "FaultPlan":
        self.events.append(event)
        return self

    def _take(self, kind: str, at: int,
              tenants: Sequence[str] | None = None) -> list[FaultEvent]:
        """Fire (and mark) every unfired `kind` event scheduled at `at` whose
        target tenant is unrestricted or present in `tenants`."""
        out = []
        for ev in self.events:
            if ev.fired or ev.kind != kind or ev.at != at:
                continue
            if (tenants is not None and ev.tenant is not None
                    and ev.tenant not in tenants):
                continue
            ev.fired = True
            self.injected.append((ev.kind, at, ev.tenant))
            out.append(ev)
        return out

    # -- serving hooks --------------------------------------------------

    def on_dispatch(self, attempt: int,
                    tenants: Sequence[str]) -> tuple[str, ...]:
        """Called by `MappingServer` once per dispatch attempt.  Sleeps for
        stall events, raises `InjectedFault` for fail events, and returns the
        ids of tenants whose lane was stalled (deadline attribution)."""
        stalled = []
        for ev in self._take("stall_tick", attempt, tenants):
            time.sleep(ev.stall_s)
            stalled.append(ev.tenant)
        for ev in self._take("fail_tick", attempt, tenants):
            raise InjectedFault(
                f"injected tick failure at dispatch attempt {attempt}"
                + (f" (tenant {ev.tenant!r})" if ev.tenant else ""),
                tenant=ev.tenant)
        return tuple(t for t in stalled if t is not None)

    def poison_warm_agents(self, attempt: int, tenants: Sequence[str],
                           warm, n_seeds: int = 1,
                           held: Sequence[int] | None = None):
        """NaN-fill the float param leaves of matching tenants' cells of the
        warm agent batch (flat (L*S, ...) AgentState) at dispatch, on the
        batch's device.  `held` lists the flat cells of the whole batch
        that `warm` holds, in order (a rank's block on a mesh; all of them
        by default).  Out of place: the batch's tensors may share memory
        with reused host buffers."""
        lanes = [li for ev in self._take("poison_agent", attempt, tenants)
                 for li, t in enumerate(tenants) if t == ev.tenant
                 or ev.tenant is None]
        if not lanes or warm is None:
            return warm
        cells = [li * n_seeds + s for li in sorted(set(lanes))
                 for s in range(n_seeds)]
        if held is not None:
            pos = {c: i for i, c in enumerate(held)}
            cells = [pos[c] for c in cells if c in pos]
            if not cells:
                return warm
        idx = torch.as_tensor(cells, dtype=torch.int64,
                              device=next(iter(warm.params.values())).device)
        fill = lambda t: (t.index_fill(0, idx, float("nan"))
                          if t.is_floating_point() else t)
        return warm.replace(params={k: fill(v)
                                    for k, v in warm.params.items()})

    def shrink_devices_now(self, attempt: int) -> int | None:
        """Device count the server must shrink to at this attempt (None =
        no shrink armed)."""
        evs = self._take("shrink_devices", attempt)
        return evs[-1].keep_devices if evs else None

    # -- stream hooks ---------------------------------------------------

    def on_phase(self, phase: int, store) -> None:
        """Called by `run_stream` before each phase: poison stored lineage
        snapshots, stall, or fail the phase."""
        for ev in self._take("poison_agent", phase,
                             tenants=tuple(store.tags)):
            tags = [ev.tenant] if ev.tenant is not None else store.tags
            for tag in tags:
                if tag in store:
                    poison_store_agent(store, tag)
        for ev in self._take("stall_tick", phase):
            time.sleep(ev.stall_s)
        for ev in self._take("fail_tick", phase):
            raise InjectedFault(
                f"injected stream failure at phase {phase}"
                + (f" (lineage {ev.tenant!r})" if ev.tenant else ""),
                tenant=ev.tenant)

    def on_checkpoint(self, directory: str, writer: bool = True) -> None:
        """Called after each checkpoint save; corrupt events armed at this
        save ordinal flip bytes of the just-written (or `step`-named) step.
        Only the `writer` (the rank that wrote the step) flips them; the
        other ranks mark the events fired."""
        save = self._saves
        self._saves += 1
        for ev in self._take("corrupt_checkpoint", save):
            if writer:
                self.corrupt_checkpoint(directory, step=ev.step,
                                        target=ev.target,
                                        n_bytes=ev.n_bytes)

    # -- disk corruption utilities --------------------------------------

    def corrupt_checkpoint(self, directory: str, step: int | None = None,
                           target: str = "shard", n_bytes: int = 16,
                           host_id: int = 0) -> str:
        """Flip `n_bytes` seeded byte positions of one file of a committed
        checkpoint step (the newest when `step` is None).  Returns the path
        corrupted.  Deterministic given the plan's seed."""
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp")
                       and d.split("_")[1].isdigit())
        if not steps:
            raise FileNotFoundError(f"no committed steps in {directory}")
        step = steps[-1] if step is None else step
        name = "meta.json" if target == "meta" else f"shard_{host_id}.npz"
        path = os.path.join(directory, f"step_{step:09d}", name)
        corrupt_bytes(path, self.rng, n_bytes=n_bytes)
        self.injected.append(("corrupt_checkpoint", step, name))
        return path


def corrupt_bytes(path: str, rng: np.random.Generator,
                  n_bytes: int = 16) -> None:
    """XOR-flip `n_bytes` positions of `path` in place (positions/masks from
    `rng`, so a seeded generator makes the corruption reproducible)."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    pos = rng.integers(0, size, size=min(n_bytes, size))
    masks = rng.integers(1, 256, size=pos.size)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        for p, m in zip(pos, masks):
            data[int(p)] ^= int(m)
        f.seek(0)
        f.write(bytes(data))
        f.flush()
        os.fsync(f.fileno())


def tamper_leaf(directory: str, step: int, key: str, host_id: int = 0) -> None:
    """Silently corrupt ONE leaf of a committed checkpoint: rewrite the shard
    npz with that leaf's bytes bit-flipped, keeping the zip container valid.
    The file parses fine; only the per-leaf checksum recorded in the
    checkpoint meta can catch it."""
    path = os.path.join(directory, f"step_{step:09d}", f"shard_{host_id}.npz")
    with np.load(path) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    if key not in arrays:
        raise KeyError(f"{key!r} not in {sorted(arrays)}")
    a = arrays[key]
    raw = bytearray(a.tobytes())
    raw[0] ^= 0xFF
    arrays[key] = np.frombuffer(bytes(raw), a.dtype).reshape(a.shape)
    np.savez(path, **arrays)


def poison_store_agent(store, tag: str) -> None:
    """NaN-fill the float param leaves of a PolicyStore lineage's stored
    snapshot in place (bypassing `put`, so the store's version bookkeeping
    does not advance: silent corruption, not a bad put)."""
    snap = store.get(tag)
    poisoned = snap.replace(params={
        k: (np.full_like(a, np.nan) if np.issubdtype(a.dtype, np.floating)
            else a) for k, a in snap["params"].items()})
    store._agents[tag] = poisoned


def poison_trace(trace, mode: str = "negative"):
    """A corrupted copy of a Trace: `negative` writes invalid negative page
    ids into `dest`; `nan` converts `dest` to float and NaN-poisons it.  Both
    must be rejected at the `MappingServer.submit()` boundary."""
    if mode == "negative":
        dest = np.array(trace.dest, np.int32)
        dest[:: max(len(dest) // 7, 1)] = -3
    elif mode == "nan":
        dest = np.array(trace.dest, np.float64)
        dest[:: max(len(dest) // 7, 1)] = np.nan
    else:
        raise ValueError(f"unknown poison mode {mode!r}")
    return dataclasses.replace(trace, dest=dest)


def params_finite(snapshot) -> bool:
    """Host-side check that every float param leaf of an agent snapshot is
    finite (the serving layer's stored-snapshot triage before rollback)."""
    params = (snapshot["params"] if isinstance(snapshot, dict)
              else snapshot.params)
    return all(np.isfinite(leaf).all() for leaf in params.values()
               if np.issubdtype(np.asarray(leaf).dtype, np.floating))
