"""Continual-learning agent lifecycle layer (port of `repro.nmp.continual`):
persistent policies across scenarios, program switches and processes.

  PolicyStore   : a tag -> agent registry of lineages.  Lanes declare a
                  lineage with `Scenario.lineage`; `sweep.run_grid`
                  warm-starts declared lanes from the store (cold-starts a
                  fresh tag) and writes every tag's final agent back.  Agents
                  are held as host numpy snapshots (`agent.export_agent`, the
                  reference's layout), so a store is independent of devices.
  checkpointing : `PolicyStore.save` / `PolicyStore.restore` round-trip the
                  whole store through `train.checkpoint.CheckpointManager`
                  bit-exactly, in the reference's on-disk format: either
                  package restores a store the other saved.
  run_stream    : an ordered program-phase stream (`scenarios.
                  continual_stream`) as chained `run_grid` calls threading
                  one PolicyStore, i.e. one DQN living through app switches
                  and co-runner arrival and departure.

Scenario-boundary semantics (`PolicyStore.checkout`): the DNN weights,
target network, Adam moments, replay, key and `global_step` carry across
the boundary; only the per-scenario interaction counter resets
(`agent.hand_off`).  Epsilon keys on `global_step`, so exploration keeps
decaying over the agent's lifetime.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import agent as agent_mod
from repro_torch.core.agent import AgentConfig, AgentState
from repro_torch.core.tree import Fields, leaf_paths, unflatten
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.scenarios import Scenario
from repro_torch.train.checkpoint import (CheckpointCorruptError,
                                          CheckpointManager, decode_leaf)


def check_tag(tag: str) -> str:
    """Validate a lineage tag (also called by `plan_grid`, so a bad tag fails
    at plan time instead of after the whole grid has simulated)."""
    if not isinstance(tag, str) or not tag or "/" in tag:
        raise ValueError(
            f"lineage tag {tag!r}: expected a non-empty string without '/' "
            "(tags become checkpoint leaf-path components)")
    return tag


def _snapshot(agent: AgentState | Any) -> Fields:
    """A one-agent host snapshot of `agent`: an AgentState of one agent is
    exported; a snapshot (the port's or the reference's) is taken as it is,
    in the reference layout."""
    if isinstance(agent, AgentState):
        return agent_mod.export_agent(agent)
    return agent_mod.map_snapshot(np.asarray, agent)


class PolicyStore:
    """Registry of persistent agent lineages, keyed by tag.

    Agents enter via `put` (stored as host numpy snapshots) and leave via
    `checkout` (a one-agent state on a device, scenario-boundary handoff
    applied) or `checkout_host`.  The store never trains: `sweep.run_grid`
    and `run_stream` thread it through their runs.  Per-tag `meta` records
    lineage provenance (last scenario, lifetime counters, phases served, a
    `version` bumped on every `put`).

    `capacity` bounds the number of resident lineages: `put` and `checkout`
    refresh a tag's recency, and a `put` that overflows the bound evicts the
    least-recently-used *other* tags (counted in `evictions`; per-tag
    eviction counts live on in `meta`, so a returning tag's `version`
    continues across evictions).  An evicted lineage cold-restarts on its
    next warm-start lookup; the serving layer (nmp.serving) serves an
    unbounded tenant population from a finite store that way.  The default
    (`capacity=None`) is unbounded."""

    def __init__(self, agents: dict[str, Any] | None = None,
                 meta: dict[str, dict] | None = None,
                 capacity: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"PolicyStore capacity must be >= 1 or None "
                             f"(got {capacity})")
        self.capacity = capacity
        self.evictions = 0               # lifetime eviction count
        self.rollbacks = 0               # lifetime rollback count
        self.restored_step = None        # checkpoint step this store came
                                         # from (set by `restore`): run_stream
                                         # realigns resumed histories with it
        self.restore_fallbacks = 0       # corrupt steps skipped by `restore`
        self.corrupt_tags: list[str] = []  # lineages dropped (cold-start) by
                                           # `restore` on per-tag corruption
        self._agents: dict[str, Fields] = {
            t: _snapshot(a) for t, a in (agents or {}).items()}
        self._prev: dict[str, Fields] = {}   # last-good snapshots
                                             # (rollback depth 1)
        self.meta: dict[str, dict] = {t: dict(m)
                                      for t, m in (meta or {}).items()}
        self._evict_to_capacity()

    # -- registry -------------------------------------------------------
    @property
    def tags(self) -> list[str]:
        return sorted(self._agents)

    def __contains__(self, tag: str) -> bool:
        return tag in self._agents

    def __len__(self) -> int:
        return len(self._agents)

    def get(self, tag: str) -> Fields:
        """The stored host snapshot (no handoff applied)."""
        return self._agents[tag]

    def put(self, tag: str, agent: AgentState | Any, **meta: Any) -> None:
        """Store `agent` (a one-agent state, or a host snapshot) as the
        lineage's current state, bump its `version` and update its
        provenance record.  With a bounded store this may evict
        least-recently-used other tags."""
        check_tag(tag)
        snap = _snapshot(agent)
        prev = self._agents.pop(tag, None)   # re-insert = most recent
        if prev is not None:
            self._prev[tag] = prev           # last-good rollback snapshot
        self._agents[tag] = snap
        rec = self.meta.setdefault(tag, {"phases": 0})
        rec["phases"] = rec.get("phases", 0) + 1
        rec["version"] = rec.get("version", 0) + 1
        rec["global_step"] = int(snap["global_step"])
        rec["train_steps"] = int(snap["train_steps"])
        rec.update(meta)
        self._evict_to_capacity()

    def checkout(self, tag: str,
                 device: str | torch.device = "cuda") -> AgentState:
        """Warm start for a new scenario: the stored lineage as a one-agent
        state on `device`, with the scenario-boundary handoff applied
        (per-scenario counter reset; weights, replay, key and global_step
        carried).  Refreshes the tag's LRU recency."""
        self._agents[tag] = self._agents.pop(tag)
        return agent_mod.hand_off(agent_mod.import_agent(self._agents[tag],
                                                         device))

    def checkout_host(self, tag: str) -> Fields:
        """`checkout` without the device import: the stored snapshot with
        the handoff applied host-side (LRU recency refreshed the same way).
        The staging path of the warm batch (`sweep.AgentStaging`) fills its
        host buffers from these and pays one host->device copy per leaf
        instead of one per cell; the values are `checkout`'s."""
        self._agents[tag] = self._agents.pop(tag)
        return self._agents[tag].replace(step=np.zeros((), np.int32))

    def version(self, tag: str) -> int:
        """Lifetime `put` count of a lineage (survives eviction)."""
        return int(self.meta[tag].get("version", 0))

    def rollback(self, tag: str) -> bool:
        """Revert a lineage to its last-good version (the snapshot the most
        recent `put` replaced): the divergence-recovery path.  With no prior
        version the current snapshot is dropped, so the lineage cold-
        restarts on its next lookup.  True when a prior snapshot was
        restored."""
        self.rollbacks += 1
        rec = self.meta.setdefault(tag, {})
        rec["rollbacks"] = rec.get("rollbacks", 0) + 1
        self._agents.pop(tag, None)          # discard the bad current
        prev = self._prev.pop(tag, None)
        if prev is None:
            return False
        self._agents[tag] = prev             # restored = most recent
        return True

    # -- bounded capacity ----------------------------------------------
    def evict(self, tag: str) -> None:
        """Drop a lineage's resident agent.  Its `meta` record stays (with
        an `evicted` count), so versioning continues if the tag returns; a
        later warm-start lookup misses and cold-restarts."""
        del self._agents[tag]
        self._prev.pop(tag, None)
        self.evictions += 1
        rec = self.meta.setdefault(tag, {})
        rec["evicted"] = rec.get("evicted", 0) + 1

    def _evict_to_capacity(self) -> None:
        if self.capacity is None:
            return
        while len(self._agents) > self.capacity:
            self.evict(next(iter(self._agents)))     # insertion order = LRU

    def global_step(self, tag: str) -> int:
        """Lifetime env interactions of a lineage."""
        return int(self._agents[tag]["global_step"])

    # -- persistence ----------------------------------------------------
    def save(self, directory: str, step: int | None = None,
             keep: int = 0) -> int:
        """Checkpoint every lineage (synchronously) via CheckpointManager.

        `step` defaults to latest+1 so repeated saves of a long-running
        stream form a history.  Every step is kept by default (`keep=0`): a
        stream checkpoints once per phase and any phase must stay a valid
        resume point; pass `keep > 0` to bound the history instead."""
        mgr = CheckpointManager(directory, keep=keep, async_write=False)
        if step is None:
            latest = mgr.latest_step()
            step = 0 if latest is None else latest + 1
        mgr.save(step, dict(self._agents),
                 extras={"tags": self.tags, "meta": self.meta,
                         "capacity": self.capacity,
                         "evictions": self.evictions,
                         "rollbacks": self.rollbacks})
        return step

    @classmethod
    def restore(cls, directory: str, agent_cfg: AgentConfig,
                step: int | None = None) -> "PolicyStore":
        """Rebuild a store in a fresh process: read the checkpoint's tag list
        from its metadata, build key-free `agent_template` skeletons, and map
        the saved leaves back on bit-exactly.  `agent_cfg` must describe the
        agent architecture the store was saved with.

        With `step=None`, unreadable steps (torn commit, garbage meta,
        unopenable shard) are skipped newest-first, counted in
        `restore_fallbacks`, until an intact one restores.  Within a
        readable step, a lineage whose own leaves fail their checksums is
        dropped (listed in `corrupt_tags`; its `meta` record survives with a
        `corrupt_restore` mark) while every other lineage restores
        bit-exactly.  An explicitly requested bad `step` raises
        `CheckpointCorruptError`.  The restored store remembers its step
        (`restored_step`) for `run_stream`'s step <-> phase alignment."""
        mgr = CheckpointManager(directory)
        explicit = step is not None
        steps = [step] if explicit else list(reversed(mgr.all_steps()))
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints in {directory!r}: the directory holds no "
                "committed step_<k> entries")
        skipped = 0
        last_err: Exception | None = None
        for s in steps:
            try:
                store = cls._restore_step(mgr, s, agent_cfg)
                store.restore_fallbacks = skipped
                return store
            except CheckpointCorruptError as e:
                if explicit:
                    raise
                skipped += 1
                last_err = e
        raise CheckpointCorruptError(
            f"no intact checkpoint step in {directory!r} "
            f"({skipped} corrupt step(s) skipped): {last_err}")

    @classmethod
    def _restore_step(cls, mgr: CheckpointManager, step: int,
                      agent_cfg: AgentConfig) -> "PolicyStore":
        arrays, meta, bad = mgr.load_arrays(step)
        extras = meta["extras"]
        agents: dict[str, Fields] = {}
        corrupt: list[str] = []
        for tag in extras["tags"]:
            tmpl = {tag: agent_mod.agent_template(agent_cfg)}
            keys = [k for k, _ in leaf_paths(tmpl)]
            if any(k in bad or k not in arrays for k in keys):
                corrupt.append(tag)
                continue
            leaves = {k: np.asarray(decode_leaf(
                arrays[k], meta["leaves"][k]["dtype"])) for k in keys}
            agents[tag] = unflatten(tmpl, leaves)[tag]
        if not agents and extras["tags"]:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: every lineage failed verification")
        store = cls(agents=agents, meta=extras.get("meta", {}),
                    capacity=extras.get("capacity"))
        for tag in corrupt:
            rec = store.meta.setdefault(tag, {})
            rec["corrupt_restore"] = rec.get("corrupt_restore", 0) + 1
        store.corrupt_tags = corrupt
        store.evictions = int(extras.get("evictions", 0))
        store.rollbacks = int(extras.get("rollbacks", 0))
        store.restored_step = int(meta["step"])
        return store


@dataclasses.dataclass
class StreamResult:
    """One executed program-phase stream: per-phase SweepResults plus the
    PolicyStore holding every lineage's final agent."""
    phases: list[Any]                # list[sweep.SweepResult], in phase order
    store: PolicyStore

    def phase_summary(self, phase: int, lane: int,
                      episode: int | None = None) -> dict:
        return self.phases[phase].episode_summary(lane, episode)


def run_stream(stream: Sequence[Sequence[Scenario]],
               cfg: NMPConfig = NMPConfig(),
               agent_cfg: AgentConfig | None = None,
               store: PolicyStore | None = None,
               checkpoint_dir: str | None = None,
               checkpoint_base_step: int | None = None,
               faults=None,
               device: str | torch.device = "cuda") -> StreamResult:
    """Execute an ordered program-phase stream as chained `run_grid` calls
    on `device`, threading one store: lanes sharing a lineage tag across
    phases are one DQN living through every app switch.

    With `checkpoint_dir` the store is checkpointed after every phase at
    step `base + phase_index`, where the base is (first match wins):
    `checkpoint_base_step`; `store.restored_step + 1` when the store came
    from `PolicyStore.restore` (a stream resumed from step k writes its
    phases at k+1, k+2, ..., overwriting stale later steps instead of
    appending misaligned ones); else the directory's latest+1.  So
    `PolicyStore.restore(dir, agent_cfg, step=k)` + `run_stream(stream[k+1:],
    store=..., checkpoint_dir=dir)` reproduces the remaining phases
    bit-exactly.

    `faults` is an optional `nmp.faults.FaultPlan`: its `on_phase` hook
    fires before each phase and its `on_checkpoint` hook after each save."""
    from repro_torch.nmp.sweep import run_grid
    store = store if store is not None else PolicyStore()
    base = checkpoint_base_step
    if base is None and store.restored_step is not None:
        base = store.restored_step + 1
    results = []
    for pi, phase in enumerate(stream):
        if faults is not None:
            faults.on_phase(pi, store)
        results.append(run_grid(phase, cfg, agent_cfg, store=store,
                                device=device))
        if checkpoint_dir is not None:
            store.save(checkpoint_dir,
                       step=None if base is None else base + pi)
            if faults is not None:
                faults.on_checkpoint(checkpoint_dir)
    return StreamResult(phases=results, store=store)
