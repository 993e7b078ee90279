"""Streaming multi-tenant mapping service (port of `repro.nmp.serving`):
many concurrent tenant streams through a small set of resident lane slots.

The paper's mapper is *continual* — it keeps learning "for any application"
— but `continual.run_stream` is an offline, one-stream batch loop.  This
module is the long-lived serving layer the north star asks for:

  MappingServer : holds `n_slots` lane slots and one bounded `PolicyStore`.
                  Tenants (`submit(tenant_id, stream)`) queue for a slot;
                  a slot executes one phase of its tenant's stream per
                  service tick and is recycled when the tenant's stream is
                  drained (or the tenant is `remove`d mid-stream).  Each
                  tick batches the current phase of every active tenant
                  into ONE `run_grid`-shaped batched run, reusing the
                  plan / partition / sweep pipeline with a *forced*
                  `plan.Envelope` and a *fixed* padded lane count, so the
                  resident shapes never change as tenants arrive and
                  depart.  Where the reference counts compiled programs,
                  the eager port counts distinct dispatch signatures
                  (`sweep.compiled_sweep_programs`): none is added at
                  steady state.

Scheduling and exactness: every slot is an independent lane of the sweep,
and per-lane results are bit-identical to serial runs regardless of padding
envelope or co-lanes (the pipeline's standing invariant), so a tenant's
per-phase metrics are bit-identical to running its stream alone via
`continual.run_stream` with the same lineage tag (tests/test_serving.py).
Agent continuity goes through the shared `PolicyStore` exactly as in
`run_grid` — the tenant id is the lineage tag — so a bounded store with LRU
eviction serves an unbounded tenant population: an evicted tenant's next
phase transparently cold-restarts its lineage.

Double buffering: on the card the tick's kernels are queued
asynchronously and the *next* tick's host batch is built and copied
(`sweep.prepare_group_batch`) while the card executes the current one; the
server synchronizes its device only after that.  The schedule of tick t+1
is a pure function of the queue/slot bookkeeping; only the warm agent batch
waits on tick t's results.

Fault tolerance — the tenant health state machine:

  healthy ──failure──> degraded ──(> max_phase_retries failures)──> quarantined
     ^                    │
     └────one success─────┘

A *failure* is any of: the lane's completed tick diverged (the once-per-tick
batched `isfinite` guard over per-lane float metrics and final agent params,
see `sweep.lane_finite_mask` — checked at host sync, never per epoch); an
injected/attributed tick exception (`faults.InjectedFault`); or the tick
overran `phase_deadline_s` with the stall attributed to the tenant.  A
failed phase attempt is *not* consumed: the tenant's cursor rewinds, its
result is discarded, its agent is NOT written to the store, and the phase is
retried after an exponential backoff (`backoff_base_s * 2**(retries-1)`).
If the tenant's *stored* snapshot itself is non-finite (silent store
corruption), the lineage first rolls back to its last-good PolicyStore
version (`PolicyStore.rollback`).  After `max_phase_retries` consecutive
failures the tenant is quarantined: removed from the slot schedule (its
slot recycles to the queue) and never scheduled again, while every other
tenant's results remain bit-identical to a fault-free run: lanes are
independent, a retried run is deterministic, and a transient fault's retry
therefore reproduces the fault-free result exactly.  Only
`faults.InjectedFault` is caught; a CUDA build or launch error propagates.

Removal semantics: `remove()` marks the tenant; a phase already sitting in
the double-buffered prepared batch is *dropped on advance* — its lane still
executes (static shapes), but its result is discarded and its agent is not
written back, so nothing a removed tenant did after removal is observable.

Fault injection: pass a `faults.FaultPlan` to arm deterministic faults
(poisoned warm agents, failed/stalled ticks, shrunken device visibility) at
explicit hook sites; with `faults=None` every hook site is a single `is
not None` check, and the only standing cost is the once-per-tick finite
guard (disable with `divergence_guard=False`).

Several cards: in a process group (`nmp.partition`) every rank builds the
same server, submits the same tenants and calls the same methods (SPMD).
The slots are a lane-sharded mesh over the ranks (`n_slots` rounded up to
its lane dim); each tick every rank runs its slot block, and `_complete`
gathers the tick's results to every rank before the write-back, so every
rank's store, tenants and counters stay identical.  Decisions read from the
wall clock (retry backoff, the phase deadline) are agreed: rank 0's
monotonic clock is every rank's, and a tick's wall is the slowest rank's,
so every rank schedules the same tenants and every gather is matched.  A
`shrink_devices` fault rebuilds the mesh over the first `keep_devices`
ranks; the ranks it drops hold no slots but keep joining the gathers.

Metrics: `MappingServer.stats()` reports per-phase latency p50/p99 over
steady-state ticks (ticks that dispatched a new signature, the port's
compile ticks, are excluded from the percentiles and their total wall is
reported separately as `compile_s`), steady-state epochs/sec, slot
occupancy, recompile and eviction counts, plus fault, retry, quarantine,
rollback and fallback counters.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import agent as agent_mod
from repro_torch.nmp import baselines, partition
from repro_torch.nmp import faults as faults_mod
from repro_torch.nmp import sweep as sweep_mod
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.continual import PolicyStore, check_tag
from repro_torch.nmp.engine import (BodyFlags, default_agent_cfg, pei_top_k,
                                    state_spec_for)
from repro_torch.nmp.faults import FaultPlan, InjectedFault
from repro_torch.nmp.plan import (Envelope, needs_agent, plan_envelope,
                                  plan_grid, seed_share_enabled)
from repro_torch.nmp.scenarios import Scenario
from repro_torch.nmp.sweep import SweepResult


def solo_stream(tenant_id: str,
                stream: Sequence[Sequence[Scenario] | Scenario]
                ) -> list[list[Scenario]]:
    """The reference protocol for one tenant: its stream re-tagged exactly
    as the server tags it (lineage == tenant id), runnable standalone via
    `continual.run_stream`.  A tenant's per-phase serving results are
    bit-identical to this solo run's."""
    return [[dataclasses.replace(_phase_scenario(ph), lineage=tenant_id)]
            for ph in stream]


def _phase_scenario(phase) -> Scenario:
    """Normalize one stream phase to its single scenario (serving slots are
    one lane wide; a phase may be a Scenario or a [Scenario])."""
    if isinstance(phase, Scenario):
        return phase
    phase = list(phase)
    if len(phase) != 1:
        raise ValueError(
            f"serving streams are single-lane: each phase must hold exactly "
            f"one scenario (got {len(phase)})")
    return phase[0]


@dataclasses.dataclass
class Tenant:
    """Bookkeeping for one submitted tenant stream."""
    tenant_id: str
    phases: list[Scenario]           # re-tagged, one scenario per phase
    cursor: int = 0                  # next phase to serve
    slot: int | None = None
    done: bool = False
    removed: bool = False
    health: str = "healthy"          # healthy | degraded | quarantined
    quarantined: bool = False
    retries: int = 0                 # consecutive failed attempts
    backoff_until: float = 0.0       # monotonic time gating the next attempt
    last_error: str | None = None
    latencies: list = dataclasses.field(default_factory=list)
    results: list = dataclasses.field(default_factory=list)
                                     # per served phase: (SweepResult, lane)

    @property
    def remaining(self) -> int:
        return len(self.phases) - self.cursor

    @property
    def stale(self) -> bool:
        """True when a prepared-batch entry for this tenant must be dropped
        (removed or quarantined after the batch was built)."""
        return self.removed or self.quarantined


class MappingServer:
    """Long-lived multi-tenant mapping service (see module docstring), on
    `device` (the card unless the caller asks for the CPU).

    `n_slots` is rounded up to the device-mesh width (the lane dim of the
    rank mesh; 1 alone).  `envelope`
    fixes the resident programs' padded shapes up front; by default it is
    inferred (and frozen) from everything submitted before the first tick,
    and later submissions must fit it.  `store` (or `store_capacity`)
    bounds the lineage store; `keep_results=False` drops per-phase metric
    arrays after recording latencies (long-running servers).

    Robustness knobs: `divergence_guard` runs the once-per-tick finite
    check; `max_phase_retries` bounds consecutive failed attempts before a
    tenant is quarantined; `backoff_base_s` seeds the exponential retry
    backoff; `phase_deadline_s` flags ticks that overran their deadline
    (an attributed stall counts as a failed attempt for that tenant);
    `faults` arms a deterministic `faults.FaultPlan` (tests/benchmarks)."""

    def __init__(self, cfg: NMPConfig = NMPConfig(), n_slots: int = 8,
                 envelope: Envelope | None = None,
                 agent_cfg=None, store: PolicyStore | None = None,
                 store_capacity: int | None = None,
                 keep_results: bool = True,
                 divergence_guard: bool = True,
                 max_phase_retries: int = 2,
                 backoff_base_s: float = 0.02,
                 phase_deadline_s: float | None = None,
                 faults: FaultPlan | None = None,
                 device: str | torch.device = "cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1 (got {n_slots})")
        if max_phase_retries < 0:
            raise ValueError(
                f"max_phase_retries must be >= 0 (got {max_phase_retries})")
        self.cfg = cfg
        self.device = partition.placement(device)
        self.mesh = partition.build_mesh(device=self.device)
        self.n_slots = partition.padded_lane_count(n_slots, self.mesh)
        # Tenants never fold, so every group is seed-width 1; a mesh with a
        # seed dim pads it (the padding slots are dropped).
        self.spec = state_spec_for(cfg)
        self.agent_cfg = agent_cfg or default_agent_cfg(cfg)
        if store is not None and store_capacity is not None:
            raise ValueError("pass either store or store_capacity, not both")
        self.store = (store if store is not None
                      else PolicyStore(capacity=store_capacity))
        self.envelope = envelope
        self.keep_results = keep_results
        self.guard = divergence_guard
        self.max_phase_retries = max_phase_retries
        self.backoff_base_s = backoff_base_s
        self.phase_deadline_s = phase_deadline_s
        self.faults = faults

        self._tenants: dict[str, Tenant] = {}
        self._queue: deque[str] = deque()
        self._slots: list[str | None] = [None] * self.n_slots
        self._episodes: int | None = (envelope.n_episodes
                                      if envelope is not None else None)
        self._flags = BodyFlags(has_agent=True, any_aimm=True, any_tom=False,
                                pei_k=0)
        self._tom_cands = None
        self._pending = None             # prepared-but-unserved next tick
        # Memo of host-side per-lane batch arrays keyed by trace identity:
        # an unchanged phase re-entering the resident shape re-uses the
        # seed-invariant arrays instead of re-quantizing the trace per tick.
        self._host_cache: dict = {}
        # Persistent staging buffers for the per-tick warm agent stacking:
        # the resident envelope fixes the cell count and leaf shapes, so in
        # steady state every tick refills the same host buffers and pays one
        # device copy per agent leaf.
        self._staging = sweep_mod.AgentStaging()
        # service metrics
        self.ticks = 0
        self._attempts = 0               # dispatch attempts (ticks + retries)
        self._tick_wall: list[float] = []
        self._tick_active: list[int] = []
        self._tick_compiles: list[int] = []
        self._phases_served = 0
        # fault / recovery counters
        self._tick_failures = 0          # dispatch attempts that raised
        self._global_failure_streak = 0  # consecutive unattributed failures
        self._divergences = 0            # non-finite lanes caught by guard
        self._deadline_misses = 0        # ticks over phase_deadline_s
        self._retries_total = 0
        self._quarantines = 0
        self._stale_dropped = 0          # prepared entries dropped on advance
        self._device_shrinks = 0
        self._validation_rejects = 0

    # -- tenant lifecycle ----------------------------------------------

    def submit(self, tenant_id: str,
               stream: Sequence[Sequence[Scenario] | Scenario]) -> None:
        """Enqueue a tenant stream.  The tenant id becomes the lineage tag
        of every phase (duplicate ids — which would silently share one DQN
        across tenants — are rejected while the earlier tenant is live).
        Streams are validated at this boundary: malformed traces (NaN/Inf,
        negative or out-of-range page ids, empty op/page counts) raise a
        `ValueError` naming the tenant and phase instead of flowing into
        the engine."""
        check_tag(tenant_id)
        prev = self._tenants.get(tenant_id)
        if prev is not None and not prev.done and not prev.quarantined:
            raise ValueError(
                f"tenant {tenant_id!r} is already live (queued or in a "
                "slot); duplicate lineage tags would share one DQN across "
                "tenants — wait for it to drain or pick a distinct id")
        phases = [dataclasses.replace(_phase_scenario(ph),
                                      lineage=tenant_id) for ph in stream]
        if not phases:
            raise ValueError(f"tenant {tenant_id!r}: empty stream")
        for pi, sc in enumerate(phases):
            try:
                self._validate_scenario(tenant_id, pi, sc)
            except ValueError:
                self._validation_rejects += 1
                raise
        for sc in phases:
            self._absorb_flags(sc)
        self._tenants[tenant_id] = Tenant(tenant_id=tenant_id, phases=phases)
        self._queue.append(tenant_id)
        self._pending = None             # schedule changed; re-prepare

    def remove(self, tenant_id: str) -> None:
        """Depart a tenant mid-stream: frees its slot (or queue entry)
        immediately.  A phase of the tenant already sitting in the prepared
        (double-buffered) next batch is dropped on advance — it can neither
        complete into `results` nor write its agent back to the store.  The
        lineage stays in the store until evicted."""
        t = self._tenants[tenant_id]
        if t.done:
            return
        t.done = t.removed = True
        if t.slot is not None:
            self._slots[t.slot] = None
            t.slot = None
            # the prepared batch (if any) may still hold this tenant's
            # phase: kept — its entry is stale-dropped at advance/complete
        else:
            self._queue = deque(q for q in self._queue if q != tenant_id)

    def _validate_scenario(self, tenant_id: str, phase_idx: int,
                           sc: Scenario) -> None:
        self._validate_trace(tenant_id, phase_idx, sc)
        if not needs_agent(sc):
            raise ValueError(
                f"tenant {tenant_id!r}: serving slots run learned-AIMM "
                f"lanes (got mapper={sc.mapper!r}, "
                f"forced_action={sc.forced_action})")
        if sc.topology is not None and sc.topology != self.cfg.topology:
            raise ValueError(
                f"tenant {tenant_id!r}: scenario topology {sc.topology!r} "
                f"differs from the server's {self.cfg.topology!r}; one "
                "resident program serves one interconnect")
        if self._episodes is None:
            self._episodes = sc.total_episodes
        elif sc.total_episodes != self._episodes:
            raise ValueError(
                f"tenant {tenant_id!r}: phase runs {sc.total_episodes} "
                f"episodes but the server's resident programs are fixed at "
                f"{self._episodes}; all tenants must share one phase "
                "episode count")
        if self.envelope is not None:
            need = plan_envelope([sc], self.cfg)
            if not self.envelope.dominates(need):
                raise ValueError(
                    f"tenant {tenant_id!r}: phase needs envelope {need} "
                    f"but the server's is frozen at {self.envelope}")

    def _validate_trace(self, tenant_id: str, phase_idx: int,
                        sc: Scenario) -> None:
        """Input validation at the submit boundary: reject trace arrays that
        would silently flow into the engine as garbage."""
        tr = sc.trace
        where = f"tenant {tenant_id!r} phase {phase_idx} ({sc.name!r})"
        if tr.n_pages <= 0:
            raise ValueError(f"{where}: non-positive page count "
                             f"{tr.n_pages}")
        if tr.n_ops <= 0:
            raise ValueError(f"{where}: empty op trace")
        for field in ("dest", "src1", "src2"):
            a = np.asarray(getattr(tr, field))
            if np.issubdtype(a.dtype, np.floating):
                if not np.isfinite(a).all():
                    raise ValueError(
                        f"{where}: trace {field!r} contains NaN/Inf entries")
            if a.size and int(a.min()) < 0:
                raise ValueError(
                    f"{where}: trace {field!r} contains negative page ids")
            if a.size and int(a.max()) >= tr.n_pages:
                raise ValueError(
                    f"{where}: trace {field!r} references page "
                    f"{int(a.max())} outside the {tr.n_pages}-page space")

    def _absorb_flags(self, sc: Scenario) -> None:
        """Grow the resident BodyFlags monotonically (a new capability,
        e.g. the first PEI tenant, is one new dispatch signature; the flags
        stay a superset of every lane's needs, which the engine's per-lane
        gating makes exact)."""
        if sc.technique == "pei":
            k = pei_top_k(sc.trace.n_pages, self.cfg)
            if k > self._flags.pei_k:
                self._flags = dataclasses.replace(self._flags, pei_k=k)
                self._pending = None

    # -- scheduling ----------------------------------------------------

    def _now(self) -> float:
        """The monotonic clock every decision reads: on a mesh rank 0's
        (one broadcast), so every rank decides alike."""
        now = time.monotonic()
        return now if self.mesh is None else partition.agree(now)

    def _freeze_envelope(self) -> None:
        if self.envelope is None:
            scs = [sc for t in self._tenants.values() if not t.done
                   for sc in t.phases]
            env = plan_envelope(scs, self.cfg)
            # phase episode counts are uniform (enforced at submit)
            self.envelope = dataclasses.replace(env,
                                                n_episodes=self._episodes)
        if self._tom_cands is None:
            self._tom_cands = baselines.tom_candidates(
                self.envelope.n_pages_max, self.cfg, self.device)

    def _schedule(self) -> list[tuple[int, Tenant]]:
        """Assign queued tenants to free slots and return the active
        (slot, tenant) pairs in slot order — the lane order of the tick's
        batched run.  Pure bookkeeping: never waits on device results.
        Slot holders inside their retry backoff window are skipped (their
        slot idles until the backoff expires)."""
        now = self._now()
        for i, tid in enumerate(self._slots):
            if tid is None and self._queue:
                nxt = self._queue.popleft()
                self._slots[i] = nxt
                self._tenants[nxt].slot = i
        return [(i, self._tenants[tid])
                for i, tid in enumerate(self._slots)
                if tid is not None
                and self._tenants[tid].backoff_until <= now]

    def _backoff_wait(self) -> bool:
        """When every slotted tenant is inside its backoff window, sleep
        until the earliest one expires.  True if a wait happened."""
        now = self._now()
        waits = [self._tenants[tid].backoff_until - now
                 for tid in self._slots if tid is not None]
        waits = [w for w in waits if w > 0]
        if not waits:
            return False
        time.sleep(min(waits) + 1e-4)
        return True

    def _prepare_next(self):
        """Build (and host->device transfer) the next tick's batch, or None
        when no tenant has work.  Callable while a previous tick is still
        executing on device (double buffering)."""
        sched = self._schedule()
        if not sched and self._backoff_wait():
            sched = self._schedule()
        if not sched:
            return None
        self._freeze_envelope()
        scs = [t.phases[t.cursor] for _, t in sched]
        plan = plan_grid(scs, self.cfg, envelope=self.envelope)
        groups = [g for g in plan.groups if g.n_lanes]
        assert len(groups) == 1, "serving lanes form one lineage group"
        group = groups[0]
        # Plan lanes are cost-sorted for shard packing, so lane position no
        # longer equals schedule position; tenants never fold (distinct
        # lineage tags), so each lane maps back to exactly one sched entry.
        lane_of = [0] * len(sched)
        for li, lane in enumerate(group.lanes):
            lane_of[lane.indices[0]] = li
        batch, _ = sweep_mod.prepare_group_batch(plan, group, self.cfg,
                                                 self.device,
                                                 n_lanes=self.n_slots,
                                                 host_cache=self._host_cache,
                                                 mesh=self.mesh)
        return (sched, scs, plan, group, batch, lane_of)

    def _advance(self, sched: list[tuple[int, Tenant]]) -> None:
        """Consume the served phase of every scheduled tenant and recycle
        the slots of drained tenants (deterministic — usable before the
        tick's results land).  Entries whose tenant was removed or
        quarantined after the batch was prepared are dropped here: their
        phase is NOT consumed and their lane's result will be discarded."""
        for slot, t in sched:
            if t.stale:
                continue
            t.cursor += 1
            if t.cursor >= len(t.phases):
                t.done = True
                t.slot = None
                self._slots[slot] = None

    # -- fault handling ------------------------------------------------

    def _maybe_shrink(self) -> bool:
        """Apply an armed shrink_devices fault: rebuild the mesh over the
        first `keep_devices` ranks.  The resident slot count is fixed, so it
        must stay divisible by the new width; the next dispatch re-places
        the slots and per-lane results stay bit-identical (the partition
        layer's standing invariant).  The dropped ranks hold no slots but
        keep joining the gathers; a lone process shrinks 1 -> 1."""
        if self.faults is None:
            return False
        keep = self.faults.shrink_devices_now(self._attempts)
        if keep is None:
            return False
        devs = partition.sweep_devices(self.device)
        keep = max(1, min(int(keep), len(devs)))
        if self.n_slots % keep:
            raise ValueError(
                f"cannot shrink to {keep} devices: the resident slot count "
                f"{self.n_slots} must stay device-divisible")
        # Shrink to a lane-only mesh explicitly: a REPRO_SWEEP_MESH override
        # was shaped for the full rank count and would not factor `keep`.
        self.mesh = partition.build_mesh(devs[:keep], shape=(keep, 1),
                                         device=self.device)
        self._tom_cands = None           # rebuilt on next freeze
        self._device_shrinks += 1
        self._pending = None             # placed on the old mesh; rebuild
        return True

    def _degrade(self, t: Tenant, reason: str) -> None:
        """One failed phase attempt: bounded retry with exponential backoff,
        escalating to quarantine."""
        t.retries += 1
        t.last_error = reason
        self._retries_total += 1
        if t.retries > self.max_phase_retries:
            self._quarantine(t, reason)
        else:
            t.health = "degraded"
            t.backoff_until = (self._now()
                               + self.backoff_base_s * 2 ** (t.retries - 1))

    def _quarantine(self, t: Tenant, reason: str) -> None:
        """Remove a repeatedly failing tenant from the slot schedule for
        good; every other tenant keeps serving."""
        t.health = "quarantined"
        t.quarantined = True
        t.last_error = reason
        self._quarantines += 1
        if t.slot is not None:
            self._slots[t.slot] = None
            t.slot = None
        else:
            self._queue = deque(q for q in self._queue
                                if q != t.tenant_id)

    def _rewind(self, t: Tenant, reason: str) -> None:
        """Un-consume a diverged/stalled lane's phase (the advance already
        ran) so the attempt can be retried, triaging the stored snapshot:
        a non-finite store entry rolls the lineage back to its last-good
        version first."""
        t.cursor -= 1
        if t.done:                       # advance drained it; revive
            t.done = False
            self._queue.appendleft(t.tenant_id)
        tag = t.tenant_id
        if tag in self.store and not faults_mod.params_finite(
                self.store.get(tag)):
            self.store.rollback(tag)
        self._degrade(t, reason)

    def _fail_attempt(self, sched, tenant_id: str | None,
                      reason: str) -> None:
        """A dispatch attempt raised before completing.  Attributed faults
        degrade only their tenant; unattributed ones are retried whole-tick
        with a bounded consecutive-failure budget."""
        self._tick_failures += 1
        if tenant_id is not None and tenant_id in self._tenants:
            self._global_failure_streak = 0
            self._degrade(self._tenants[tenant_id], reason)
            return
        self._global_failure_streak += 1
        if self._global_failure_streak > self.max_phase_retries:
            raise InjectedFault(
                f"service tick failed {self._global_failure_streak} "
                f"consecutive times without tenant attribution: {reason}")
        time.sleep(self.backoff_base_s
                   * 2 ** (self._global_failure_streak - 1))

    # -- serving -------------------------------------------------------

    def _serve_one(self, prepared, overlap: bool):
        sched, scs, plan, group, batch, lane_of = prepared
        tenant_ids = [t.tenant_id for _, t in sched]
        attempt = self._attempts
        self._attempts += 1
        # the executed seed width (1, or the mesh's seed dim) and this
        # rank's share of it
        s_pad = partition.padded_seed_count(group.n_seeds, self.mesh)
        s_loc = s_pad // partition.mesh_seed_dim(self.mesh)
        warm = (sweep_mod._warm_agent_batch(group, self.n_slots, self.store,
                                            self.agent_cfg, self.device,
                                            n_seeds=s_pad,
                                            staging=self._staging,
                                            mesh=self.mesh)
                if batch is not None else None)
        stalled: tuple[str, ...] = ()
        if self.faults is not None:
            # poison indexes cells by position in the tenants list, which
            # must therefore follow lane (not schedule) order
            lane_tenants = [tenant_ids[lane.indices[0]]
                            for lane in group.lanes]
            warm = self.faults.poison_warm_agents(
                attempt, lane_tenants, warm, s_pad,
                held=(None if self.mesh is None else partition.local_cells(
                    self.mesh, self.n_slots, s_pad)))
        n_prog0 = sweep_mod.compiled_sweep_programs()
        t0 = time.perf_counter()
        try:
            if self.faults is not None:
                stalled = self.faults.on_dispatch(attempt, tenant_ids)
            out = agent_fin = None
            if batch is not None:
                out, _env_fin, agent_fin = sweep_mod.dispatch_sweep(
                    batch, self._tom_cands, self.cfg, self.spec,
                    self.agent_cfg, self.envelope.n_epochs,
                    group.n_episodes, self.envelope.ring_len,
                    dataclasses.replace(
                        self._flags,
                        share_seed_inv=s_loc > 1 and seed_share_enabled()),
                    warm_agent=warm, want_agent=True)
            self._advance(sched)
            # the card is executing this tick: overlap the next tick's host
            # batch build + copy with it
            nxt = self._prepare_next() if overlap else None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except InjectedFault as e:
            self._fail_attempt(sched, e.tenant, str(e))
            return self._prepare_next() if overlap else None
        wall = time.perf_counter() - t0
        if self.mesh is not None:
            wall = partition.agree_max(wall)      # the slowest rank's
        self._global_failure_streak = 0
        dirty = self._complete(sched, scs, out, agent_fin, group, wall,
                               sweep_mod.compiled_sweep_programs() - n_prog0,
                               stalled, s_pad, lane_of, s_loc)
        if dirty:
            # a lane failed after the next batch was prepared: its schedule
            # (and the failed tenant's cursor) changed — rebuild
            nxt = self._prepare_next() if overlap else None
        return nxt

    def _complete(self, sched, scs, out, agent_fin, group, wall: float,
                  compiles: int, stalled: Sequence[str] = (),
                  s_pad: int = 1,
                  lane_of: Sequence[int] | None = None,
                  s_loc: int | None = None) -> bool:
        # s_pad is the *executed* seed width: 1 (tenants never fold
        # together), or the mesh's seed dim; slot 0 of each lane is the
        # tenant's cell.  On a mesh `out`/`agent_fin` are this rank's block
        # (s_loc seed slots a lane), gathered here before anything is read.
        missed = (self.phase_deadline_s is not None
                  and wall > self.phase_deadline_s)
        if missed:
            self._deadline_misses += 1
        if lane_of is None:
            lane_of = list(range(len(sched)))
        out = sweep_mod.host_outs(out, self.mesh)
        host_agents = partition.host_fetch(
            None if agent_fin is None else agent_mod.export_agents(agent_fin),
            self.mesh, seeds=s_loc)
        finite = (sweep_mod.lane_finite_mask(out, host_agents, len(sched),
                                             s_pad)
                  if self.guard else np.ones(len(sched), bool))
        lanes = lambda v: np.stack([v[lane_of[li], 0]
                                    for li in range(len(sched))])
        actions = lanes(out.pop("action_t"))
        res = SweepResult(
            scenarios=scs, cfg=self.cfg,
            metrics={k: lanes(v) for k, v in out.items()},
            final_env=None, n_episodes=group.n_episodes, wall_s=wall,
            actions=actions)
        served = 0
        dirty = False
        for li, (slot, t) in enumerate(sched):
            if t.stale:                  # removed/quarantined after prepare
                self._stale_dropped += 1
                continue
            if not finite[lane_of[li]]:
                self._divergences += 1
                self._rewind(t, f"divergence: non-finite metrics or agent "
                                f"params in phase {t.cursor - 1}")
                dirty = True
                continue
            if missed and t.tenant_id in stalled:
                self._rewind(t, f"deadline: tick ran {wall:.3f}s > "
                                f"{self.phase_deadline_s}s (attributed "
                                "stall)")
                dirty = True
                continue
            cell = agent_mod.snapshot_cell(host_agents, lane_of[li] * s_pad)
            self.store.put(t.tenant_id, cell, scenario=scs[li].name,
                           tenant=t.tenant_id)
            t.latencies.append(wall)
            if self.keep_results:
                t.results.append((res, li))
            t.retries = 0
            t.health = "healthy"
            t.backoff_until = 0.0
            served += 1
        self.ticks += 1
        self._phases_served += served
        self._tick_wall.append(wall)
        self._tick_active.append(served)
        self._tick_compiles.append(compiles)
        return dirty

    def tick(self) -> int:
        """Run one synchronous service step.  Returns the number of tenant
        phases served (0 = no work pending)."""
        self._maybe_shrink()
        prepared = self._pending or self._prepare_next()
        self._pending = None
        if prepared is None:
            return 0
        before = self._phases_served
        self._serve_one(prepared, overlap=False)
        return self._phases_served - before

    def run(self, max_ticks: int | None = None) -> int:
        """Drain every submitted stream, double-buffering the next tick's
        host batch against the current device step.  Returns dispatch
        attempts run (ticks + retries)."""
        n = 0
        while True:
            if self._maybe_shrink() or self._pending is None:
                self._pending = self._prepare_next()
            if self._pending is None:
                break
            if max_ticks is not None and n >= max_ticks:
                break
            self._pending = self._serve_one(self._pending, overlap=True)
            n += 1
        return n

    # -- results & metrics ---------------------------------------------

    def tenant(self, tenant_id: str) -> Tenant:
        return self._tenants[tenant_id]

    def tenant_metrics(self, tenant_id: str, phase: int) -> dict:
        """The raw per-episode metric arrays of one served tenant phase —
        directly comparable (bit-exact) to the matching
        `run_stream(solo_stream(...))` phase's `metrics[...][lane]` (the
        per-epoch actions are in `results[phase][0].actions`)."""
        res, lane = self._tenants[tenant_id].results[phase]
        return {k: v[lane] for k, v in res.metrics.items()}

    def tenant_summary(self, tenant_id: str, phase: int,
                       episode: int | None = None) -> dict:
        res, lane = self._tenants[tenant_id].results[phase]
        return res.episode_summary(lane, episode)

    def stats(self) -> dict:
        """Service-level metrics surface.

        Phase-latency percentiles are computed over *steady-state* ticks
        only (ticks after the last one that dispatched a new signature, the
        port's compile: its first dispatch also pays the kernels' build),
        weighted by the phases each tick served.  That cost is reported
        separately as `compile_s` (total wall of every such tick)."""
        wall = np.asarray(self._tick_wall, np.float64)
        active = np.asarray(self._tick_active, np.float64)
        compiles = np.asarray(self._tick_compiles, int)
        # steady state: ticks after the last one with a new signature
        last_c = int(np.max(np.nonzero(compiles)[0])) if compiles.any() else -1
        steady = slice(last_c + 1, None)
        # one latency sample per phase served in a steady-state tick
        lat = np.repeat(wall[steady], active[steady].astype(int))
        ep = self.envelope
        epochs_per_tick = (active * ep.n_epochs * ep.n_episodes
                           if ep is not None else active * 0)
        steady_wall = float(wall[steady].sum())
        health: dict[str, int] = {"healthy": 0, "degraded": 0,
                                  "quarantined": 0}
        for t in self._tenants.values():
            health[t.health] = health.get(t.health, 0) + 1
        return {
            "ticks": self.ticks,
            "n_slots": self.n_slots,
            "n_devices": partition.mesh_desc(self.mesh)["n_devices"],
            "tenants_submitted": len(self._tenants),
            "tenants_done": sum(t.done for t in self._tenants.values()),
            "tenants_removed": sum(t.removed for t in self._tenants.values()),
            "tenants_quarantined": sum(t.quarantined
                                       for t in self._tenants.values()),
            "tenant_health": health,
            "phases_served": self._phases_served,
            "phase_latency_p50_s": (float(np.percentile(lat, 50))
                                    if lat.size else None),
            "phase_latency_p99_s": (float(np.percentile(lat, 99))
                                    if lat.size else None),
            "compile_s": float(wall[compiles > 0].sum()),
            "slot_occupancy": (float((active / self.n_slots).mean())
                               if active.size else 0.0),
            "recompiles_total": int(compiles.sum()),
            "recompiles_after_first_tick": (int(compiles[1:].sum())
                                            if compiles.size else 0),
            "steady_ticks": int(wall[steady].size),
            "steady_epochs_per_sec": (
                float(epochs_per_tick[steady].sum() / steady_wall)
                if steady_wall > 0 and wall[steady].size else None),
            "store": {"tags": len(self.store), "capacity":
                      self.store.capacity, "evictions":
                      self.store.evictions},
            "faults": {
                "injected": (len(self.faults.injected)
                             if self.faults is not None else 0),
                "tick_failures": self._tick_failures,
                "divergences": self._divergences,
                "deadline_misses": self._deadline_misses,
                "retries": self._retries_total,
                "quarantines": self._quarantines,
                "stale_dropped": self._stale_dropped,
                "device_shrinks": self._device_shrinks,
                "validation_rejects": self._validation_rejects,
                "rollbacks": self.store.rollbacks,
                "restore_fallbacks": self.store.restore_fallbacks,
            },
        }
