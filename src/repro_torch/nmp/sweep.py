"""Execute layer of the sweep pipeline: the batched engine `run_grid`
(port of `repro.nmp.sweep`).

`run_grid` is the reference's three-layer pipeline:

  plan      (nmp.plan)      : normalize scenarios into a `GridPlan` — shared
                              padding envelope, lanes grouped by DQN
                              liveness and topology, seeds folded into a
                              per-lane seed axis, lanes cost-ordered;
  partition (nmp.partition) : a (lane, seed) mesh over the ranks of a
                              process group, one card each (the reference's
                              device mesh), or one device alone; each rank
                              runs its block of every group batch;
  execute   (this module)   : one batched run per lane group — episode
                              chaining with the env reset per episode and
                              the agent chained, the epoch loop
                              (`engine.scan_epochs`) over every (lane, seed)
                              cell at once: env, agent and metrics flat over
                              L·S cells, trace arrays per lane.  Groups run
                              heaviest-first (`plan.packed_group_order`),
                              and each group's results are fetched and
                              unfolded on one worker thread while the next
                              group's epochs are dispatched
                              (REPRO_SWEEP_LAND=async, the default; `sync`
                              lands in the loop, with the same results).

Where the reference compiles one program per group, the port dispatches
its epochs eagerly; with B = L·S cells every launch of the fused epoch
kernel, the qnet kernel and the threefry kernel serves the whole group, so
a grid pays about one cell's host dispatch per epoch.  With a folded seed
axis (S > 1) the seed-invariant shared stage runs once per lane and the
route stage once per cell (`BodyFlags.share_seed_inv`, REPRO_SEED_SHARE).

Exactness: every (lane, seed) cell's cycles, ops and OPC equal a serial
`run_episode`/`run_program` of the same scenario on the same device (every
update is gated on has_ops, so padded lanes and episodes are exact no-ops),
and on the CPU the reference's `run_grid`.  On a mesh each rank runs an
independent block (no cell's work crosses a rank), every collective is a
gather of landed results issued in dispatch order from the landing thread,
and every rank reassembles the same whole result and writes the same
lineage write-backs into its own `PolicyStore`, so the stores stay
identical.

Agent lifecycle: cold-start lanes are born and die inside the group's
run; lanes that declare a `Scenario.lineage` tag form a separate group
whose initial agent batch comes in from a `continual.PolicyStore` (warm
cells from the store, fresh tags cold-started from the cell's seed, built
through `AgentStaging`'s host buffers: one host->device copy per leaf)
and whose final agents go back to the store.

Where the reference counts compiled XLA programs
(`compiled_sweep_programs`), the eager port counts the distinct dispatch
signatures (group flags plus padded batch shapes): the first dispatch of a
signature is the port's counterpart of a compile (it also pays the
kernels' build, once per process).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import agent as agent_mod
from repro_torch.core.tree import leaf_paths, unflatten
from repro_torch.nmp import partition
from repro_torch.nmp import plan as plan_mod
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.engine import (TraceCtx, _init_env, _map_state,
                                    _repeat, default_agent_cfg, scan_epochs,
                                    state_spec_for)
from repro_torch.nmp.plan import GridPlan, needs_agent, plan_grid
from repro_torch.nmp.scenarios import Scenario
from repro_torch.nmp.stats import energy_breakdown, energy_nj, resample_opc
from repro_torch.nmp.topology import get_topology, topology_tensors

LAND_KNOB = "REPRO_SWEEP_LAND"
LAND_MODES = ("async", "sync")


def _env_choice(knob: str, default: str, choices: tuple[str, ...]) -> str:
    val = os.environ.get(knob, default)
    if val not in choices:
        raise ValueError(f"{knob}={val!r} is not a valid mode; expected one "
                         f"of {choices}")
    return val


def land_mode() -> str:
    """How `run_grid` lands group results (REPRO_SWEEP_LAND): `async`
    (default) fetches and unfolds group k on a worker thread while group
    k+1 is dispatched; `sync` lands in the loop.  Same results either way."""
    return _env_choice(LAND_KNOB, "async", LAND_MODES)


# Fail fast on a typo'd knob at import, as the reference.
land_mode()


class AgentStaging:
    """Reusable host-side staging for the warm agent batch.

    Stacking cell by cell costs one host->device import per warm cell, one
    `cold_start` per fresh cell and a device concatenation per leaf, all
    garbage one tick later.  This class keeps

      * one preallocated numpy buffer per agent leaf, (n_cells, *leaf):
        rows are filled in place from the store's host snapshots, so a
        steady-state tick pays one host->device copy per *leaf*
        (`agent.import_agents`) instead of one per cell;
      * a bounded cache of cold-start snapshots keyed by (seed, agent_cfg,
        device), so a fresh lineage's cold cell is computed once.

    Buffers are reallocated when the cell count or a leaf's shape changes
    and reused otherwise; the device copy is taken at dispatch, so refilling
    next tick is safe."""

    _COLD_CACHE_MAX = 128        # cold cells are only needed for fresh
                                 # tags, so this never grows in steady state

    def __init__(self):
        self._bufs: list[np.ndarray] | None = None
        self._keys: list[str] | None = None
        self._cold: dict = {}

    def cold_cell(self, seed: int, agent_cfg, device: torch.device):
        """Host snapshot of `agent_mod.cold_start(seed, agent_cfg)` drawn on
        `device` (where the group's in-run cold start would draw it)."""
        key = (int(seed), agent_cfg, str(device))
        if key not in self._cold:
            if len(self._cold) >= self._COLD_CACHE_MAX:
                self._cold.pop(next(iter(self._cold)))
            self._cold[key] = agent_mod.export_agent(
                agent_mod.cold_start(int(seed), agent_cfg, device=device))
        return self._cold[key]

    def stack(self, cells):
        """Stack host snapshots into the reused (n_cells, ...) buffers;
        returns the stacked snapshot (numpy leaves viewing the buffers)."""
        flat0 = leaf_paths(cells[0])
        fit = (self._bufs is not None
               and self._keys == [k for k, _ in flat0]
               and self._bufs[0].shape[0] == len(cells)
               and all(b.shape[1:] == np.shape(l) and b.dtype == l.dtype
                       for b, (_, l) in zip(self._bufs, flat0)))
        if not fit:
            self._bufs = [np.empty((len(cells),) + np.shape(l),
                                   np.asarray(l).dtype) for _, l in flat0]
            self._keys = [k for k, _ in flat0]
        for i, cell in enumerate(cells):
            for buf, (_, leaf) in zip(self._bufs, leaf_paths(cell)):
                buf[i] = leaf
        return unflatten(cells[0], dict(zip(self._keys, self._bufs)))


def _warm_agent_batch(group, n_lanes_padded: int, store, agent_cfg,
                      device: torch.device, n_seeds: int | None = None,
                      staging: AgentStaging | None = None, mesh=None):
    """Initial agent batch of a lineage group on `device`: flat (L*S,)
    cells, lane-major; on a mesh this rank's cells of it
    (`partition.shard_agent_batch`), None past the mesh.

    A cell whose lineage tag is in the store warm-starts from the stored
    agent (scenario-boundary handoff applied); a fresh tag cold-starts the
    lineage with the cell's own seed.  `n_seeds` is the executed seed width
    (seed slot 0 repeats up to it, as `partition.pad_seed_axis`), and
    padding lanes repeat lane 0's cells, as `partition.pad_group_batch`.

    The cells are stacked in `staging`'s host buffers, which persist across
    calls where the caller holds one (`run_grid` per grid, the serving
    layer per server; a throwaway one otherwise), and go to the device as
    one copy per leaf."""
    S = group.n_seeds if n_seeds is None else n_seeds
    staging = staging or AgentStaging()
    cells = []
    for lane in group.lanes:
        tag = lane.scenario.lineage
        # one checkout per tag; seed replicas reuse the read-only snapshot
        # and the stacking below gives each its own row
        warm = (store.checkout_host(tag)
                if store is not None and tag in store else None)
        seeds = lane.seeds + (lane.seeds[0],) * (S - group.n_seeds)
        for seed in seeds:
            cells.append(warm if warm is not None
                         else staging.cold_cell(int(seed), agent_cfg, device))
    lane0 = cells[:S]
    for _ in range(n_lanes_padded - group.n_lanes):
        cells.extend(lane0)
    cells = partition.shard_agent_batch(cells, mesh, n_lanes_padded, S)
    if cells is None:
        return None
    return agent_mod.import_agents(staging.stack(cells), device)


def _run_sweep(batch: dict, tom_cands: torch.Tensor, cfg: NMPConfig, spec,
               agent_cfg, n_epochs: int, n_episodes: int, ring_len: int,
               flags, topo, warm_agent=None):
    """Every (lane, seed) cell of one group through `n_episodes` chained
    episodes: the env re-initialized per episode from that episode's seeds,
    the agent chained through.  The agent is `warm_agent` (flat (L*S,)
    cells: a lineage group's batch) or, by default, cold-started per cell
    from its first seed.  `batch["ep_seed"]` is (L, S, E); trace arrays stay
    per lane.  Returns (outs with leaves (L, S, E, ...), final env over L·S
    cells, final agent)."""
    trace = {k: batch[k] for k in ("dest", "src1", "src2")}
    L, S, _E = batch["ep_seed"].shape
    ctx = TraceCtx(
        n_ops=batch["n_ops"], n_pages=batch["n_pages"],
        t_ring=batch["t_ring"], pei_idx=batch["pei_idx"],
        technique=batch["technique"], mapper=batch["mapper"],
        forced_action=batch["forced_action"],
        explore=torch.zeros_like(batch["ep_explore"][:, 0]))
    page_table = _repeat(batch["page_table"], S)
    if warm_agent is not None:
        agent = warm_agent
    else:
        agent = (agent_mod.cold_start(
            batch["ep_seed"][:, :, 0].reshape(L * S), agent_cfg)
            if flags.has_agent else None)
    outs, env = [], None
    for e in range(n_episodes):
        env = _init_env(page_table, cfg, spec, topo, ring_len,
                        batch["ep_seed"][:, :, e].reshape(L * S))
        ctx_e = dataclasses.replace(ctx, explore=batch["ep_explore"][:, e])
        env, agent2, ms = scan_epochs(trace, batch["rw"], env, agent,
                                      tom_cands, ctx_e, cfg, spec, agent_cfg,
                                      n_epochs, flags, topo, seed_axis=True)
        if flags.has_agent:
            agent = agent2
        grid = lambda t: t.reshape((L, S) + t.shape[1:])
        timeline = lambda t: t.permute(1, 2, 0)          # (L, S, n_epochs)
        outs.append({
            "cycles": grid(env.cycles), "ops": grid(env.ops_done),
            "hops_sum": grid(env.hops_sum), "util_sum": grid(env.util_sum),
            "epochs": grid(env.epochs), "migrations": grid(env.mig_count),
            "pages_migrated": grid(env.mig_page_mask.sum(dim=-1)),
            "access_total": grid(env.access_total),
            "access_on_migrated": grid(env.access_on_migrated),
            "energy": grid(env.energy),
            "opc_t": timeline(ms["opc"]), "valid_t": timeline(ms["valid"]),
            "invoke_t": timeline(ms["invoke"]),
            "action_t": timeline(ms["action"]),
        })
    out = {k: torch.stack([o[k] for o in outs], dim=2) for k in outs[0]}
    return out, env, agent


@dataclasses.dataclass
class SweepResult:
    scenarios: list[Scenario]
    cfg: NMPConfig
    metrics: dict[str, np.ndarray]   # (B, E) scalars; energy (B, E, EN_N);
                                     # opc_t/valid_t/invoke_t (B, E, n_epochs)
    final_env: Any                   # EnvState with numpy leaves stacked
                                     # over the scenarios
    n_episodes: int                  # common (padded) episode count E
    wall_s: float                    # build + run + landing wall time
    plan: GridPlan | None = None     # the executed plan (seed folding, groups)
    n_devices: int = 1               # devices the sweep ran on
    mesh_shape: tuple[int, int] = (1, 1)   # (lane, seed) device mesh dims
    store: Any = None                # the PolicyStore holding the grid's
                                     # final agent lineages (None when no
                                     # lane declared a lineage)
    actions: np.ndarray | None = None  # (B, E, n_epochs) int8 per-epoch
                                     # action: the port's addition (the
                                     # reference's result has none), to hold
                                     # learned lanes epoch by epoch

    def episode_summary(self, lane: int, episode: int | None = None) -> dict:
        """Per-(lane, episode) summary with the same keys as stats.summarize.

        `episode` defaults to the scenario's last real episode (its greedy
        eval episode when `eval_episode` is set)."""
        sc = self.scenarios[lane]
        e = sc.total_episodes - 1 if episode is None else episode
        m = self.metrics
        cycles = max(float(m["cycles"][lane, e]), 1.0)
        ops = float(m["ops"][lane, e])
        return {
            "cycles": cycles,
            "ops": ops,
            "opc": ops / cycles,
            "mean_hops": float(m["hops_sum"][lane, e]) / max(ops, 1.0),
            "compute_util": (float(m["util_sum"][lane, e])
                             / max(float(m["epochs"][lane, e]), 1.0)),
            "migrations": float(m["migrations"][lane, e]),
            "frac_pages_migrated": (float(m["pages_migrated"][lane, e])
                                    / sc.trace.n_pages),
            "frac_access_migrated": (float(m["access_on_migrated"][lane, e])
                                     / max(float(m["access_total"][lane, e]),
                                           1.0)),
            "energy_nj": energy_nj(torch.from_numpy(m["energy"][lane, e])),
            "energy_breakdown": energy_breakdown(
                torch.from_numpy(m["energy"][lane, e])),
        }

    def summary(self, lane: int) -> dict:
        return self.episode_summary(lane)

    def opc_timeline(self, lane: int, episode: int | None = None,
                     samples: int = 64) -> np.ndarray:
        sc = self.scenarios[lane]
        e = sc.total_episodes - 1 if episode is None else episode
        return resample_opc(self.metrics["opc_t"][lane, e],
                            self.metrics["valid_t"][lane, e], samples)

    def invocations(self, lane: int, episode: int | None = None) -> int:
        """Agent invocations in one episode (all real episodes when None)."""
        sc = self.scenarios[lane]
        inv = self.metrics["invoke_t"][lane]
        if episode is not None:
            return int(inv[episode].sum())
        return int(inv[:sc.total_episodes].sum())

    # ---- variance bands over the folded seed axis ----

    def seed_group(self, lane: int) -> list[int]:
        """Scenario indices of every seed replica folded into `lane`'s lane."""
        if self.plan is None:
            return [lane]
        return list(self.plan.seed_group(lane))

    def variance_band(self, lane: int, episode: int | None = None,
                      keys: Sequence[str] = ("opc", "cycles",
                                             "energy_nj")) -> dict:
        """mean±std of per-seed episode summaries across `lane`'s seed
        group: {"seeds": [...], "n": S, "<key>_mean": ..., "<key>_std": ...}."""
        members = self.seed_group(lane)
        sums = [self.episode_summary(i, episode) for i in members]
        band: dict[str, Any] = {
            "seeds": [self.scenarios[i].seed for i in members],
            "n": len(members),
        }
        for k in keys:
            vals = np.asarray([s[k] for s in sums], np.float64)
            band[f"{k}_mean"] = float(vals.mean())
            band[f"{k}_std"] = float(vals.std())
        return band

    def opc_timeline_band(self, lane: int, episode: int | None = None,
                          samples: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) resampled OPC timelines across `lane`'s seed group."""
        tls = np.stack([self.opc_timeline(i, episode, samples)
                        for i in self.seed_group(lane)])
        return tls.mean(axis=0), tls.std(axis=0)


def prepare_group_batch(plan: GridPlan, group, group_cfg: NMPConfig,
                        device: torch.device, n_lanes: int | None = None,
                        host_cache=None, mesh=None):
    """Host-side build of one group's input batch and its copy to `device`.

    `n_lanes` forces the padded lane count (the serving layer's fixed
    slots); by default the group is padded to the smallest mesh-divisible
    lane count, and the folded seed axis to the smallest mesh-divisible
    seed width (`partition.padded_seed_count`; padding slots re-simulate
    seed slot 0 and are dropped).  `host_cache` reuses per-lane host arrays
    across calls (`plan.build_group_batch`).  Returns (device batch, padded
    lane count): on a mesh the batch is this rank's block (its executed
    seed width `batch["ep_seed"].shape[1]`), None past the mesh."""
    n_lanes_padded = (partition.padded_lane_count(group.n_lanes, mesh)
                      if n_lanes is None else n_lanes)
    if n_lanes_padded < group.n_lanes:
        raise ValueError(f"n_lanes={n_lanes_padded} < group lane count "
                         f"{group.n_lanes}")
    if n_lanes_padded != partition.padded_lane_count(n_lanes_padded, mesh):
        raise ValueError(f"n_lanes={n_lanes_padded} is not divisible by the "
                         "device mesh width")
    batch_np = plan_mod.build_group_batch(plan, group, group_cfg,
                                          host_cache=host_cache)
    batch_np = partition.pad_seed_axis(
        batch_np, partition.padded_seed_count(group.n_seeds, mesh))
    batch_np = partition.pad_group_batch(batch_np, n_lanes_padded)
    return (partition.shard_group_batch(batch_np, mesh, device),
            n_lanes_padded)


def executed_flags(group, n_seeds: int):
    """The BodyFlags a group runs with at an executed seed width of
    `n_seeds`: seed-invariant sharing only where that width exceeds 1."""
    share = n_seeds > 1 and plan_mod.seed_share_enabled()
    if group.flags.share_seed_inv == share:
        return group.flags
    return dataclasses.replace(group.flags, share_seed_inv=share)


# Distinct dispatch signatures seen in this process (groups dispatch from
# the calling thread only): the eager port's counterpart of the reference's
# jit cache of sweep programs.
_SIGNATURES: set = set()


def dispatch_sweep(batch, tom_cands, group_cfg: NMPConfig, spec, agent_cfg,
                   n_epochs: int, n_episodes: int, ring_len: int, flags,
                   warm_agent=None, want_agent: bool = False):
    """Run one prepared group batch: (outs, final env, final agent or None
    unless `want_agent`), left on the device (the caller fetches or
    synchronizes when it needs the values; on the card the launches are
    queued, so the caller can build the next batch meanwhile)."""
    dev = batch["dest"].device
    sig = (str(dev), group_cfg, spec, agent_cfg, n_epochs, n_episodes,
           ring_len, flags, warm_agent is not None, want_agent,
           tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(batch.items())))
    _SIGNATURES.add(sig)
    topo = topology_tensors(group_cfg, dev)
    out, env_fin, agent_fin = _run_sweep(
        batch, tom_cands, group_cfg, spec, agent_cfg, n_epochs, n_episodes,
        ring_len, flags, topo, warm_agent=warm_agent)
    return out, env_fin, (agent_fin if want_agent else None)


def compiled_sweep_programs() -> int:
    """Distinct sweep dispatch signatures seen in this process (group
    flags plus padded batch shapes): the serving layer's steady-state
    guarantee is that this stays constant across ticks once the slot
    programs are warm."""
    return len(_SIGNATURES)


def host_outs(out: dict, mesh=None) -> dict[str, np.ndarray]:
    """A group's per-cell outputs fetched to the host (on a mesh gathered
    from every rank: (L_padded, S_padded, ...)), the per-epoch timelines at
    the reference's slim dtypes (`valid_t`/`invoke_t` uint16) and the
    actions as int8."""
    out = partition.host_fetch(out, mesh)
    for k in ("valid_t", "invoke_t"):
        out[k] = out[k].astype(np.uint16)
    out["action_t"] = out["action_t"].astype(np.int8)
    return out


def lane_finite_mask(out: dict, agent_fin, n_lanes: int,
                     n_seeds: int = 1) -> np.ndarray:
    """Per-lane divergence guard: True where every float metric of the lane
    and every float param leaf of its final agent cells is finite.  `out`
    leaves are (L_padded, S, ...) (tensors or numpy), `agent_fin` a host
    snapshot (`export_agents`) whose params are flat (L_padded*S, ...).
    Only the first `n_lanes` lanes are reported."""
    lanes_padded = None
    floats = []
    for v in out.values():
        v = torch.as_tensor(v)
        if v.is_floating_point():
            floats.append(v)
            lanes_padded = v.shape[0]
    if agent_fin is not None:
        for leaf in agent_fin["params"].values():
            leaf = torch.as_tensor(leaf)
            if leaf.is_floating_point():
                floats.append(leaf)
                if lanes_padded is None:
                    lanes_padded = leaf.shape[0] // n_seeds
    if not floats:
        return np.ones(n_lanes, bool)
    ok = torch.ones((lanes_padded,), dtype=torch.bool,
                    device=floats[0].device)
    for v in floats:
        ok = ok & torch.isfinite(v.to(ok.device)).reshape(
            lanes_padded, -1).all(dim=1)
    return ok.cpu().numpy()[:n_lanes]


def run_grid(scenarios: Sequence[Scenario], cfg: NMPConfig = NMPConfig(),
             agent_cfg=None, store=None,
             device: str | torch.device = "cuda") -> SweepResult:
    """Run every scenario cell of a grid through the plan -> partition ->
    execute pipeline: one batched run per lane group, the folded seed axis
    as S cells per lane, on `device` alone or, in a process group, over a
    (lane, seed) mesh of its ranks (`partition`; every rank calls this with
    the same arguments and gets the whole result).  The mesh shape is
    REPRO_SWEEP_MESH's, else the auto-factored one for this plan.

    `store` is a `continual.PolicyStore` carrying agent lineages across
    calls: lanes whose `Scenario.lineage` tag it holds warm-start from the
    stored agent, fresh tags cold-start, and every tag's final agent is
    written back (the store is updated in place and returned as
    `SweepResult.store`; one is made when the grid declares tags and none is
    given).  Without lineage lanes the store is untouched.

    Returns a SweepResult whose per-cell cycles/ops/OPC match the serial
    `run_episode`/`run_program` protocol bit for bit (module docstring)."""
    scenarios = list(scenarios)
    t0 = time.time()
    dev = partition.rank_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 matmuls
    plan = plan_grid(scenarios, cfg)
    spec = state_spec_for(cfg)
    agent_cfg = agent_cfg or default_agent_cfg(cfg)
    devices = partition.sweep_devices(dev)
    shape = (partition.sweep_mesh_shape(len(devices))
             or partition.auto_mesh_shape(
                 len(devices), [(g.n_lanes, g.n_seeds, g.n_episodes)
                                for g in plan.groups]))
    mesh = partition.build_mesh(devices, shape, dev)
    tom_cands = partition.replicate(
        plan_mod.plan_tom_candidates(plan, cfg, dev), mesh)
    if store is None and plan.lineage_tags():
        from repro_torch.nmp.continual import PolicyStore
        store = PolicyStore()
    # Mixed-topology grids: the stacked final env needs one link-space
    # width, so per-group pending link loads are padded to the widest
    # topology's link count (padding links carry zero load).
    n_links_max = max(
        get_topology(dataclasses.replace(cfg, topology=t)).n_links
        for t in dict.fromkeys(plan.topologies))

    outs: list = [None] * len(scenarios)
    envs: list = [None] * len(scenarios)
    staging = AgentStaging()
    # The store is touched from two threads under async landing: warm
    # checkouts in launch() (main thread) and lineage write-backs in land()
    # (worker).  A tag never spans groups, so there is no semantic race;
    # the lock keeps the registry's dict and LRU bookkeeping atomic.
    store_lock = threading.Lock()

    def launch(group):
        """Host batch build + the group's batched run (of this rank's block
        on a mesh; nothing past it)."""
        group_cfg = dataclasses.replace(cfg, topology=group.topology)
        batch, n_lanes_padded = prepare_group_batch(plan, group, group_cfg,
                                                    dev, mesh=mesh)
        s_pad = partition.padded_seed_count(group.n_seeds, mesh)
        s_loc = s_pad // partition.mesh_seed_dim(mesh)   # this rank's slots
        if batch is None:
            return group, group_cfg, s_pad, s_loc, None, None, None
        if group.lineage:
            with store_lock:
                warm = _warm_agent_batch(group, n_lanes_padded, store,
                                         agent_cfg, dev, n_seeds=s_pad,
                                         staging=staging, mesh=mesh)
        else:
            warm = None
        out, env_fin, agent_fin = dispatch_sweep(
            batch, tom_cands, group_cfg, spec, agent_cfg, plan.n_epochs,
            group.n_episodes, plan.ring_len, executed_flags(group, s_loc),
            warm_agent=warm, want_agent=group.lineage)
        return group, group_cfg, s_pad, s_loc, out, env_fin, agent_fin

    def land(state):
        """Fetch one group's results to the host (on a mesh gathered from
        every rank) and unfold its lanes."""
        group, group_cfg, s_pad, s_loc, out, env_fin, agent_fin = state
        out = host_outs(out, mesh)
        env_fin = _map_state(
            lambda a: a.reshape((-1, s_pad) + a.shape[1:]),
            partition.host_fetch(env_fin, mesh, seeds=s_loc))
        pad_l = n_links_max - get_topology(group_cfg).n_links
        if pad_l:
            env_fin = dataclasses.replace(env_fin, pending_mig_loads=np.pad(
                env_fin.pending_mig_loads, [(0, 0)] * 2 + [(0, pad_l)]))
        pad_e = plan.n_episodes - group.n_episodes
        for li, lane in enumerate(group.lanes):
            cells = {}               # seed slot -> unfolded metric dict
            for i, si in zip(lane.indices, lane.slots):
                if si not in cells:
                    cells[si] = (
                        {k: np.pad(v[li, si], [(0, pad_e)] + [(0, 0)]
                                   * (v[li, si].ndim - 1))
                         for k, v in out.items()},
                        _map_state(lambda a, li=li, si=si:
                                  np.asarray(a[li, si]), env_fin))
                outs[i], envs[i] = cells[si]
        if group.lineage:
            # Hand every tag's final agent back to the store.  When several
            # cells share a tag (seed replicas, repeated tags), the lineage
            # continues from the first cell of the last lane declaring it.
            host = partition.host_fetch(
                None if agent_fin is None
                else agent_mod.export_agents(agent_fin), mesh,
                seeds=s_loc)
            with store_lock:
                for li, lane in enumerate(group.lanes):
                    cell = agent_mod.snapshot_cell(
                        host, li * s_pad + lane.slots[0])
                    store.put(lane.scenario.lineage, cell,
                              scenario=lane.scenario.name)

    # Heaviest group first; under async landing one worker fetches and
    # unfolds group k while group k+1 is dispatched.  One worker and
    # submission order keep landings (and store write-backs) in dispatch
    # order; lanes unfold into `outs`/`envs` by scenario index, so the
    # result is the same either way.
    pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="sweep-land")
            if land_mode() == "async" else None)
    try:
        landings = []
        for gi in plan_mod.packed_group_order(
                plan, partition.mesh_lane_dim(mesh),
                partition.mesh_seed_dim(mesh)):
            launched = launch(plan.groups[gi])
            if pool is not None:
                landings.append(pool.submit(land, launched))
            else:
                land(launched)
        for fut in landings:
            fut.result()             # join in order; exceptions propagate
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    metrics = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
    actions = metrics.pop("action_t")
    final_env = _map_state(lambda *xs: np.stack(xs), *envs)
    desc = partition.mesh_desc(mesh)
    return SweepResult(scenarios=scenarios, cfg=cfg, metrics=metrics,
                       final_env=final_env, n_episodes=plan.n_episodes,
                       wall_s=time.time() - t0, plan=plan,
                       n_devices=desc["n_devices"],
                       mesh_shape=tuple(desc["shape"]), store=store,
                       actions=actions)


def run_grid_serial(scenarios: Sequence[Scenario],
                    cfg: NMPConfig = NMPConfig(),
                    device: str | torch.device = "cuda") -> list[dict]:
    """Reference serial loop over the same grid (one run_episode/run_program
    per lane): the bar `run_grid` is held to."""
    from repro_torch.nmp.engine import run_episode, run_program
    from repro_torch.nmp.stats import summarize
    out = []
    for sc in scenarios:
        sc_cfg = (dataclasses.replace(cfg, topology=sc.topology)
                  if sc.topology is not None else cfg)
        if needs_agent(sc):
            results = run_program(sc.trace, sc_cfg, sc.technique, "aimm",
                                  episodes=sc.episodes, seed=sc.seed,
                                  page_table=sc.page_table, device=device)
            if sc.eval_episode:
                results.append(run_episode(
                    sc.trace, sc_cfg, sc.technique, "aimm",
                    agent=results[-1].agent, seed=sc.seed, explore=False,
                    page_table=sc.page_table, device=device))
            out.append(summarize(results[-1]))
        else:
            res = run_episode(sc.trace, sc_cfg, sc.technique, sc.mapper,
                              seed=sc.seed, page_table=sc.page_table,
                              forced_action=sc.forced_action, device=device)
            out.append(summarize(res))
    return out
