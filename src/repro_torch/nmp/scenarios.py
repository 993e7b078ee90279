"""Scenario registry: named grids of (trace, technique, mapper, seed) cells
(port of `repro.nmp.scenarios`, pure Python and numpy).

A `Scenario` is one lane of a batched sweep — everything `sweep.run_grid`
needs to simulate one (workload, technique, mapper) cell for some number of
chained episodes. Grid builders cover the paper's experiment families:

  single_program_grid : app x technique x mapper x seed (Figs. 6-10)
  multi_program_grid  : merged co-running apps, optional HOARD allocation
                        (Fig. 12 protocol)
  forced_action_grid  : scripted-policy ablations, one lane per AIMM action
                        (mechanism-ceiling studies)
  topology_grid       : app x interconnect x mapper — the topology axis
                        (`Scenario.topology` names a builder in
                        `nmp.topology.TOPOLOGIES`; the plan layer compiles
                        one program per topology group, so a mixed grid is
                        still a handful of batched sweeps)
  continual_stream    : an *ordered* sequence of program phases (app
                        switches, co-runner arrival/departure) — one grid
                        per phase, the learned-AIMM lane of every phase
                        tagged with a shared `lineage` so
                        `continual.run_stream` threads one DQN through the
                        whole stream via chained `run_grid` calls

  tenant_stream /
  tenant_fleet        : single-lane program-switch streams for serving
                        tenants — one scenario per phase, many tenants
                        sharing Trace objects; the workload unit of the
                        multi-tenant mapping service (`nmp.serving`)

`GRIDS` maps names to builders so benchmarks/examples can request a standard
grid by name (`build("single", apps=..., n_ops=...)`); `STREAMS` does the
same for phase streams (`build_stream("switch", ...)`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.actions import N_ACTIONS
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.paging import hoard_alloc
from repro_torch.nmp.traces import (Trace, make_trace, merge_traces,
                                    program_of_page)


@dataclasses.dataclass
class Scenario:
    """One lane of a sweep: a trace plus its technique/mapper/seed protocol."""
    name: str
    trace: Trace
    technique: str = "bnmp"
    mapper: str = "none"
    seed: int = 0
    episodes: int = 1
    eval_episode: bool = False       # append a greedy (explore=False) episode
    forced_action: int = -1          # >= 0: scripted policy, no DQN
    page_table: np.ndarray | None = None
    lineage: str | None = None       # PolicyStore tag: warm-start the lane's
                                     # DQN from the tag (cold-start the
                                     # lineage if absent) and write the final
                                     # agent back — None = plain cold start
    topology: str | None = None      # cube interconnect this lane simulates
                                     # (a name in nmp.topology.TOPOLOGIES);
                                     # None = inherit the sweep NMPConfig's
                                     # topology.  Lanes of different
                                     # topologies have different link spaces,
                                     # so the plan layer compiles one program
                                     # per topology group.

    @property
    def total_episodes(self) -> int:
        return self.episodes + (1 if self.eval_episode else 0)

    def fold_key(self) -> tuple:
        """Identity of this scenario modulo its seed (and seed-derived name).

        Scenarios sharing a fold key are replicas of one experiment cell at
        different seeds: the sweep plan layer folds them into a single lane
        with a vmapped seed axis (`nmp.plan.plan_grid`), so they share one
        copy of the trace arrays and report variance bands together.  Traces
        fold by object identity — the grid builders below reuse one Trace
        across the seeds of a cell, which is what makes folding effective."""
        pt = self.page_table.tobytes() if self.page_table is not None else None
        return (id(self.trace), self.technique, self.mapper, self.episodes,
                self.eval_episode, self.forced_action, pt, self.lineage,
                self.topology)


def seed_variants(sc: Scenario, seeds: Sequence[int]) -> list[Scenario]:
    """Grid-spec constructor: replicate one cell across `seeds` so the plan
    layer folds them into a single seed-vmapped lane (the scenarios share
    `sc`'s Trace object by construction)."""
    return [dataclasses.replace(sc, name=f"{sc.name}/s{seed}", seed=seed)
            for seed in seeds]


def single_program_grid(apps: Sequence[str] = ("KM", "RBM", "SPMV"),
                        techniques: Sequence[str] = ("bnmp",),
                        mappers: Sequence[str] = ("none", "tom", "aimm"),
                        n_ops: int = 4096, seeds: Sequence[int] = (0,),
                        episodes: int = 1, aimm_episodes: int | None = None,
                        eval_episode: bool = False) -> list[Scenario]:
    """The paper's core grid. AIMM cells may train longer (`aimm_episodes`)
    than the deterministic baselines, which need a single episode."""
    out = []
    for app in apps:
        tr = make_trace(app, n_ops=n_ops)
        for tech in techniques:
            for mapper in mappers:
                for seed in seeds:
                    eps = (aimm_episodes if (mapper == "aimm"
                                             and aimm_episodes is not None)
                           else episodes)
                    out.append(Scenario(
                        name=f"{app}/{tech}/{mapper}/s{seed}",
                        trace=tr, technique=tech, mapper=mapper, seed=seed,
                        episodes=eps,
                        eval_episode=eval_episode and mapper == "aimm"))
    return out


DEFAULT_COMBOS = (
    ("SC-KM", ("SC", "KM")),
    ("LUD-RBM-SPMV", ("LUD", "RBM", "SPMV")),
    ("SC-KM-RD-MAC", ("SC", "KM", "RD", "MAC")),
)


def multi_program_grid(combos: Iterable[tuple[str, Sequence[str]]] = DEFAULT_COMBOS,
                       n_ops_per_app: int = 4096,
                       cfg: NMPConfig = NMPConfig(),
                       technique: str = "bnmp",
                       episodes: int = 1, aimm_episodes: int | None = None,
                       seeds: Sequence[int] = (0,)) -> list[Scenario]:
    """Fig. 12 protocol per combo: shared BNMP baseline, BNMP+HOARD, and
    BNMP+HOARD+AIMM lanes."""
    out = []
    for name, combo in combos:
        tr = merge_traces([make_trace(a, n_ops=n_ops_per_app) for a in combo])
        hoard = hoard_alloc(tr.n_pages, cfg, program_of_page(tr))
        for seed in seeds:
            out.append(Scenario(name=f"{name}/shared/s{seed}", trace=tr,
                                technique=technique, seed=seed,
                                episodes=episodes))
            out.append(Scenario(name=f"{name}/hoard/s{seed}", trace=tr,
                                technique=technique, seed=seed,
                                episodes=episodes, page_table=hoard))
            out.append(Scenario(name=f"{name}/hoard+aimm/s{seed}", trace=tr,
                                technique=technique, mapper="aimm", seed=seed,
                                episodes=aimm_episodes or episodes,
                                page_table=hoard))
    return out


def forced_action_grid(app: str = "SPMV", n_ops: int = 2048,
                       technique: str = "bnmp",
                       actions: Sequence[int] = tuple(range(N_ACTIONS)),
                       seeds: Sequence[int] = (0,)) -> list[Scenario]:
    """Scripted-policy ablation: one AIMM lane per forced action."""
    tr = make_trace(app, n_ops=n_ops)
    return [Scenario(name=f"{app}/{technique}/forced{a}/s{seed}", trace=tr,
                     technique=technique, mapper="aimm", seed=seed,
                     forced_action=a)
            for a in actions for seed in seeds]


def topology_grid(apps: Sequence[str] = ("KM",),
                  topologies: Sequence[str] | None = None,
                  techniques: Sequence[str] = ("bnmp",),
                  mappers: Sequence[str] = ("none", "aimm"),
                  n_ops: int = 2048, seeds: Sequence[int] = (0,),
                  episodes: int = 1, aimm_episodes: int | None = None,
                  eval_episode: bool = False) -> list[Scenario]:
    """The topology axis: app x interconnect x technique x mapper x seed.

    One lane per cell, each tagged with its `Scenario.topology`; the plan
    layer groups lanes by topology (different interconnects have different
    link spaces) and compiles one program per group, so the whole axis is
    still a handful of batched sweeps.  The default mapper pair
    ("none", "aimm") is the paper's central question per interconnect:
    does the learned mapping beat the unmanaged baseline?"""
    from repro_torch.nmp.topology import TOPOLOGIES, validate_topology
    topologies = tuple(TOPOLOGIES) if topologies is None else tuple(topologies)
    for t in topologies:
        validate_topology(t)
    out = []
    for app in apps:
        tr = make_trace(app, n_ops=n_ops)
        for topo in topologies:
            for tech in techniques:
                for mapper in mappers:
                    for seed in seeds:
                        eps = (aimm_episodes
                               if (mapper == "aimm"
                                   and aimm_episodes is not None)
                               else episodes)
                        out.append(Scenario(
                            name=f"{app}/{topo}/{tech}/{mapper}/s{seed}",
                            trace=tr, technique=tech, mapper=mapper,
                            seed=seed, episodes=eps, topology=topo,
                            eval_episode=eval_episode and mapper == "aimm"))
    return out


# Default program-switch stream (phase name, live app set): a single program,
# a co-runner arriving, the original program departing.  The lineage-tagged
# AIMM lane lives through all three phases.
DEFAULT_STREAM = (
    ("KM", ("KM",)),
    ("KM+SC", ("KM", "SC")),
    ("SC", ("SC",)),
)


def continual_stream(phases: Iterable[tuple[str, Sequence[str]]] = DEFAULT_STREAM,
                     n_ops_per_app: int = 2048,
                     technique: str = "bnmp",
                     episodes: int = 2,
                     lineage: str | None = "stream",
                     seed: int = 0,
                     include_baseline: bool = True,
                     interleave: int = 32) -> list[list[Scenario]]:
    """Ordered program-phase stream for continual learning (the paper's
    "continuously evaluates and learns ... for any application" claim).

    Each phase is one grid: the live app set of that phase — merged
    round-robin from *per-app traces* when programs co-run, so arrival/
    departure re-uses the same per-app access patterns rather than one
    pre-merged blob — with a learned-AIMM lane tagged `lineage` (plus an
    unmanaged baseline lane when `include_baseline`).  Execute the phases in
    order with `continual.run_stream` (chained `sweep.run_grid` calls
    threading one PolicyStore) and the DQN lives through every app switch;
    with `lineage=None` every phase cold-starts instead (the ablation
    baseline)."""
    app_traces: dict[str, object] = {}
    for _, apps in phases:
        for app in apps:
            if app not in app_traces:
                app_traces[app] = make_trace(app, n_ops=n_ops_per_app)
    stream = []
    for pi, (name, apps) in enumerate(phases):
        tr = (app_traces[apps[0]] if len(apps) == 1 else
              merge_traces([app_traces[a] for a in apps],
                           interleave=interleave))
        grid = []
        if include_baseline:
            grid.append(Scenario(name=f"p{pi}:{name}/base", trace=tr,
                                 technique=technique, seed=seed))
        grid.append(Scenario(name=f"p{pi}:{name}/aimm", trace=tr,
                             technique=technique, mapper="aimm", seed=seed,
                             episodes=episodes, lineage=lineage))
        stream.append(grid)
    return stream


def tenant_stream(apps: Sequence[str] = ("KM", "SC"),
                  n_phases: int | None = None,
                  n_ops_per_app: int = 512,
                  technique: str = "bnmp",
                  episodes: int = 1,
                  lineage: str | None = None,
                  seed: int = 0,
                  traces: dict | None = None) -> list[list[Scenario]]:
    """Single-lane program-switch stream for one serving tenant.

    Each phase is one learned-AIMM scenario over the next app in the cycle
    (`apps` repeated up to `n_phases`) — the unit of work a
    `serving.MappingServer` slot executes per service tick.  `lineage` tags
    the lane so `continual.run_stream` can also execute the stream solo (the
    serving layer re-tags with the tenant id itself); pass a shared `traces`
    dict so a whole tenant fleet reuses one Trace per (app, n_ops)."""
    n_phases = len(apps) if n_phases is None else n_phases
    traces = traces if traces is not None else {}
    stream = []
    for pi in range(n_phases):
        app = apps[pi % len(apps)]
        key = (app, n_ops_per_app)
        if key not in traces:
            traces[key] = make_trace(app, n_ops=n_ops_per_app)
        stream.append([Scenario(
            name=f"p{pi}:{app}/aimm", trace=traces[key],
            technique=technique, mapper="aimm", seed=seed,
            episodes=episodes, lineage=lineage)])
    return stream


def tenant_fleet(n_tenants: int = 8,
                 apps: Sequence[str] = ("KM", "SC", "PR", "SPMV"),
                 n_phases: int = 2,
                 n_ops_per_app: int = 512,
                 technique: str = "bnmp",
                 episodes: int = 1,
                 seed0: int = 0) -> dict[str, list[list[Scenario]]]:
    """A heterogeneous fleet of single-lane tenant streams for the serving
    layer: tenant `t<i>` cycles through `apps` starting at offset i with
    seed `seed0 + i`, and all tenants share one Trace object per
    (app, n_ops) — the many-concurrent-tenants workload of the
    multi-tenant mapping service (see nmp.serving / bench_serving)."""
    traces: dict = {}
    return {
        f"t{i:03d}": tenant_stream(
            apps=tuple(apps[(i + k) % len(apps)] for k in range(len(apps))),
            n_phases=n_phases, n_ops_per_app=n_ops_per_app,
            technique=technique, episodes=episodes, seed=seed0 + i,
            traces=traces)
        for i in range(n_tenants)}


GRIDS: dict[str, Callable[..., list[Scenario]]] = {
    "single": single_program_grid,
    "multi": multi_program_grid,
    "ablation": forced_action_grid,
    "topology": topology_grid,
}

STREAMS: dict[str, Callable[..., list[list[Scenario]]]] = {
    "switch": continual_stream,
    "tenant": tenant_stream,
}


def build(name: str, **kw) -> list[Scenario]:
    """Build a named grid (see GRIDS) with builder-specific overrides."""
    return GRIDS[name](**kw)


def build_stream(name: str, **kw) -> list[list[Scenario]]:
    """Build a named phase stream (see STREAMS) — one grid per phase, to be
    executed in order by `continual.run_stream`."""
    return STREAMS[name](**kw)
