"""Trace-driven, epoch-based NMP timing engine (port of `repro.nmp.engine`).

One AIMM episode is a Python loop over epochs; each epoch runs

  window   : the next `epoch_ops` ops of the trace (sliced on the device)
  shared + route stages : one launch of the fused epoch kernel
             (kernels/epoch_fused): row-buffer stamps, PEI threshold, access
             EMA, page touch counts, technique + compute-remap scheduling,
             per-link flit loads, hop and per-cube counts, and for TOM
             programs the TOM candidates' scores in the same launch
  time     : cycles = mc_inject + max(compute, link, dram serialization)
             + mean latency + NMP-table overflow stalls + migration stalls
  feedback : OPC = ops/cycles; reward = sign(dOPC); state vector
  agent    : replay push, one TD step with Adam, epsilon-greedy act (the
             dueling Q network's inference runs in the fused qnet kernel)
  apply    : the action's page migration / compute remap / interval change

How it maps the reference:

  * `jax.vmap` over lanes is a written-out leading axis in every state
    tensor, epoch function and kernel; `run_episode` uses one lane.  The
    sweep's (lane, seed) grid (the reference's `seed_axis` form) is kept
    flat: env, agent and metrics over L·S cells (lane-major), the trace
    arrays and `TraceCtx` per lane (L).  The window is fetched once per lane
    and repeated over its S cells.  With `BodyFlags.share_seed_inv` (S > 1)
    the seed-invariant shared stage (row-buffer stamps, PEI threshold,
    access EMA, touch counts, TOM scores: the reference's `SharedEpoch`)
    runs once per lane from the seed-0 cells, B = L, and the route stage
    once per cell, B = L·S, from the lane's winners and hot flags; without
    it (or with S = 1) both stages run in one fused launch per cell.
  * `lax.scan` over epochs is the Python loop `scan_epochs`, shared by
    `run_episode` and the sweep (nmp/sweep.py).
  * The reference gates the agent invocation and TOM's profiling-phase
    scoring behind `lax.cond`; it pins cond equal to the compute-then-mask
    form (`agent_gate="masked"`, `tom_gate="masked"`).  The port computes
    then masks, so the epoch loop never reads a value back to the host.
  * The reference's threefry keys are carried as they are (core/prng.py):
    the env's `rng` is `PRNGKey(seed)`, split in three every epoch of an
    AIMM program (the NEAR actions' neighbour draw), the agent's `rng`
    split at every invocation (core/agent.py), so every random draw is the
    reference's, bit for bit.  On the card each draw is one launch of the
    threefry kernel.
  * JAX index semantics are reproduced on purpose: the `recent_pages`
    scatter wraps its empty slots (-1) to page P-1 and writes the ring's
    slots in order (last write wins); argmax/argmin take the first index on
    ties (bool masks are cast first, as CUDA's argmax refuses bool); the
    window slice asserts it stays inside the padded trace instead of
    clamping its start as `lax.dynamic_slice` does.
  * XLA rewrites a division by a constant into a multiply by its float32
    reciprocal; the port does the same where the reference divides by a
    non-power-of-two constant (`_recip`).  XLA's CPU backend also contracts
    some a*b+c into FMAs and eager torch does not.  The one contraction on
    the cycles path (the link congestion factor) is mirrored (`_fma`), so
    cycles and OPC match the reference's CPU run bit for bit; others (the
    0.7-EMAs and the DRAM latency mix of the state vector) can differ in the
    last bits.  Every integer-valued result is exact.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import actions as act_mod
from repro_torch.core import agent as agent_mod
from repro_torch.core import prng
from repro_torch.core.actions import (DEFAULT, FAR_COMPUTE, FAR_DATA,
                                      N_ACTIONS, NEAR_COMPUTE, NEAR_DATA,
                                      SOURCE_COMPUTE)
from repro_torch.core.agent import AgentConfig, AgentState
from repro_torch.core.dqn import DQNConfig
from repro_torch.core.reward import compute_reward
from repro_torch.core.state import StateSpec, build_state
from repro_torch.kernels.epoch_fused import ops as epoch_ops
from repro_torch.nmp import baselines
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.migration import migration_cost
from repro_torch.nmp.paging import (PageInfoCache, default_alloc,
                                    init_page_cache, lane_rows,
                                    lookup_or_insert, push_hist,
                                    set_lane_rows)
from repro_torch.nmp.topology import TopoTensors, topology_tensors
from repro_torch.nmp.traces import Trace

MAPPERS = ("none", "tom", "aimm")
MAPPER_ID = {m: i for i, m in enumerate(MAPPERS)}
TECH_ID = {t: i for i, t in enumerate(baselines.TECHNIQUES)}

# Energy counter layout (see stats.py).
EN_PAGE_CACHE, EN_NMP_BUF, EN_MIG_Q, EN_MDMA, EN_WEIGHT, EN_REPLAY, \
    EN_STATE_BUF, EN_NET_BIT_HOPS, EN_MEM_BITS, EN_N = range(10)

# TOM control period: K profiling windows (one per candidate) + this many
# commit windows running the winner.
TOM_COMMIT_WINDOWS = 8


def _recip(x: float) -> float:
    """float32 reciprocal of a constant (see module doc)."""
    return float(np.float32(1.0) / np.float32(x))


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 a*b + c rounded once, as XLA's CPU backend compiles the
    reference's `1 + (alpha - 1) * clip(...)` (a fused multiply-add).  The
    product of two float32 values is exact in float64, so the sum is rounded
    once to float64 and then to float32; that double rounding can differ from
    a true FMA only when the float64 sum lands exactly on a float32 tie."""
    b32 = float(np.float32(b))
    return (a.to(torch.float64) * b32 + c).to(torch.float32)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) mask reshaped to broadcast against a (B, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _where(mask: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    return torch.where(_bcast(mask, new), new, old)


def _map_state(fn, *states):
    """Apply fn leafwise over dataclasses of tensors or arrays (nested
    dataclasses included); returns a dataclass of the first argument's
    type."""
    first = states[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in states]
        out[f.name] = (_map_state(fn, *vals)
                       if dataclasses.is_dataclass(vals[0]) else fn(*vals))
    return type(first)(**out)


@dataclasses.dataclass(frozen=True)
class TraceCtx:
    """Per-lane runtime context, (B,) tensors."""
    n_ops: torch.Tensor          # i32 real op count
    n_pages: torch.Tensor        # i32 real page count
    t_ring: torch.Tensor         # i32 effective OPC phase-ring length
    pei_idx: torch.Tensor        # i32 hot-threshold index into the ascending
                                 #     sort of the real pages' access EMAs
    technique: torch.Tensor      # i32 index into baselines.TECHNIQUES
    mapper: torch.Tensor         # i32 index into MAPPERS
    forced_action: torch.Tensor  # i32 scripted action, -1 = learned policy
    explore: torch.Tensor        # bool epsilon-greedy exploration on/off


@dataclasses.dataclass(frozen=True)
class BodyFlags:
    """Static feature flags of one epoch body: a feature no lane uses is
    skipped, not masked (the reference's BodyFlags without the backend
    knob: the tensors' device picks kernel or plain version)."""
    has_agent: bool = False     # a live DQN (aimm lanes with a learned policy)
    any_aimm: bool = False      # hot-page selection / action application
    any_tom: bool = False       # TOM candidate scoring + commit
    pei_k: int = 0              # top_k width for the PEI threshold (0 = none)
    share_seed_inv: bool = False  # hoist the shared stage out of the seeds


def pei_hot_index(n_pages: int, cfg: NMPConfig) -> int:
    """Sort index of the PEI hot-page threshold among the real pages."""
    return (int(n_pages * (1 - cfg.pei_hot_frac)) - 1) % n_pages


def pei_top_k(n_pages: int, cfg: NMPConfig) -> int:
    """top_k width needed to read the PEI threshold as the m-th largest EMA."""
    return n_pages - pei_hot_index(n_pages, cfg)


def episode_flags(trace: Trace, cfg: NMPConfig, technique: str, mapper: str,
                  forced_action: int = -1) -> BodyFlags:
    """Static body flags for one serial episode."""
    return BodyFlags(
        has_agent=mapper == "aimm" and forced_action < 0,
        any_aimm=mapper == "aimm",
        any_tom=mapper == "tom",
        pei_k=pei_top_k(trace.n_pages, cfg) if technique == "pei" else 0,
    )


def serial_epochs(n_ops: int, cfg: NMPConfig) -> int:
    """Number of epochs needed to consume `n_ops`."""
    return int(np.ceil(n_ops / cfg.epoch_ops))


def phase_ring_len(trace: Trace, cfg: NMPConfig) -> int:
    """Length of the same-phase OPC reference ring for one trace."""
    iter_ops = trace.iter_ops or trace.n_ops
    n_epochs = serial_epochs(trace.n_ops, cfg)
    return int(np.clip(iter_ops // cfg.epoch_ops, 1, n_epochs + 1))


def make_ctx(trace: Trace, cfg: NMPConfig, technique: str, mapper: str,
             forced_action: int, explore: bool,
             device: torch.device) -> TraceCtx:
    """One lane's context (B = 1)."""
    assert mapper in MAPPERS and technique in baselines.TECHNIQUES
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=device)
    return TraceCtx(
        n_ops=i32(trace.n_ops), n_pages=i32(trace.n_pages),
        t_ring=i32(phase_ring_len(trace, cfg)),
        pei_idx=i32(pei_hot_index(trace.n_pages, cfg)),
        technique=i32(TECH_ID[technique]), mapper=i32(MAPPER_ID[mapper]),
        forced_action=i32(forced_action),
        explore=torch.tensor([explore], dtype=torch.bool, device=device))


@dataclasses.dataclass
class EnvState:
    """Per-lane simulation state; every tensor has a leading lane axis B."""
    page_to_cube: torch.Tensor      # (B, P) i32 data mapping
    compute_remap: torch.Tensor     # (B, P) i32, -1 = none
    op_ptr: torch.Tensor            # (B,) i32
    interval_level: torch.Tensor    # (B,) i32
    since_invoke: torch.Tensor      # (B,) i32 epochs since last invocation
    span_sum: torch.Tensor          # (B,) f32 OPC sum of current tenure
    span_n: torch.Tensor            # (B,) f32
    prev_span_mean: torch.Tensor    # (B,) f32 (-1 = none yet)
    opc_ring: torch.Tensor          # (B, T) f32 per-phase OPC one iteration ago
    ref_sum: torch.Tensor           # (B,) f32 same-phase reference sum
    ref_n: torch.Tensor             # (B,) f32
    page_access_ema: torch.Tensor   # (B, P) f32
    rb_stamp: torch.Tensor          # (B, P+1) i32 row-buffer stamps (row P:
                                    #   the invalid-access sink)
    nmp_occ: torch.Tensor           # (B, C) f32
    rb_hit: torch.Tensor            # (B, C) f32
    mc_queue: torch.Tensor          # (B, M) f32
    global_act_hist: torch.Tensor   # (B, Hg) i32
    cache: PageInfoCache
    pending_mig_loads: torch.Tensor  # (B, L) f32
    pending_mig_stall: torch.Tensor  # (B,) f32
    prev_state_vec: torch.Tensor    # (B, S) f32
    prev_action: torch.Tensor       # (B,) i32
    recent_pages: torch.Tensor      # (B, R) i32 pages acted on (-1 empty)
    remap_age: torch.Tensor         # (B, P) i32 epochs since remap set
    rng: torch.Tensor               # (B, 2) int64 threefry key
    tom_scores: torch.Tensor        # (B, K) f32
    tom_active: torch.Tensor        # (B,) i32 candidate in use (-1 = default)
    cycles: torch.Tensor            # (B,) f32 cumulative stats from here on
    ops_done: torch.Tensor
    hops_sum: torch.Tensor
    util_sum: torch.Tensor
    epochs: torch.Tensor
    mig_count: torch.Tensor
    mig_page_mask: torch.Tensor     # (B, P) f32
    access_total: torch.Tensor
    access_on_migrated: torch.Tensor
    energy: torch.Tensor            # (B, EN_N) f32 counters

    def lane(self, b: int) -> "EnvState":
        """Lane b without the lane axis."""
        return _map_state(lambda t: t[b], self)


class EpisodeResult(NamedTuple):
    env: EnvState
    agent: AgentState | None
    metrics: dict[str, torch.Tensor]   # per-epoch, stacked


def _init_env(page_table: torch.Tensor, cfg: NMPConfig, spec: StateSpec,
              topo: TopoTensors, t_ring: int, seed) -> EnvState:
    """Fresh env state for page_table's B lanes (B, P) i32; `seed` (an int,
    or (B,) ints) keys each lane's stream, `PRNGKey(seed)`."""
    dev = page_table.device
    B, P = page_table.shape
    C, M, L = cfg.n_cubes, cfg.n_mcs, topo.n_links
    f = lambda *s, v=0.0: torch.full((B,) + s, v, dtype=torch.float32,
                                     device=dev)
    i = lambda *s, v=0: torch.full((B,) + s, v, dtype=torch.int32,
                                   device=dev)
    return EnvState(
        page_to_cube=page_table.to(torch.int32), compute_remap=i(P, v=-1),
        op_ptr=i(), interval_level=i(), since_invoke=i(),
        span_sum=f(), span_n=f(), prev_span_mean=f(v=-1.0),
        opc_ring=f(t_ring), ref_sum=f(), ref_n=f(), page_access_ema=f(P),
        rb_stamp=i(P + 1), nmp_occ=f(C), rb_hit=f(C, v=0.5), mc_queue=f(M),
        global_act_hist=i(spec.global_act_hist),
        cache=init_page_cache(cfg, B, dev, spec.hop_hist, spec.lat_hist,
                              spec.mig_hist, spec.act_hist),
        pending_mig_loads=f(L), pending_mig_stall=f(),
        prev_state_vec=f(spec.dim), prev_action=i(),
        recent_pages=i(max(cfg.recent_ring, 1), v=-1), remap_age=i(P),
        rng=prng.PRNGKey(torch.as_tensor(seed, device=dev).expand(B)),
        tom_scores=f(6), tom_active=i(v=-1), cycles=f(), ops_done=f(),
        hops_sum=f(), util_sum=f(), epochs=f(), mig_count=f(),
        mig_page_mask=f(P), access_total=f(), access_on_migrated=f(),
        energy=f(EN_N))


class Window(NamedTuple):
    dest: torch.Tensor     # (B, W) i32
    src1: torch.Tensor
    src2: torch.Tensor
    valid: torch.Tensor    # (B, W) f32


@dataclasses.dataclass
class EpochMid:
    """Intermediate results handed from `_epoch_sim` to `_epoch_apply` (and
    to the agent invocation in between)."""
    win: Window
    w_valid: torch.Tensor
    has_ops: torch.Tensor
    invoke: torch.Tensor
    cycles: torch.Tensor
    opc: torch.Tensor
    span_sum: torch.Tensor
    span_n: torch.Tensor
    cur_mean: torch.Tensor
    ref_sum: torch.Tensor
    ref_n: torch.Tensor
    opc_ring: torch.Tensor
    reward: torch.Tensor
    hops_total: torch.Tensor
    mean_hops: torch.Tensor
    util: torch.Tensor
    nmp_occ: torch.Tensor
    rb_hit: torch.Tensor
    mc_queue: torch.Tensor
    page_ema: torch.Tensor
    rb_stamp: torch.Tensor
    cache: PageInfoCache
    ent: torch.Tensor
    hot_page: torch.Tensor
    touches_hot: torch.Tensor
    ccube_hot: torch.Tensor
    svec: torch.Tensor
    k_nbr: torch.Tensor        # (B, 2) key of the NEAR actions' draw
    env_rng: torch.Tensor      # (B, 2) the env's next key
    tom_scores: torch.Tensor
    tom_active: torch.Tensor
    mig_stall_tom: torch.Tensor
    migrated_tom: torch.Tensor
    energy: torch.Tensor       # action-independent counters already added


# ---------------------------------------------------------------------------
# One epoch: cost model (action-independent half)
# ---------------------------------------------------------------------------

def _fetch_window(op_ptr: torch.Tensor, trace: dict, ctx: TraceCtx,
                  cfg: NMPConfig) -> Window:
    """This epoch's op window sliced at each lane's `op_ptr` (L,) from the
    trace arrays padded by `w_max` (the caller asserts the slice stays in
    range), and its validity mask."""
    W = cfg.w_max
    idx = torch.arange(W, device=op_ptr.device)
    pos = op_ptr[:, None] + idx                                  # (L, W)
    take = lambda a: a.gather(1, pos.long())
    valid = ((idx < cfg.epoch_ops)[None, :]
             & (pos < ctx.n_ops[:, None])).to(torch.float32)
    return Window(take(trace["dest"]), take(trace["src1"]),
                  take(trace["src2"]), valid)


def _epoch_sim(env: EnvState, win: Window, tom_cands: torch.Tensor,
               ctx: TraceCtx, cfg: NMPConfig, spec: StateSpec,
               agent_cfg: AgentConfig, flags: BodyFlags,
               topo: TopoTensors,
               shared: epoch_ops.SharedParts | None = None) -> EpochMid:
    """Everything up to (but excluding) the agent's action: scheduling,
    routing, timing, reward bookkeeping, hot-page selection and the state
    vector, for every cell (`ctx` per cell).  `shared` carries the shared
    stage computed once per lane and repeated over its cells (the
    reference's hoisted SharedEpoch); None fuses both stages into one
    launch."""
    B, P = env.page_to_cube.shape
    C = cfg.n_cubes
    dev = env.page_to_cube.device
    rows = torch.arange(B, device=dev)
    is_tom = ctx.mapper == MAPPER_ID["tom"]
    is_aimm = ctx.mapper == MAPPER_ID["aimm"]
    dest, src1, src2, valid = win
    w_valid = valid.sum(dim=1)
    has_ops = w_valid > 0

    # ---- data mapping (TOM may override the page table) ----
    if flags.any_tom:
        use_tom = is_tom & (env.tom_active >= 0)
        eff_table = _where(use_tom,
                           tom_cands[torch.clamp(env.tom_active, min=0).long()],
                           env.page_to_cube)
    else:
        eff_table = env.page_to_cube

    # ---- shared + route stages, and the TOM candidates' scores on this
    # window (SharedEpoch.tom_scores): ONE launch of the fused epoch kernel,
    # or the route stage alone after a hoisted shared stage
    rt = dict(pei_k=flags.pei_k, aimm=flags.any_aimm, n_mcs=cfg.n_mcs,
              packet_flits=cfg.packet_flits)
    if shared is None:
        sparts, rparts = epoch_ops.fused_parts(
            dest, src1, src2, valid, env.epochs, env.rb_stamp,
            env.page_access_ema, ctx.n_pages, ctx.pei_idx, eff_table,
            env.compute_remap, ctx.technique, is_aimm,
            env.pending_mig_loads, topo,
            tom_cands=tom_cands if flags.any_tom else None, **rt)
    else:
        sparts = shared
        rparts = epoch_ops.route_parts(
            dest, src1, src2, valid, shared.rb_winner, shared.pei_hot1,
            shared.pei_hot2, eff_table, env.compute_remap, ctx.technique,
            is_aimm, env.pending_mig_loads, topo, **rt)
    page_ema = (sparts.page_ema if sparts.page_ema is not None
                else env.page_access_ema)
    ccube, loads, hops_op = rparts.ccube, rparts.loads, rparts.hops_op
    ops_c, acc_c, distinct_c, mcq = (rparts.ops_c, rparts.acc_c,
                                     rparts.distinct_c, rparts.mcq)
    hops_total = (hops_op * valid).sum(dim=1)
    mean_hops = hops_total / torch.clamp(w_valid, min=1.0)

    # ---- per-cube compute load & NMP-table occupancy ----
    table_excess = torch.clamp(ops_c - cfg.nmp_table_size, min=0.0).sum(dim=1)
    ops_max = ops_c.max(dim=1).values
    compute_serial = ops_max * cfg.t_op / cfg.cube_issue_rate
    eff_cubes = (torch.square(ops_c.sum(dim=1))
                 / torch.clamp(torch.square(ops_c).sum(dim=1), min=1.0))
    util = eff_cubes / C

    # ---- row-buffer model: distinct pages accessed per cube ----
    hit_c = torch.where(acc_c > 0,
                        1.0 - distinct_c / torch.clamp(acc_c, min=1.0),
                        torch.full_like(acc_c, 0.5))
    lat_c = hit_c * cfg.t_dram_hit + (1 - hit_c) * cfg.t_dram_miss
    acc_lat = acc_c * lat_c
    dram_serial = acc_lat.max(dim=1).values / (cfg.n_vaults * 4.0)

    # ---- epoch cycles & OPC ----
    mc_inject = w_valid / (cfg.n_mcs * cfg.mc_issue_rate)
    load_max = loads.max(dim=1).values
    mean_load = loads.sum(dim=1) * _recip(loads.shape[1])
    imbalance = load_max / torch.clamp(mean_load, min=1.0)
    link_serial = load_max * _fma(
        torch.clamp((imbalance - 1.0) / 4.0, 0.0, 1.0),
        cfg.congestion_alpha - 1.0, 1.0)
    mean_lat = (mean_hops * cfg.t_router + cfg.packet_flits
                + acc_lat.sum(dim=1)
                / torch.clamp(acc_c.sum(dim=1), min=1.0))
    stride = env.interval_level + 1
    invoke = (env.since_invoke + 1 >= stride) & has_ops
    zero = torch.zeros_like(w_valid)
    agent_overhead = torch.where(is_aimm & invoke,
                                 torch.full_like(zero, cfg.t_agent), zero)
    cycles = (agent_overhead + mc_inject
              + torch.maximum(torch.maximum(compute_serial, link_serial),
                              dram_serial)
              + mean_lat + table_excess * cfg.t_op + env.pending_mig_stall)
    cycles = torch.where(has_ops, cycles, zero)
    opc = torch.where(has_ops, w_valid / torch.clamp(cycles, min=1.0), zero)
    # reward for the previous action: tenure-mean OPC against the same trace
    # phase one kernel iteration ago, else the previous tenure's mean
    span_sum = env.span_sum + opc
    span_n = env.span_n + has_ops.to(torch.float32)
    cur_mean = span_sum / torch.clamp(span_n, min=1.0)
    slot = (env.epochs.to(torch.int32) % ctx.t_ring).long()
    ring_ready = (env.epochs >= ctx.t_ring) & has_ops
    ref_sum = env.ref_sum + torch.where(ring_ready, env.opc_ring[rows, slot],
                                        zero)
    ref_n = env.ref_n + ring_ready.to(torch.float32)
    ref_mean = ref_sum / torch.clamp(ref_n, min=1.0)
    use_ring = ref_n >= span_n - 0.5
    r_ring = compute_reward(cur_mean, ref_mean, deadband=0.01)
    r_prev = torch.where(env.prev_span_mean >= 0.0,
                         compute_reward(cur_mean, env.prev_span_mean,
                                        deadband=0.01), zero)
    reward = torch.where(invoke, torch.where(use_ring & (ref_n > 0), r_ring,
                                             r_prev), zero)
    ring_set = env.opc_ring.clone()
    ring_set[rows, slot] = opc
    opc_ring = _where(has_ops, ring_set, env.opc_ring)

    # ---- EMAs / system info ----
    d = 0.7
    nmp_occ = d * env.nmp_occ + (1 - d) * ops_c
    rb_hit = d * env.rb_hit + (1 - d) * hit_c
    mc_queue = d * env.mc_queue + (1 - d) * mcq

    # ---- hot page + page-info cache update (AIMM lanes only) ----
    if flags.any_aimm:
        touch_cnt = sparts.touch_cnt
        # pages acted on recently: the ring's empty slots (-1) wrap to page
        # P-1 and the slots are written in order, as JAX's scatter does
        recently = torch.zeros((B, P), dtype=torch.float32, device=dev)
        for r in range(env.recent_pages.shape[1]):
            pg = env.recent_pages[:, r]
            recently[rows, torch.where(pg < 0, pg + P, pg).long()] = (
                pg >= 0).to(torch.float32)
        hot_page = torch.argmax(touch_cnt * (1.0 - recently),
                                dim=1).to(torch.int32)
        touches_hot = lane_rows(touch_cnt, hot_page)
        hp = hot_page[:, None]
        is_hot_op = ((dest == hp) | (src1 == hp) | (src2 == hp)) & (valid > 0)
        first_hot = torch.argmax(is_hot_op.to(torch.int32), dim=1)
        ccube_hot = lane_rows(ccube, first_hot)
        hops_hot = lane_rows(hops_op, first_hot)

        cache, ent = lookup_or_insert(env.cache, hot_page)
        cache = cache.replace(
            freq=set_lane_rows(cache.freq, ent, lane_rows(cache.freq, ent) + 1.0),
            accesses=set_lane_rows(cache.accesses, ent,
                               lane_rows(cache.accesses, ent) + touches_hot),
            hop_hist=push_hist(cache.hop_hist, ent, hops_hot),
            lat_hist=push_hist(cache.lat_hist, ent, mean_lat),
        )
        page_rate = touches_hot / torch.clamp(3.0 * w_valid, min=1.0)
        mig_per_acc = (lane_rows(cache.migrations, ent)
                       / torch.clamp(lane_rows(cache.accesses, ent), min=1.0))
        svec = build_state(
            spec, nmp_occ, rb_hit, mc_queue, env.global_act_hist,
            env.interval_level, page_rate, mig_per_acc,
            lane_rows(cache.hop_hist, ent), lane_rows(cache.lat_hist, ent),
            lane_rows(cache.mig_hist, ent), lane_rows(cache.act_hist, ent),
            lane_rows(eff_table, hot_page), ccube_hot,
            occ_norm=float(cfg.nmp_table_size))
        keys = prng.split(env.rng, 3)              # env, (agent), neighbour
        env_rng, k_nbr = keys[:, 0], keys[:, 2]
    else:
        cache = env.cache
        ent = hot_page = ccube_hot = torch.zeros((B,), dtype=torch.int32,
                                                 device=dev)
        touches_hot = zero
        svec = torch.zeros((B, spec.dim), dtype=torch.float32, device=dev)
        env_rng = k_nbr = env.rng

    # ---- TOM control (profiling + commit are action-independent) ----
    if flags.any_tom:
        K = tom_cands.shape[0]
        period = K + TOM_COMMIT_WINDOWS
        phase = env.epochs.to(torch.int32) % period
        page_live = (torch.arange(P, device=dev)[None, :]
                     < ctx.n_pages[:, None]).to(torch.float32)
        pc = torch.clamp(phase, 0, K - 1).long()
        scored = env.tom_scores.clone()
        scored[rows, pc] = sparts.tom_scores[rows, pc]
        tom_scores = _where(is_tom & (phase < K), scored, env.tom_scores)
        commit = is_tom & (phase == K)
        best = torch.argmax(tom_scores, dim=1).to(torch.int32)
        prev_map = _where(env.tom_active >= 0,
                          tom_cands[torch.clamp(env.tom_active, min=0).long()],
                          env.page_to_cube)
        changed = ((tom_cands[best.long()] != prev_map).to(torch.float32)
                   * page_live).sum(dim=1)
        tom_active = torch.where(commit, best, env.tom_active)
        # remap data movement: amortized one-time link traffic + stall
        mig_stall_tom = torch.where(
            commit, changed * cfg.page_flits * _recip(topo.n_links * 8.0),
            zero)
        migrated_tom = torch.where(commit, changed, zero)
    else:
        tom_scores, tom_active = env.tom_scores, env.tom_active
        mig_stall_tom = migrated_tom = zero

    # ---- energy counters (action-independent part) ----
    add = torch.zeros_like(env.energy)
    add[:, EN_MEM_BITS] = w_valid * 3 * cfg.packet_bytes * 8
    add[:, EN_PAGE_CACHE] = 2 * w_valid
    add[:, EN_NMP_BUF] = 2 * w_valid
    if flags.any_aimm:
        inv = (invoke & is_aimm).to(torch.float32)
        if flags.has_agent:
            bs = agent_cfg.dqn.batch_size
            add[:, EN_WEIGHT] = (1 + 3 * bs) * inv
            add[:, EN_REPLAY] = (1 + bs) * inv
        add[:, EN_STATE_BUF] = 2.0 * inv
    en = env.energy + add

    return EpochMid(
        win=win, w_valid=w_valid, has_ops=has_ops, invoke=invoke,
        cycles=cycles, opc=opc, span_sum=span_sum, span_n=span_n,
        cur_mean=cur_mean, ref_sum=ref_sum, ref_n=ref_n, opc_ring=opc_ring,
        reward=reward, hops_total=hops_total, mean_hops=mean_hops, util=util,
        nmp_occ=nmp_occ, rb_hit=rb_hit, mc_queue=mc_queue, page_ema=page_ema,
        rb_stamp=sparts.rb_stamp, cache=cache, ent=ent, hot_page=hot_page,
        touches_hot=touches_hot, ccube_hot=ccube_hot, svec=svec,
        k_nbr=k_nbr, env_rng=env_rng, tom_scores=tom_scores, tom_active=tom_active,
        mig_stall_tom=mig_stall_tom, migrated_tom=migrated_tom, energy=en)


# ---------------------------------------------------------------------------
# One epoch: action application + state commit
# ---------------------------------------------------------------------------

def _epoch_apply(env: EnvState, mid: EpochMid, action: torch.Tensor,
                 rw_pages: torch.Tensor, ctx: TraceCtx, cfg: NMPConfig,
                 flags: BodyFlags, topo: TopoTensors):
    """Apply the chosen action and assemble the next env state + metrics
    (every tensor per cell)."""
    C = cfg.n_cubes
    is_tom = ctx.mapper == MAPPER_ID["tom"]
    is_aimm = ctx.mapper == MAPPER_ID["aimm"]
    invoke, has_ops = mid.invoke, mid.has_ops
    cache = mid.cache
    zero = torch.zeros_like(mid.w_valid)
    add = torch.zeros_like(mid.energy)

    if flags.any_aimm:
        hot_page = mid.hot_page
        act_inv = invoke & is_aimm
        nbr = act_mod.random_neighbor(mid.k_nbr, mid.ccube_hot, topo.nbr,
                                      topo.nbr_valid)
        diag = act_mod.far_target(mid.ccube_hot, topo.far)
        is_data = (action == NEAR_DATA) | (action == FAR_DATA)
        is_comp = ((action == NEAR_COMPUTE) | (action == FAR_COMPUTE)
                   | (action == SOURCE_COMPUTE))
        data_tgt = torch.where(action == NEAR_DATA, nbr, diag)
        comp_tgt = torch.where(action == NEAR_COMPUTE, nbr,
                               torch.where(action == FAR_COMPUTE, diag,
                                           torch.full_like(diag, C)))

        old_cube = lane_rows(env.page_to_cube, hot_page)
        mig_latency, mig_stall_aimm, mig_loads_aimm = migration_cost(
            old_cube, data_tgt, lane_rows(rw_pages, hot_page), mid.touches_hot,
            cfg, topo)
        moved = is_data & (data_tgt != old_cube) & act_inv
        migrated_aimm = moved.to(torch.float32)
        page_to_cube = set_lane_rows(env.page_to_cube, hot_page,
                                 torch.where(moved, data_tgt, old_cube))
        mig_latency = torch.where(moved, mig_latency, zero)
        mig_stall_aimm = torch.where(moved, mig_stall_aimm, zero)
        mig_loads_aimm = _where(moved, mig_loads_aimm,
                                torch.zeros_like(mig_loads_aimm))

        # DEFAULT on the selected page clears its compute-remap entry
        old_entry = lane_rows(env.compute_remap, hot_page)
        entry = torch.where(is_comp, comp_tgt,
                            torch.where(action == DEFAULT,
                                        torch.full_like(old_entry, -1),
                                        old_entry))
        compute_remap = set_lane_rows(env.compute_remap, hot_page,
                                  torch.where(act_inv, entry, old_entry))
        # finite compute-remap table: entries expire after remap_ttl epochs
        remap_age = torch.where(compute_remap >= 0, env.remap_age + 1,
                                torch.zeros_like(env.remap_age))
        expired = remap_age > cfg.remap_ttl
        compute_remap = torch.where(expired, torch.full_like(compute_remap,
                                                             -1),
                                    compute_remap)
        remap_age = torch.where(expired, torch.zeros_like(remap_age),
                                remap_age)
        remap_age = _where(is_aimm, remap_age, env.remap_age)
        interval_level = torch.where(
            act_inv, act_mod.adjust_interval(env.interval_level, action),
            env.interval_level)

        cache = cache.replace(
            migrations=set_lane_rows(cache.migrations, mid.ent,
                                 lane_rows(cache.migrations, mid.ent)
                                 + migrated_aimm),
            mig_hist=_where(moved, push_hist(cache.mig_hist, mid.ent,
                                             mig_latency), cache.mig_hist),
            act_hist=_where(act_inv, push_hist(cache.act_hist, mid.ent,
                                               action.to(torch.float32)),
                            cache.act_hist),
        )
        gah = _where(act_inv, torch.cat([env.global_act_hist[:, 1:],
                                         action[:, None]], dim=1),
                     env.global_act_hist)
        recent_pages = _where(act_inv, torch.cat([env.recent_pages[:, 1:],
                                                  hot_page[:, None]], dim=1),
                              env.recent_pages)
        prev_state_vec = _where(act_inv, mid.svec, env.prev_state_vec)
        prev_action = torch.where(invoke, action, env.prev_action)

        # ---- accesses on migrated pages (Fig. 10 stat) ----
        mig_mask = _where(is_aimm, set_lane_rows(
            env.mig_page_mask, hot_page,
            torch.maximum(lane_rows(env.mig_page_mask, hot_page),
                          migrated_aimm)), env.mig_page_mask)
        w = mid.win
        acc_mig = ((mig_mask.gather(1, w.dest.long()) * w.valid).sum(dim=1)
                   + (mig_mask.gather(1, w.src1.long()) * w.valid).sum(dim=1)
                   + (mig_mask.gather(1, w.src2.long()) * w.valid).sum(dim=1))

        aimm_f = is_aimm.to(torch.float32)
        add[:, EN_MIG_Q] = 2 * migrated_aimm * aimm_f
        add[:, EN_MDMA] = migrated_aimm * cfg.page_flits * aimm_f
    else:
        page_to_cube = env.page_to_cube
        compute_remap = env.compute_remap
        remap_age = env.remap_age
        interval_level = env.interval_level
        gah = env.global_act_hist
        recent_pages = env.recent_pages
        prev_state_vec = env.prev_state_vec
        prev_action = env.prev_action
        mig_mask = env.mig_page_mask
        acc_mig = migrated_aimm = mig_stall_aimm = zero
        mig_loads_aimm = torch.zeros_like(env.pending_mig_loads)

    # ---- combine mapper outputs ----
    mig_stall = torch.where(is_aimm, mig_stall_aimm,
                            torch.where(is_tom, mid.mig_stall_tom, zero))
    mig_loads = _where(is_aimm, mig_loads_aimm,
                       torch.zeros_like(env.pending_mig_loads))
    migrated = torch.where(is_aimm, migrated_aimm,
                           torch.where(is_tom, mid.migrated_tom, zero))
    add[:, EN_NET_BIT_HOPS] = (mid.hops_total * cfg.packet_bytes * 8
                               + migrated * cfg.page_bytes * 8 * 2)
    en = mid.energy + add

    cand = EnvState(
        page_to_cube=page_to_cube,
        compute_remap=compute_remap,
        op_ptr=env.op_ptr + cfg.epoch_ops,
        interval_level=interval_level,
        since_invoke=torch.where(invoke, torch.zeros_like(env.since_invoke),
                                 env.since_invoke + 1),
        span_sum=torch.where(invoke, zero, mid.span_sum),
        span_n=torch.where(invoke, zero, mid.span_n),
        prev_span_mean=torch.where(invoke, mid.cur_mean, env.prev_span_mean),
        opc_ring=mid.opc_ring,
        ref_sum=torch.where(invoke, zero, mid.ref_sum),
        ref_n=torch.where(invoke, zero, mid.ref_n),
        page_access_ema=mid.page_ema,
        rb_stamp=mid.rb_stamp,
        nmp_occ=mid.nmp_occ,
        rb_hit=mid.rb_hit,
        mc_queue=mid.mc_queue,
        global_act_hist=gah,
        cache=cache,
        pending_mig_loads=mig_loads,
        pending_mig_stall=mig_stall,
        prev_state_vec=prev_state_vec,
        prev_action=prev_action,
        recent_pages=recent_pages,
        remap_age=remap_age,
        rng=mid.env_rng,
        tom_scores=mid.tom_scores,
        tom_active=mid.tom_active,
        cycles=env.cycles + mid.cycles,
        ops_done=env.ops_done + mid.w_valid,
        hops_sum=env.hops_sum + mid.hops_total,
        util_sum=env.util_sum + mid.util,
        epochs=env.epochs + 1.0,
        mig_count=env.mig_count + torch.where(is_aimm, migrated_aimm, zero),
        mig_page_mask=mig_mask,
        access_total=env.access_total + 3 * mid.w_valid,
        access_on_migrated=env.access_on_migrated + acc_mig,
        energy=en,
    )
    # Gate the whole transition on has_ops: once a (padded) trace is
    # exhausted, later epochs are exact no-ops.
    new_env = _map_state(lambda n, o: _where(has_ops, n, o), cand, env)
    metrics = {
        "opc": mid.opc, "cycles": mid.cycles, "reward": mid.reward,
        "action": torch.where(has_ops, action, torch.zeros_like(action)),
        "mean_hops": torch.where(has_ops, mid.mean_hops, zero),
        "util": torch.where(has_ops, mid.util, zero),
        "invoke": invoke.to(torch.float32), "valid": mid.w_valid,
    }
    return new_env, metrics


# ---------------------------------------------------------------------------
# One epoch: the agent invocation, masked per lane
# ---------------------------------------------------------------------------

def _sel(mask: torch.Tensor, new: AgentState, old: AgentState) -> AgentState:
    """Per-agent select over an AgentState (mask: (G,) bool).  Tensors that
    are the same object on both sides are kept without a copy."""
    def one(n, o):
        return n if n is o else _where(mask, n, o)

    def tree(n, o):
        return {k: (tree(n[k], o[k]) if isinstance(n[k], dict)
                    else one(n[k], o[k])) for k in n}
    rp = new.replay if new.replay is old.replay else _map_state(
        one, new.replay, old.replay)
    return new.replace(
        params=tree(new.params, old.params),
        target_params=tree(new.target_params, old.target_params),
        opt_state=tree(new.opt_state, old.opt_state), replay=rp,
        step=one(new.step, old.step),
        train_steps=one(new.train_steps, old.train_steps),
        loss_ema=one(new.loss_ema, old.loss_ema),
        global_step=one(new.global_step, old.global_step),
        rng=one(new.rng, old.rng))


def _invoke_agent(agent: AgentState, svec: torch.Tensor,
                  reward: torch.Tensor, invoke: torch.Tensor,
                  prev_svec: torch.Tensor, prev_action: torch.Tensor,
                  explore: torch.Tensor, commit: torch.Tensor,
                  prev_ok: torch.Tensor, agent_cfg: AgentConfig
                  ) -> tuple[AgentState, torch.Tensor]:
    """The continual-learning invocation (Fig. 4-2 flow) for every lane,
    masked: the completed transition enters the replay where `commit &
    prev_ok`, the DNN takes one minibatch TD step and epsilon-greedy
    inference picks the next action; lanes not committing keep their agent
    bit for bit.  The minibatch key is split off every committing agent's
    stream whether or not it trains, as the reference draws it outside its
    readiness cond.  Before `min_replay` transitions the TD step is an
    exact no-op (masked batch, zero grads onto zero Adam moments)."""
    ag = agent_mod.observe(agent, prev_svec, prev_action, reward, svec,
                           mask=commit & prev_ok)
    keys = prng.split(ag.rng)                                   # (G, 2, 2)
    ag = ag.replace(rng=torch.where(commit[:, None], keys[:, 0], ag.rng))
    ag = _sel(commit, agent_mod.train_step(ag, agent_cfg, keys[:, 1]), ag)
    action_g, acted = agent_mod.act(ag, agent_cfg, svec, explore)
    ag = _sel(commit, acted, ag)
    action = torch.where(invoke, action_g,
                         torch.full_like(action_g, DEFAULT))
    return ag, action


def _repeat(t, S: int):
    """Per-lane (L, ...) -> per-cell (L*S, ...), lane-major."""
    return t if S == 1 or t is None else t.repeat_interleave(S, dim=0)


def _seed0(t, S: int):
    """The seed-0 cell of every lane: per-cell (L*S, ...) -> (L, ...)."""
    return t if S == 1 else t[::S]


def _epoch(env: EnvState, agent: AgentState | None, trace: dict,
           rw_pages: torch.Tensor, tom_cands: torch.Tensor, ctx: TraceCtx,
           ctx_c: TraceCtx, cfg: NMPConfig, spec: StateSpec,
           agent_cfg: AgentConfig, flags: BodyFlags, topo: TopoTensors,
           S: int = 1):
    """One epoch over L lanes of S cells each (`env`, `agent`, `rw_pages`
    and `ctx_c` per cell, `trace` and `ctx` per lane)."""
    win_l = _fetch_window(_seed0(env.op_ptr, S), trace, ctx, cfg)
    win = Window(*(_repeat(t, S) for t in win_l))
    shared = None
    if S > 1 and flags.share_seed_inv:
        # the seed-invariant half once per lane, from its seed-0 cell
        sp = epoch_ops.shared_parts(
            *win_l, _seed0(env.epochs, S), _seed0(env.rb_stamp, S),
            _seed0(env.page_access_ema, S), ctx.n_pages, ctx.pei_idx,
            pei_k=flags.pei_k, aimm=flags.any_aimm,
            tom_cands=tom_cands if flags.any_tom else None,
            n_cubes=cfg.n_cubes)
        shared = sp._make(_repeat(t, S) for t in sp)
    mid = _epoch_sim(env, win, tom_cands, ctx_c, cfg, spec, agent_cfg,
                     flags, topo, shared)
    is_aimm = ctx_c.mapper == MAPPER_ID["aimm"]
    forced = ctx_c.forced_action
    scripted = torch.where(mid.invoke, forced, torch.full_like(forced,
                                                               DEFAULT))
    if flags.has_agent:
        prev_ok = env.prev_span_mean >= 0.0
        commit = mid.invoke & is_aimm & (forced < 0)
        agent, learned = _invoke_agent(agent, mid.svec, mid.reward,
                                       mid.invoke, env.prev_state_vec,
                                       env.prev_action, ctx_c.explore, commit,
                                       prev_ok, agent_cfg)
        action = torch.where(forced >= 0, scripted, learned)
    else:
        action = scripted
    action = torch.where(is_aimm, action, torch.zeros_like(action))
    env, metrics = _epoch_apply(env, mid, action.to(torch.int32), rw_pages,
                                ctx_c, cfg, flags, topo)
    return env, agent, metrics


def scan_epochs(trace: dict, rw_pages: torch.Tensor, env: EnvState,
                agent: AgentState | None, tom_cands: torch.Tensor,
                ctx: TraceCtx, cfg: NMPConfig, spec: StateSpec,
                agent_cfg: AgentConfig, n_epochs: int, flags: BodyFlags,
                topo: TopoTensors, seed_axis: bool = False):
    """The epoch loop shared by the serial and sweep runners (the
    reference's `scan_epochs`).  `trace` (L, N), `rw_pages` (L, P) and
    `ctx` (L,) are per lane; `env` and `agent` are per cell, L·S of them
    lane-major (S = 1 unless `seed_axis`).  Returns (env, agent, metrics
    stacked (n_epochs, L[, S])).  Nothing is read back to the host."""
    L = ctx.n_ops.shape[0]
    S = env.op_ptr.shape[0] // L
    assert env.op_ptr.shape[0] == L * S and (seed_axis or S == 1)
    ctx_c = TraceCtx(*(_repeat(getattr(ctx, f.name), S)
                       for f in dataclasses.fields(TraceCtx)))
    rw_c = _repeat(rw_pages, S)
    # op_ptr <= e * epoch_ops: the window slice stays inside the trace
    assert (n_epochs - 1) * cfg.epoch_ops + cfg.w_max <= trace["dest"].shape[1]
    per_epoch = []
    with torch.no_grad():
        for _ in range(n_epochs):
            env, agent, m = _epoch(env, agent, trace, rw_c, tom_cands, ctx,
                                   ctx_c, cfg, spec, agent_cfg, flags, topo,
                                   S)
            per_epoch.append(m)
    shape = (n_epochs, L, S) if seed_axis else (n_epochs, L)
    metrics = {k: torch.stack([m[k] for m in per_epoch]).reshape(shape)
               for k in per_epoch[0]}
    return env, agent, metrics


def state_spec_for(cfg: NMPConfig) -> StateSpec:
    """State layout for a config (dim 106 for the paper's Table-1 system)."""
    return StateSpec(n_cubes=cfg.n_cubes, n_mcs=cfg.n_mcs,
                     hop_hist=cfg.hop_hist, lat_hist=cfg.lat_hist,
                     mig_hist=cfg.mig_hist, act_hist=cfg.act_hist)


def default_agent_cfg(cfg: NMPConfig) -> AgentConfig:
    """Default AIMM hyperparameters (gamma = 0, as the reference)."""
    spec = state_spec_for(cfg)
    return AgentConfig(dqn=DQNConfig(state_dim=spec.dim, n_actions=N_ACTIONS,
                                     gamma=0.0))


def pad_trace_ops(trace: Trace, n_total: int, cfg: NMPConfig) -> dict:
    """Trace op arrays padded to `n_total + w_max` ((N,) int32 numpy)."""
    pad = n_total - trace.n_ops + cfg.w_max
    return {k: np.concatenate([v, np.zeros(pad, v.dtype)])
            for k, v in trace.as_dict().items() if k != "program_id"}


class EpisodeSetup(NamedTuple):
    """Everything one serial episode's epoch loop takes (one lane)."""
    trace: dict
    rw_pages: torch.Tensor
    env: EnvState
    agent: AgentState | None
    tom_cands: torch.Tensor
    ctx: TraceCtx
    spec: StateSpec
    agent_cfg: AgentConfig
    flags: BodyFlags
    topo: TopoTensors
    n_epochs: int


def episode_setup(trace: Trace, cfg: NMPConfig, technique: str, mapper: str,
                  agent: AgentState | None, agent_cfg: AgentConfig | None,
                  seed: int, page_table: np.ndarray | None, explore: bool,
                  forced_action: int, device: torch.device) -> EpisodeSetup:
    """The inputs of `run_episode`'s epoch loop on `device`: the trace
    padded by w_max, a fresh env keyed by `seed`, the context and flags,
    and the agent (cold-started from `seed` where a learned lane has none).
    """
    assert mapper in MAPPERS and technique in baselines.TECHNIQUES
    spec = state_spec_for(cfg)
    agent_cfg = agent_cfg or default_agent_cfg(cfg)
    flags = episode_flags(trace, cfg, technique, mapper, forced_action)
    if flags.has_agent and agent is None:
        agent = agent_mod.cold_start(seed, agent_cfg, 1, device)
    tr = {k: torch.from_numpy(v)[None].to(device)
          for k, v in pad_trace_ops(trace, trace.n_ops, cfg).items()}
    rw = torch.from_numpy(np.asarray(trace.read_write, bool))[None].to(device)
    pt = page_table if page_table is not None else default_alloc(
        trace.n_pages, cfg)
    topo = topology_tensors(cfg, device)
    env = _init_env(torch.from_numpy(np.asarray(pt, np.int32))[None].to(
        device), cfg, spec, topo, phase_ring_len(trace, cfg), seed)
    return EpisodeSetup(
        trace=tr, rw_pages=rw, env=env, agent=agent,
        tom_cands=baselines.tom_candidates(trace.n_pages, cfg, device),
        ctx=make_ctx(trace, cfg, technique, mapper, forced_action, explore,
                     device),
        spec=spec, agent_cfg=agent_cfg, flags=flags, topo=topo,
        n_epochs=serial_epochs(trace.n_ops, cfg))


def run_episode(trace: Trace, cfg: NMPConfig = NMPConfig(),
                technique: str = "bnmp", mapper: str = "none",
                agent: AgentState | None = None,
                agent_cfg: AgentConfig | None = None,
                seed: int = 0, page_table: np.ndarray | None = None,
                explore: bool = True, forced_action: int = -1,
                device: str | torch.device = "cuda") -> EpisodeResult:
    """Run one episode (one pass over the trace) and return final stats.

    `agent` persists across episodes (continual learning): pass the
    returned agent back in to keep training; the env state is reset each
    episode.  A learned-AIMM episode without an agent cold-starts one from
    `seed`.  The epoch loop reads nothing back to the host."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 matmuls
    st = episode_setup(trace, cfg, technique, mapper, agent, agent_cfg, seed,
                       page_table, explore, forced_action, dev)
    env, run_agent, metrics = scan_epochs(
        st.trace, st.rw_pages, st.env,
        st.agent if st.flags.has_agent else None, st.tom_cands, st.ctx, cfg,
        st.spec, st.agent_cfg, st.n_epochs, st.flags, st.topo)
    metrics = {k: v[:, 0] for k, v in metrics.items()}
    return EpisodeResult(env.lane(0),
                         run_agent if st.flags.has_agent else st.agent,
                         metrics)


def run_program(trace: Trace, cfg: NMPConfig = NMPConfig(),
                technique: str = "bnmp", mapper: str = "none",
                episodes: int = 5, seed: int = 0,
                page_table: np.ndarray | None = None,
                agent_cfg: AgentConfig | None = None,
                agent: AgentState | None = None,
                device: str | torch.device = "cuda") -> list[EpisodeResult]:
    """Paper §6.1 protocol: run the application episode `episodes` times,
    clearing simulation state between runs but keeping the DNN."""
    results = []
    for e in range(episodes):
        res = run_episode(trace, cfg, technique, mapper, agent=agent,
                          agent_cfg=agent_cfg, seed=seed + e,
                          page_table=page_table, device=device)
        agent = res.agent
        results.append(res)
    return results
