#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; the run exits 0 only if every phase passes):

 1. card: name and power limit (nvidia-smi), then the build of the CUDA
    kernels from `src/repro_torch/csrc/` (one nvcc per source, in parallel).
 2. kernels vs their plain-torch versions on the card, at main-path shapes
    from a real BP/16384 window (P = 4096, W = 128, pei_k = 206):
    fused_epoch in its three call shapes at both flag sets (bnmp+aimm,
    pei) and tom_scores in both its forms (the standalone kernel, and
    folded into the shared stage of the pei flag set, as the PEI + TOM
    episode launches it, in the fused and shared call shapes) must be
    equal (torch.equal), dueling_qnet at B = 1 and B = 64 within 1e-4.
    Times: device time per launch from a CUDA graph of many launches
    (warmed), for the kernel and for the plain version; the eager per-call
    time of the wrapper too; the pei flag set with and without the TOM
    fold in turns (without, with, with, without); and the launch floor (a
    graph-timed one-element in-place add) beside each bound.
 3. the threefry kernel (`csrc/threefry.cu`, every `jax.random` draw of
    the engine) against its plain version on 2^20 keys: split, bits,
    uniform, randint and choice (neighbour-validity weights; also at
    B = 45), torch.equal, graph-timed with the inputs outside L2 beside
    the bytes bound in 32-bit words and in the int64 key layout;
    the TD step's batch-invariant products and sums
    (`csrc/batched_linear.cu`) at G = 45 agents within 1e-5 of their plain
    versions, agent 0 alone equal bit for bit to agent 0 of 45, and a
    whole TD step's wall, host issue and device time at G = 1 and 45,
    kernels against plain torch in turns;
    then kernels 1-3 at the batched engine's widths on the figure grid
    (shared stage with the TOM fold at B = 15 lanes, route stage and
    fused launch at B = 45 cells, qnet at G = 45), equal to their plain
    versions (qnet within 1e-4) and graph-timed.
 4. cells on the card against the port's own CPU path: SPMV/2048 pei/tom
    and KM/384 pei/aimm with forced action 5, and KM/384 bnmp/aimm with
    forced actions 1 and 3 (the NEAR actions' neighbour draw from the env
    key), seed 2.
 5. the single-episode main path at full size: `run_program(BP/16384,
    "bnmp", "aimm", episodes=2)` (learned AIMM, the paper's Table-1 system)
    and `run_episode(BP/16384, "pei", "tom")`, with the kernels' launch
    counts set to 0 just before and read just after.  The TOM scores ride
    in the fused epoch launch: every PEI + TOM epoch counts one folded
    scoring and no standalone tom_scores launch; every random draw of the
    learned episodes is a threefry launch.  Then torch.profiler over one
    warm episode of each program (device busy share, launches per epoch,
    top kernels by time, and the AIMM kernels' rows wherever they rank).
 5b. the batched engine's main path: `run_grid` over the 135-cell figure
    grid (benchmarks/common.py figure_grid: BP, KM, PR, RBM, SPMV x bnmp,
    ldb, pei x none, tom, aimm at 16384 ops, seeds 0-2 folded, learned
    lanes 5 episodes plus a greedy eval episode), counts set to 0 just
    before and read just after: wall time, delivered cell-epochs/s, launches
    by kernel and shape, peak device memory; 6 of its cells again through
    `run_grid_serial` on the card (deterministic lanes ==; learned lanes
    epoch by epoch: action and invoke ==, OPC within rtol 1e-5, up to a
    float-order near-tie, where the actions part at an invocation whose
    top-two Q gap is below 1e-4 relative); a profile of the learned
    group's epoch loop.  (`grid_in_turns.py` times this grid under two
    settings of a knob in turns.)
 5c. the continual layer's paths (counts set to 0 just before each and
    read just after): `[continual]`, bench_continual.py's switch stream
    (KM -> KM+SC -> SC, 4096 ops per app, 5 episodes, bnmp, a baseline
    lane and a learned lane with lineage "stream") through `run_stream`
    with a checkpoint after every phase (per-phase wall, cell-epochs/s,
    launches, peak memory, the store's versions), then the kill-and-resume
    drill (step 0 restored into a fresh PolicyStore, phases 1-2 again) and
    the stream as chained `run_grid(store=)` calls, both `==` to it in
    every metric and stored leaf; `[serving]`, bench_serving.py's full
    fleet (96 tenants, 16 slots, 3 phases, 1024 ops per app, store
    capacity 48) through the MappingServer (ticks, steady-state epochs/s,
    phase latency p50/p99, compile_s, recompiles, evictions, occupancy),
    and 4 tenants against `solo_stream` on the card (per-epoch action and
    invoke `==`, OPC within rtol 1e-5, the near-tie rule of 5b);
    `[faults]`, on a 3-tenant fleet: a poisoned warm agent, attributed
    failures up to quarantine, the store poison with rollback and a stall
    over the deadline, every healthy tenant `==` to the fault-free run on
    the same shapes.
 6. model-zoo kernels vs their plain-torch versions on the card, at the
    main-path shapes (B 1, S 4096): flash attention at minitron-8b's
    (H 32, K 8, hd 128) in bf16 (the wgmma kernel) and f32 within the bars
    of `flash_attention/ref.py` BARS (elementwise, relative L2 overall and
    per row), and in bf16 at hd 32 (the mma.sync kernel); then in bf16 at
    the later archs' shapes: gemma3-12b's global layer (H 16, K 8, hd 256)
    and its local layer (window 1024) at S 4096, deepseek-moe-16b's
    (H 16 = K 16, hd 128: GQA ratio 1), qwen3-32b's (H 64, K 8) and
    phi3-medium-14b's (H 40, K 10) causal layers at S 4096, and
    mixtral-8x22b's sliding-window layer (H 48, K 8, hd 128, window 4096)
    at S 8192, each within BARS,
    beside its bound (4 H hd x the visible query-key pairs) and one SDPA
    call (flash backend; a boolean band mask for a window); non-causal with
    a key length of its own (ZOO_KV_SHAPES): whisper-large-v3's encoder (S
    1500, H = K = 20, hd 64) and cross attention (448 x 1500), and
    llama-3.2-vision-11b's cross attention (4096 x 1601, H 32, K 8, hd
    128) in bf16, and whisper's cross shape again on the f32 and (hd 32)
    mma.sync kernels, each within BARS beside its bound and SDPA; the SSD scan at
    mamba2-370m's (H 32, P 64, N 128, chunk 256) within 1e-4, once with
    fast decay and once with the state carried across chunks; graph-timed,
    with SDPA timed beside flash as the library yardstick, and the SSD's
    bound both on f32 CUDA cores and as a 3xTF32 split on the tensor cores.
 7. card vs CPU at full width, B 1, S 256, final hidden state, the card
    (kernels) against the port's CPU path, depth cut to one super-block
    (minitron-8b, mamba2-370m, qwen3-32b, phi3-medium-14b, mixtral-8x22b:
    2 layers; gemma3-12b: 6; deepseek-moe-16b: its dense first layer and
    one MoE layer; llama-3.2-vision-11b: one 'C' and four 'A' layers over
    1601 image tokens; whisper-large-v3: 2 encoder and 2 decoder layers,
    1500 frames and 448 tokens), MoE layers on the CPU run's routes
    (`repro_torch.testing.RouteReplay`; the card's own top-k must agree on
    MIN_ROUTE_AGREEMENT of the tokens);
    the smoke gemma3-12b, mixtral-8x22b, whisper-large-v3 and
    llama-3.2-vision-11b through 48 teacher-forced decode steps on both
    (the windowed ones past their window of 32, so the card's ring
    buffers wrap; the others on their zero cross caches);
    deepseek-moe-16b's MoE layer at full width twice on the card,
    torch.equal.
 8. the model zoo's main path (ZOO_RUNS) at full width, random weights
    from a seed: prefill forward (`apply` + `logits`, B 1, S 4096) of
    minitron-8b, mamba2-370m, gemma3-12b, deepseek-moe-16b, qwen3-32b,
    phi3-medium-14b and llama-3.2-vision-11b (over 1601 random image
    embeddings) at full depth, whisper-large-v3 at full depth (32 + 32
    layers) over 1500 random encoder frames and 448 tokens, and
    mixtral-8x22b with its depth cut to 2 layers at S 8192 (the phase's
    `reduced` line), one flash launch per attention layer (two per 'C'
    layer, one per encoder layer) and one SSD launch per Mamba layer per
    forward,
    then the serving loop of `launch/serve.py` for each (4 requests,
    batch 4), with the zoo kernels' counts set to 0 just before and read
    just after.
 9. profile: torch.profiler over one warm prefill forward and one serving
    loop of minitron-8b, mamba2-370m, whisper-large-v3 and
    llama-3.2-vision-11b (busy share, top kernels by device time).
10. each phase's wall seconds (`[time]`), a JSON line with every
    kernel's numbers, then the result line {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA card it
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
BP_OPS = 16384                 # paper-scale trace length
W = 128
# the figure grid (benchmarks/common.py figure_grid) with three seeds
GRID_APPS = ("BP", "KM", "PR", "RBM", "SPMV")
GRID_TECHS = ("bnmp", "ldb", "pei")
GRID_SEEDS = (0, 1, 2)
GRID_AIMM_EPISODES = 5
GRID_AIMM_LANES = len(GRID_APPS) * len(GRID_TECHS)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs at main-path shapes
# ---------------------------------------------------------------------------

def epoch_inputs(device, app: str = "BP", n_ops: int = BP_OPS, seed: int = 0,
                 epoch: int = 37):
    """One epoch's fused-kernel inputs (B = 1) from a real trace window, with
    seeded env state: access EMAs with exact ties, row-buffer stamps of
    earlier epochs, a compute-remap table with every kind of entry, pending
    migration loads."""
    import numpy as np
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import pei_hot_index, pei_top_k
    from repro_torch.nmp.topology import topology_tensors
    from repro_torch.nmp.traces import make_trace
    cfg = NMPConfig()
    rng = np.random.default_rng(seed)
    tr = make_trace(app, n_ops=n_ops)
    P, C = tr.n_pages, cfg.n_cubes
    topo = topology_tensors(cfg, device)
    sl = slice(epoch * W, epoch * W + W)
    ema = (rng.choice(np.array([0.0, 0.9, 1.0, 1.81, 2.71], np.float32), P)
           + (rng.random(P) < 0.2) * rng.random(P)).astype(np.float32)
    on = lambda a: torch.from_numpy(np.array(a, copy=True))[None].to(device)
    x = dict(
        dest=on(tr.dest[sl]), src1=on(tr.src1[sl]), src2=on(tr.src2[sl]),
        valid=on(np.ones(W, np.float32)),
        epochs=on(np.float32(epoch)),
        rb_stamp=on(rng.integers(0, (epoch + 1) * 3 * W, P + 1
                                 ).astype(np.int32)),
        page_ema=on(ema), n_pages=on(np.int32(P)),
        pei_idx=on(np.int32(pei_hot_index(P, cfg))),
        eff_table=on(rng.integers(0, C, P).astype(np.int32)),
        compute_remap=on(np.where(rng.random(P) < 0.7, -1,
                                  rng.integers(0, C + 1, P)).astype(np.int32)),
        is_aimm=on(np.bool_(True)),
        pending=on(np.where(rng.random(topo.n_links) < 0.3, 256.0, 0.0
                            ).astype(np.float32)))
    return x, topo, pei_top_k(P, cfg), tr


def qnet_inputs(device, seed: int = 0):
    """Dueling-qnet weights at the main path's shape (state 106, hidden
    128/128, 8 actions; random biases) and states of 1 row (act) and 64
    rows (TD targets): (params, {rows: states})."""
    import torch
    from repro_torch.core import dqn, prng
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import default_agent_cfg
    acfg = default_agent_cfg(NMPConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = dqn.init_params(prng.PRNGKey(seed, device), acfg.dqn, 1, device)
    for k in params:
        if k.startswith("b"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen,
                                          device=device)
    return params, {n: torch.rand((1, n, acfg.dqn.state_dim), generator=gen,
                                  device=device) * 2 for n in (1, 64)}


def _tensors(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def max_abs_err(got, want) -> float:
    errs = [(a.double() - b.double()).abs().max().item()
            for a, b in zip(_tensors(got), _tensors(want)) if a.numel()]
    return max(errs) if errs else 0.0


def all_equal(got, want) -> bool:
    import torch
    g, w = _tensors(got), _tensors(want)
    return len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))


def graph_ms(fn, reps: int = 100) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph, replayed
    (warmed) and timed with CUDA events.  Host overhead drops out."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = float("inf")
    for _ in range(5):
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def eager_ms(fn, reps: int = 200) -> float:
    """Per-call time of eager calls (host launch overhead included)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_floor_ms(dev) -> float:
    """Graph-timed device time of a one-element in-place add: what any
    launch costs on this card however little it does."""
    import torch
    one = torch.zeros(1, device=dev)
    return graph_ms(lambda: one.add_(1.0))


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time the card could take: max(bytes / HBM rate, ops / the peak
    rate of their type, float32 unless given)."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(dev) -> list[dict]:
    import torch
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.epoch_fused import ref as eref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    x, topo, pei_k, tr = epoch_inputs(dev)
    floor = launch_floor_ms(dev)
    log(f"[kernels] launch floor: {floor:.5f} ms (a one-element in-place "
        f"add, graph-timed)")
    P, C, L, M = tr.n_pages, cfg.n_cubes, topo.n_links, cfg.n_mcs
    log(f"[kernels] inputs: BP/{BP_OPS} window, P={P} W={W} C={C} L={L} "
        f"pei_k={pei_k}")
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    rt = dict(n_mcs=M, packet_flits=cfg.packet_flits)
    results = []

    def fused_kernel(pei, aimm, tech, **tom):
        return eops.fused_parts(
            *win, x["epochs"], x["rb_stamp"], x["page_ema"], x["n_pages"],
            x["pei_idx"], x["eff_table"], x["compute_remap"], tech,
            x["is_aimm"], x["pending"], topo, pei_k=pei_k if pei else 0,
            aimm=aimm, **rt, **tom)

    def fused_plain(pei, aimm, tech):
        sp = eref.shared_stage(*win, x["epochs"], x["rb_stamp"],
                               x["page_ema"] if pei else None, x["n_pages"],
                               x["pei_idx"], pei_k=pei_k if pei else 0,
                               aimm=aimm)
        rp = eref.route_stage(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                              x["eff_table"], x["compute_remap"], tech,
                              x["is_aimm"], x["pending"], topo.routes_flat,
                              topo.hops_flat, topo.nearest_mc, pei=pei,
                              aimm=aimm, **rt)
        return sp, rp

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    # the distinct window pages: what a gather from a P-table must read
    pages = torch.unique(torch.cat([x["dest"], x["src1"], x["src2"]], 1))
    n_pages_touched = int(pages.numel())

    # ---- fused_epoch: all three call shapes, at both main-path flag sets --
    fused_rec = {}
    for label, pei, aimm, tech_id in (("bnmp+aimm", False, True, 0),
                                      ("pei", True, False, 2)):
        tech = torch.tensor([tech_id], dtype=torch.int32, device=dev)
        got, want = fused_kernel(pei, aimm, tech), fused_plain(pei, aimm,
                                                               tech)
        if not all_equal(got, want):
            raise AssertionError(f"fused_epoch ({label}, fused shape) differs"
                                 f" from its plain version")
        k = pei_k if pei else 0
        sp = eops.shared_parts(*win, x["epochs"], x["rb_stamp"],
                               x["page_ema"], x["n_pages"], x["pei_idx"],
                               pei_k=k, aimm=aimm)
        if not all_equal(sp, want[0]):
            raise AssertionError(f"fused_epoch ({label}, shared shape) "
                                 f"differs from its plain version")
        rp = eops.route_parts(*win, want[0].rb_winner, want[0].pei_hot1,
                              want[0].pei_hot2, x["eff_table"],
                              x["compute_remap"], tech, x["is_aimm"],
                              x["pending"], topo, pei_k=k, aimm=aimm, **rt)
        if not all_equal(rp, want[1]):
            raise AssertionError(f"fused_epoch ({label}, route shape) "
                                 f"differs from its plain version")
        err = max_abs_err(got, want)
        k_ms = graph_ms(lambda: fused_kernel(pei, aimm, tech))
        p_ms = graph_ms(lambda: fused_plain(pei, aimm, tech))
        call_ms = eager_ms(lambda: fused_kernel(pei, aimm, tech))
        # bytes: the window, the P-sized tables read and written whole, the
        # gathered tables' entries at the window's pages, route tables, outputs
        moved = (nb(*win, x["epochs"], x["rb_stamp"], tech, x["is_aimm"],
                    x["pending"], topo.routes_flat, topo.hops_flat,
                    topo.nearest_mc)
                 + 4 * n_pages_touched * (1 + int(aimm))
                 + (nb(x["page_ema"], x["n_pages"], x["pei_idx"])
                    if pei else 0)
                 + nb(*_tensors(got)))
        ops = 3 * W * (4 + 2 * int(aimm) + 2 * int(pei)) + W * (3 * L + 20) \
            + (4 * P * 8 + P if pei else 0)
        b_ms, b_by = bound(moved, ops)
        log(f"[kernels] fused_epoch {label}: equal in all three call shapes;"
            f" kernel {k_ms:.5f} ms/launch (graph), plain {p_ms:.5f} ms, "
            f"eager wrapper call {call_ms:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by}, {moved} B), launch floor {floor:.5f} ms")
        if label == "bnmp+aimm":
            fused_rec.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by)
        else:
            fused_rec.update(pei_max_abs_err=err, pei_ms=k_ms,
                             pei_plain_ms=p_ms, pei_bound_ms=b_ms)
    results.append(dict(
        name="fused_epoch", route="cuda",
        source="src/repro_torch/csrc/epoch_fused.cu",
        replaces="src/repro/kernels/epoch_fused/kernel.py:42",
        **fused_rec, library_ms=None, launch_floor_ms=floor))

    # ---- tom_scores: the standalone kernel, and folded into the shared
    # stage of the pei flag set (the PEI + TOM episode's one launch) ----
    cands = tom_candidates(P, cfg, dev)
    got = eops.tom_scores(*win, cands, C)
    want = eref.tom_stage(*win, cands, C)
    if not torch.equal(got, want):
        raise AssertionError("tom_scores differs from its plain version")
    tech = torch.tensor([2], dtype=torch.int32, device=dev)
    fsp, frp = fused_kernel(True, False, tech, tom_cands=cands)
    ssp = eops.shared_parts(*win, x["epochs"], x["rb_stamp"], x["page_ema"],
                            x["n_pages"], x["pei_idx"], pei_k=pei_k,
                            aimm=False, tom_cands=cands, n_cubes=C)
    wsp, wrp = fused_plain(True, False, tech)
    for shape, sp_got, rest in (("fused", fsp, (frp, wrp)),
                                ("shared", ssp, ((), ()))):
        if not (torch.equal(sp_got.tom_scores, want) and all_equal(
                (sp_got._replace(tom_scores=None), rest[0]),
                (wsp, rest[1]))):
            raise AssertionError(f"tom_scores folded into fused_epoch (pei, "
                                 f"{shape} shape) differs from the plain "
                                 f"versions")
    k_ms = graph_ms(lambda: eops.tom_scores(*win, cands, C))
    p_ms = graph_ms(lambda: eref.tom_stage(*win, cands, C))
    call_ms = eager_ms(lambda: eops.tom_scores(*win, cands, C))
    # the pei flag set without and with the fold, in turns
    no_tom = lambda: fused_kernel(True, False, tech)
    fold = lambda: fused_kernel(True, False, tech, tom_cands=cands)
    turns = [graph_ms(f) for f in (no_tom, fold, fold, no_tom)]
    fold_ms, pei_ms = min(turns[1:3]), min(turns[0], turns[3])
    K = cands.shape[0]
    moved = nb(*win) + 4 * K * n_pages_touched + nb(got)
    b_ms, b_by = bound(moved, K * W * 12)
    log(f"[kernels] tom_scores K={K}: standalone equal, folded equal in the"
        f" fused and shared shapes; kernel {k_ms:.5f} ms/launch (graph), "
        f"plain {p_ms:.5f} ms, eager wrapper call {call_ms:.5f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}), launch floor {floor:.5f} ms")
    log(f"[kernels] fused_epoch pei in turns without / with / with / "
        f"without the TOM fold: {' / '.join(f'{t:.5f}' for t in turns)} "
        f"ms/launch (graph): the fold adds {fold_ms - pei_ms:.5f} ms")
    results.append(dict(
        name="tom_scores", route="cuda",
        source="src/repro_torch/csrc/epoch_fused.cu",
        replaces="src/repro/kernels/epoch_fused/kernel.py:158",
        max_abs_err=max(max_abs_err(got, want),
                        max_abs_err(fsp.tom_scores, want)),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launch_floor_ms=floor, folded_pei_ms=fold_ms,
        pei_without_tom_ms=pei_ms, fold_turns_ms=turns))

    # ---- dueling_qnet at B = 1 (act) and B = 64 (TD targets) ----
    params, rows = qnet_inputs(dev)
    keys = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")
    qrec = {}
    for n, xs in rows.items():
        got = qops.qnet_forward(params, xs)
        want = dueling_qnet_ref(xs, *[params[k] for k in keys])
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"dueling_qnet B={n} differs from its plain"
                                 f" version beyond 1e-4: "
                                 f"{max_abs_err(got, want)}")
        err = max_abs_err(got, want)
        k_ms = graph_ms(lambda: qops.qnet_forward(params, xs))
        p_ms = graph_ms(lambda: dueling_qnet_ref(xs, *[params[k]
                                                       for k in keys]))
        call_ms = eager_ms(lambda: qops.qnet_forward(params, xs))
        S, H1, H2, A = 106, 128, 128, 8
        flops = 2 * n * (S * H1 + H1 * H2 + H2 * (A + 1)) + 4 * n * A
        moved = nb(xs, got, *[params[k] for k in keys])
        b_ms, b_by = bound(moved, flops)
        log(f"[kernels] dueling_qnet B={n}: max abs err {err:.3g} (tol 1e-4);"
            f" kernel {k_ms:.5f} ms/launch (graph), plain {p_ms:.5f} ms, "
            f"eager wrapper call {call_ms:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), launch floor {floor:.5f} ms")
        if n == 64:
            qrec.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)
        else:
            qrec.update(n1_max_abs_err=err, n1_ms=k_ms, n1_plain_ms=p_ms,
                        n1_bound_ms=b_ms)
    results.append(dict(
        name="dueling_qnet", route="cuda",
        source="src/repro_torch/csrc/dueling_qnet.cu",
        replaces="src/repro/kernels/dueling_qnet/kernel.py:43",
        **qrec, library_ms=None, launch_floor_ms=floor))
    return results


def sweep_inputs(device, lanes: int, seeds: int):
    """Fused-kernel inputs of L lanes (L·S cells) as the batched engine's
    main path gives them: BP/16384 windows at L different epochs, each with
    its own seeded state; the route inputs per cell (S seeded variants of a
    lane's tables).  Returns (lane inputs, cell inputs, topo, pei_k)."""
    import torch
    per = [epoch_inputs(device, seed=i, epoch=(7 * i + 3) % 120)
           for i in range(lanes * seeds)]
    topo, pei_k = per[0][1], per[0][2]
    cat = lambda xs, k: torch.cat([x[k] for x in xs])
    keys = per[0][0].keys()
    lane = {k: cat([per[l * seeds][0] for l in range(lanes)], k)
            for k in keys}
    cell = {k: cat([p[0] for p in per], k) for k in keys}
    for k in ("dest", "src1", "src2", "valid"):   # cells share their window
        cell[k] = lane[k].repeat_interleave(seeds, 0)
    return lane, cell, topo, pei_k


def phase_sweep_widths(dev, floor: float) -> dict[str, dict]:
    """Kernels 1-3 at the batched engine's widths on the figure grid
    (15 learned lanes of 3 seeds): the shared stage with the TOM fold at
    B = 15 lanes, the route stage and the fused launch at B = 45 cells,
    the qnet at G = 45 agents (N = 1 and 64), each against its plain
    version (torch.equal; qnet 1e-4) and graph-timed."""
    import torch
    from repro_torch.core import dqn, prng
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.epoch_fused import ref as eref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    L, S = GRID_AIMM_LANES, len(GRID_SEEDS)
    lane, cell, topo, pei_k = sweep_inputs(dev, L, S)
    P = lane["eff_table"].shape[1]
    cands = tom_candidates(P, cfg, dev)
    rt = dict(n_mcs=cfg.n_mcs, packet_flits=cfg.packet_flits)
    win = lambda x: [x[k] for k in ("dest", "src1", "src2", "valid")]
    tech = torch.tensor([(0, 1, 2)[i % 3] for i in range(L * S)],
                        dtype=torch.int32, device=dev)
    out = {}
    shared = lambda: eops.shared_parts(
        *win(lane), lane["epochs"], lane["rb_stamp"], lane["page_ema"],
        lane["n_pages"], lane["pei_idx"], pei_k=pei_k, aimm=True,
        tom_cands=cands, n_cubes=cfg.n_cubes)
    sp = shared()
    want = eref.shared_stage(*win(lane), lane["epochs"], lane["rb_stamp"],
                             lane["page_ema"], lane["n_pages"],
                             lane["pei_idx"], pei_k=pei_k, aimm=True)
    want_tom = eref.tom_stage(*win(lane), cands, cfg.n_cubes)
    if not (all_equal(sp._replace(tom_scores=None), want)
            and torch.equal(sp.tom_scores, want_tom)):
        raise AssertionError(f"fused_epoch shared+tom at B={L} differs from"
                             f" its plain version")
    rep = lambda t: t.repeat_interleave(S, 0)
    route = lambda: eops.route_parts(
        *win(cell), rep(sp.rb_winner), rep(sp.pei_hot1), rep(sp.pei_hot2),
        cell["eff_table"], cell["compute_remap"], tech, cell["is_aimm"],
        cell["pending"], topo, pei_k=pei_k, aimm=True, **rt)
    route_plain = lambda: eref.route_stage(
        *win(cell), rep(sp.rb_winner), rep(sp.pei_hot1), rep(sp.pei_hot2),
        cell["eff_table"], cell["compute_remap"], tech, cell["is_aimm"],
        cell["pending"], topo.routes_flat, topo.hops_flat, topo.nearest_mc,
        pei=True, aimm=True, **rt)
    if not all_equal(route(), route_plain()):
        raise AssertionError(f"fused_epoch route at B={L * S} differs from "
                             f"its plain version")
    fused = lambda: eops.fused_parts(
        *win(cell), cell["epochs"], cell["rb_stamp"], cell["page_ema"],
        cell["n_pages"], cell["pei_idx"], cell["eff_table"],
        cell["compute_remap"], tech, cell["is_aimm"], cell["pending"], topo,
        pei_k=pei_k, aimm=True, tom_cands=cands, **rt)
    fsp, frp = fused()
    wsp = eref.shared_stage(*win(cell), cell["epochs"], cell["rb_stamp"],
                            cell["page_ema"], cell["n_pages"],
                            cell["pei_idx"], pei_k=pei_k, aimm=True)
    wrp = eref.route_stage(*win(cell), wsp.rb_winner, wsp.pei_hot1,
                           wsp.pei_hot2, cell["eff_table"],
                           cell["compute_remap"], tech, cell["is_aimm"],
                           cell["pending"], topo.routes_flat, topo.hops_flat,
                           topo.nearest_mc, pei=True, aimm=True, **rt)
    if not (all_equal((fsp._replace(tom_scores=None), frp), (wsp, wrp))
            and torch.equal(fsp.tom_scores, eref.tom_stage(
                *win(cell), cands, cfg.n_cubes))):
        raise AssertionError(f"fused_epoch fused+tom at B={L * S} differs "
                             f"from its plain version")
    times = {f"shared_tom_b{L}_ms": graph_ms(shared),
             f"route_b{L * S}_ms": graph_ms(route),
             f"fused_tom_b{L * S}_ms": graph_ms(fused),
             f"route_b{L * S}_plain_ms": graph_ms(route_plain)}
    log(f"[widths] fused_epoch (pei+aimm flags, TOM fold): shared+tom B={L}"
        f", route B={L * S} and fused+tom B={L * S} equal to the plain "
        f"versions; " + ", ".join(f"{k} {v:.5f}" for k, v in times.items())
        + f" (graph), launch floor {floor:.5f} ms")
    out["fused_epoch"] = times

    keys = prng.split(prng.PRNGKey(3, dev), L * S)
    acfg_dqn = dqn.DQNConfig(state_dim=106)
    params = dqn.init_params(keys, acfg_dqn, L * S, dev)
    qk = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    qt = {}
    for n in (1, 64):
        xs = torch.rand((L * S, n, 106), generator=gen, device=dev) * 2
        got = qops.qnet_forward(params, xs)
        want = dueling_qnet_ref(xs, *[params[k] for k in qk])
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"dueling_qnet G={L * S} N={n} differs "
                                 f"from its plain version beyond 1e-4")
        qt[f"g{L * S}_n{n}_ms"] = graph_ms(
            lambda: qops.qnet_forward(params, xs))
        qt[f"g{L * S}_n{n}_max_abs_err"] = max_abs_err(got, want)
    log(f"[widths] dueling_qnet G={L * S}: within 1e-4 at N=1 and 64; "
        + ", ".join(f"{k} {v:.5g}" for k, v in qt.items())
        + " (graph)")
    out["dueling_qnet"] = qt
    return out


def td_agents(dev, G: int):
    """G fresh agents of the paper's Q network (state 106, hidden 128 x 2,
    8 actions) with full replays of random transitions, so a TD step
    samples, trains and updates every agent."""
    import dataclasses
    import torch
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import default_agent_cfg
    cfg = default_agent_cfg(NMPConfig())
    ag = agent_mod.cold_start(torch.arange(G, device=dev), cfg)
    rb = ag.replay
    gen = torch.Generator(device=dev)
    gen.manual_seed(G)
    rnd = lambda t: torch.randn(t.shape, generator=gen, device=dev)
    rb = dataclasses.replace(
        rb, s=rnd(rb.s), s2=rnd(rb.s2), r=rnd(rb.r),
        a=torch.randint(0, cfg.dqn.n_actions, rb.a.shape, generator=gen,
                        device=dev, dtype=rb.a.dtype),
        size=torch.full_like(rb.size, rb.s.shape[1]))
    return ag.replace(replay=rb), cfg


def td_step_times(dev, G: int, plain: bool) -> dict:
    """One TD step (`agent.train`: minibatch draw, Q forward, autograd
    backward, clipped Adam) for G agents, eager: the wall per step over 30
    steps ending in a synchronize, the host's issue time per step (the same
    loop timed without the synchronize: the host is the bound when it is
    close to the wall), the device's kernel time per step from
    torch.profiler, and the launches of the TD step's own kernels.  With
    `plain` the Q layers and the gradient norm are the plain torch versions
    (cuBLAS bmm, torch sums: the parent's TD step)."""
    import torch
    from repro_torch.core import agent as agent_mod
    from repro_torch.core import dqn
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.batched_linear import ref as lref
    from repro_torch.train import optimizer
    ag, cfg = td_agents(dev, G)
    saved = dqn.linear, optimizer.sq_norm
    if plain:
        dqn.linear, optimizer.sq_norm = lref.linear, lref.sq_norm
    try:
        step = lambda: agent_mod.train(ag, cfg)
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        n = 30
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        issue = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        before = lops.launches["batched_linear"]
        step()
        kern = lops.launches["batched_linear"] - before
        _, rows = profiled(lambda: [step() for _ in range(10)])
    finally:
        dqn.linear, optimizer.sq_norm = saved
    return dict(wall_ms=wall * 1e3, issue_ms=issue * 1e3,
                device_ms=sum(r[0] for r in rows) / 10 / 1e3,
                launches=sum(r[1] for r in rows) / 10, kernel_launches=kern)


def phase_batched_linear(dev, floor: float) -> dict:
    """The TD step's batch-invariant products and sums on the card, at the
    grid's learned group (G = 45 agents, 64 replay rows, state 106, hidden
    128): the first layer's forward (product and bias, one launch), its
    input gradient, its weight and bias gradients (one launch) and the
    gradient norm over the Q network's 8 leaves (one launch), each within
    rtol 1e-5 of its plain version (cuBLAS / torch sums, another order) and
    agent 0's result at G = 45 equal bit for bit to the same agent alone
    (G = 1): the property the kernels exist for.  Graph-timed beside the
    plain version and, for the forward, one library call (torch.baddbmm).
    Then one whole TD step at G = 1 and G = 45, kernels and plain in turns
    (kernels, plain, plain, kernels): wall, host issue and device time per
    step, so the host's share of the step is measured, not guessed."""
    import torch
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.batched_linear import ref as lref
    G, N, S_, H = GRID_AIMM_LANES * len(GRID_SEEDS), 64, 106, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x, w, dy, bias = rnd(G, N, S_), rnd(G, S_, H) * 0.1, rnd(G, N, H), rnd(G, H)
    ag, _ = td_agents(dev, G)
    leaves = [rnd(*t.shape) for _, t in sorted(ag.params.items())]
    n_leaf = sum(t[0].numel() for t in leaves)
    cases = {   # name: (kernel, plain, args, flops, bytes an agent)
        "fwd": (lambda a, b, c: lops.bgemm(a, b, c),
                lambda a, b, c: lref.bgemm(a, b, c), (x, w, bias),
                2 * N * S_ * H + N * H, 4 * (N * S_ + S_ * H + H + N * H)),
        "dx": (lambda a, b: lops.bgemm(a, b.transpose(1, 2)),
               lambda a, b: lref.bgemm(a, b.transpose(1, 2)), (dy, w),
               2 * N * S_ * H, 4 * (N * H + S_ * H + N * S_)),
        "dw_db": (lambda a, b: lops.bgemm_colsum(a.transpose(1, 2), b),
                  lambda a, b: lref.bgemm_colsum(a.transpose(1, 2), b),
                  (x, dy), 2 * N * S_ * H + N * H,
                  4 * (N * S_ + N * H + S_ * H + H)),
        "sq_norm": (lambda *ls: lops.sq_norm(list(ls)),
                    lambda *ls: lref.sq_norm(list(ls)), tuple(leaves),
                    2 * n_leaf, 4 * (n_leaf + 1)),
    }
    rec = {}
    for name, (kern, plain, args, flops, nbytes) in cases.items():
        got, want = kern(*args), plain(*args)
        if not all(torch.allclose(g_, w_, rtol=1e-5, atol=1e-5)
                   for g_, w_ in zip(_tensors(got), _tensors(want))):
            raise AssertionError(f"batched_linear {name} differs from its "
                                 f"plain version beyond 1e-5: "
                                 f"{max_abs_err(got, want)}")
        alone = kern(*(t[:1] for t in args))
        if not all(torch.equal(a_[0], g_[0])
                   for a_, g_ in zip(_tensors(alone), _tensors(got))):
            raise AssertionError(f"batched_linear {name}: agent 0 alone "
                                 f"differs from agent 0 of {G}")
        plain_alone = plain(*(t[:1] for t in args))
        plain_inv = all(torch.equal(a_[0], g_[0]) for a_, g_ in zip(
            _tensors(plain_alone), _tensors(want)))
        k_ms = graph_ms(lambda: kern(*args))
        p_ms = graph_ms(lambda: plain(*args))
        b_ms, b_by = bound(G * nbytes, G * flops)
        rec[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=max_abs_err(got, want))
        log(f"[batched_linear] {name} G={G}: within 1e-5 of plain (max abs "
            f"err {rec[name]['max_abs_err']:.3g}), agent 0 alone == agent 0"
            f" of {G} (plain: {'==' if plain_inv else 'differs'}); kernel "
            f"{k_ms:.5f} ms/launch (graph), plain {p_ms:.5f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), launch floor {floor:.5f} ms")
    lib_ms = graph_ms(lambda: torch.baddbmm(bias[:, None, :], x, w))
    log(f"[batched_linear] fwd G={G}: library torch.baddbmm {lib_ms:.5f} ms")
    # host cost of one wrapper call against one torch call, G = 1 (eager:
    # both host-bound at this size)
    x1, w1, b1 = x[:1], w[:1], bias[:1]
    host_k = eager_ms(lambda: lops.bgemm(x1, w1, b1))
    host_t = eager_ms(lambda: torch.baddbmm(b1[:, None, :], x1, w1))
    log(f"[batched_linear] one eager call at G=1 (host-bound): kernel "
        f"wrapper {host_k:.5f} ms, torch.baddbmm {host_t:.5f} ms")
    td = {}
    for g_ in (1, G):
        for plain in (False, True, True, False):
            r = td_step_times(dev, g_, plain)
            td.setdefault((g_, plain), []).append(r)
            log(f"[batched_linear] TD step G={g_} "
                f"{'plain torch' if plain else 'kernels'}: wall "
                f"{r['wall_ms']:.4f} ms/step, host issue {r['issue_ms']:.4f} "
                f"ms, device {r['device_ms']:.4f} ms in {r['launches']:.0f} "
                f"launches ({r['kernel_launches']} batched_linear)")
    first = rec["fwd"]
    return dict(
        name="batched_linear", route="cuda",
        source="src/repro_torch/csrc/batched_linear.cu",
        replaces="none: XLA's dot_general and reductions of the TD step "
                 "(src/repro/core/dqn.py td_loss under jax.value_and_grad), "
                 "no pallas_call",
        **first, library_ms=lib_ms, launch_floor_ms=floor,
        host_call_ms=host_k, host_call_torch_ms=host_t,
        **{f"{m}_{k}": v for m, r in rec.items() for k, v in r.items()
           if m != "fwd"},
        **{f"td_G{g_}_{'plain' if p else 'kernels'}_{k}":
           [r[k] for r in rs] for (g_, p), rs in td.items()
           for k in ("wall_ms", "issue_ms", "device_ms")})


def cold_graph_ms(fn, inputs: list, reps: int = 24) -> float:
    """graph_ms of fn(*inputs[i]) with the input sets taken in turn (their
    total above the card's 50 MB L2) and every call's output kept alive
    while timing, so each call reads its inputs from device memory and
    writes its outputs to fresh memory: the bytes bound then applies."""
    import itertools
    keep, turn = [], itertools.count()
    try:
        return graph_ms(lambda: keep.append(
            fn(*inputs[next(turn) % len(inputs)])), reps=reps)
    finally:
        keep.clear()


def neighbour_weights(dev, n: int):
    """choice's p as `actions.random_neighbor` builds it on the paper's
    Table-1 system: key i's row is the validity row of cube i % C over the
    topology's D neighbour slots, divided by its count (edge cubes have
    zero slots)."""
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.topology import get_topology
    valid = torch.from_numpy(get_topology(NMPConfig()).nbr_valid).to(dev)
    p = valid[torch.arange(n, device=dev) % valid.shape[0]].to(torch.float32)
    return p / torch.clamp(p.sum(dim=1, keepdim=True), min=1.0)


def phase_prng(dev, floor: float) -> dict:
    """The threefry kernel against its plain version (ref.py, on the card,
    same inputs) on 2^20 keys, one launch per draw: split, bits, uniform,
    randint and choice (p = neighbour-validity rows, as random_neighbor
    draws NEAR targets), torch.equal; choice also at B = 45 keys, the
    grid's learned group.  Graph-timed with six input sets taken in turn
    and fresh outputs (so the draws stream through device memory, not the
    50 MB L2), beside two bytes bounds over 3.35 TB/s: the function's own
    bytes in 32-bit words (a key 8 B, a bits draw 4 B; `bound_ms`) and the
    port's int64 key layout (a key 16 B, a bits draw 8 B), which doubles
    the key traffic; the integer operations (~90 a hash) are counted at
    the f32 rate (the table has no int32 rate)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ops as tops
    from repro_torch.kernels.threefry import ref as tref
    n, n_sets = 1 << 20, 6
    D = neighbour_weights(dev, 1).shape[1]
    sets = []
    for j in range(n_sets):
        keys = prng.split(prng.PRNGKey(j, dev), n)
        hi = ((torch.arange(n, device=dev) * (j + 1)) % 4096 + 1).to(
            torch.int32)
        p = neighbour_weights(dev, n).roll(j, dims=0).contiguous()
        sets.append((keys, hi, p))
    # mode: (kernel, plain, hashes a key, (in, out) bytes a key as int64
    # layout, (in, out) as 32-bit words)
    draws = {
        "split": (lambda k, h, p: tops.split(k, 2),
                  lambda k, h, p: tref.split(k, 2), 2, (16, 32), (8, 16)),
        "bits": (lambda k, h, p: tops.bits(k, ()),
                 lambda k, h, p: tref.bits(k, ()), 1, (16, 8), (8, 4)),
        "uniform": (lambda k, h, p: tops.uniform(k, ()),
                    lambda k, h, p: tref.uniform(k, ()), 1, (16, 4), (8, 4)),
        "randint": (lambda k, h, p: tops.randint(k, (), 0, h),
                    lambda k, h, p: tref.randint(k, (), 0, h), 4,
                    (16 + 4, 4), (8 + 4, 4)),
        "choice": (lambda k, h, p: tops.choice(k, p),
                   lambda k, h, p: tref.choice(k, p), 1,
                   (16 + 4 * D, 8), (8 + 4 * D, 4)),
    }
    rec = {}
    for mode, (kern, plain, hashes, lay, words) in draws.items():
        for j, args in enumerate(sets[:2]):
            if not torch.equal(kern(*args), plain(*args)):
                raise AssertionError(f"threefry {mode} differs from its "
                                     f"plain version (input set {j})")
        k_ms = cold_graph_ms(kern, sets)
        p_ms = cold_graph_ms(plain, sets, reps=6)
        ops_n = n * (hashes * 90 + (2 * D if mode == "choice" else 0))
        b_ms, b_by = bound(n * sum(words), ops_n)
        l_ms, _ = bound(n * sum(lay), ops_n)
        log(f"[prng] threefry {mode} on 2^20 keys: equal; kernel {k_ms:.5f} "
            f"ms/launch (graph, inputs and outputs outside L2), plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}, {n * sum(words)} B "
            f"as 32-bit words), {l_ms:.6f} ms in the int64 key layout "
            f"({n * sum(lay)} B), launch floor {floor:.5f} ms")
        rec[mode] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_int64_layout_ms=l_ms)
    # choice at the grid's learned group: 45 keys, one launch each
    k45 = prng.split(prng.PRNGKey(45, dev), 45)
    p45 = neighbour_weights(dev, 45)
    got, want = tops.choice(k45, p45), tref.choice(k45, p45)
    if not torch.equal(got, want):
        raise AssertionError("threefry choice at B = 45 differs from its "
                             "plain version")
    c45_ms = graph_ms(lambda: tops.choice(k45, p45))
    c45_plain = graph_ms(lambda: tref.choice(k45, p45))
    c45_b, c45_by = bound(45 * (8 + 4 * D + 4), 45 * (90 + 2 * D))
    log(f"[prng] threefry choice at B = 45: equal (draws "
        f"{got.tolist()[:8]}...); kernel {c45_ms:.5f} ms/launch (graph), "
        f"plain {c45_plain:.5f} ms, bound {c45_b:.7f} ms ({c45_by}), launch "
        f"floor {floor:.5f} ms")
    rec["choice45"] = dict(ms=c45_ms, plain_ms=c45_plain, bound_ms=c45_b)
    first = rec["split"]
    return dict(
        name="threefry", route="cuda", source="src/repro_torch/csrc/threefry.cu",
        replaces="none: XLA's own threefry2x32 lowering "
                 "(jax/_src/prng.py _threefry2x32_lowering), no pallas_call",
        max_abs_err=0.0, **first, library_ms=None, launch_floor_ms=floor,
        keys=n, **{f"{m}_{k}": v for m, r in rec.items() for k, v in r.items()
                   if m != "split"})


# The model zoo's prefill shape: the repo's prefill_32k (S 32768, batch 32)
# cut to S 4096 and batch 1 for the time limit.  S 4096 is above the
# reference's DENSE_MAX_S (its chunked attention) and 16 SSD chunks of 256.
ZOO_SEQ = 4096
ZOO_BATCH = 1


def flash_inputs(dev, dtype, seed: int = 0, hd: int | None = None):
    """q, k, v at minitron-8b's attention shape: (1, 4096, 32 | 8, 128),
    or another head dim."""
    import torch
    from repro_torch.configs import get_config
    a = get_config("minitron-8b").attn
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn((ZOO_BATCH, ZOO_SEQ, n, hd or a.head_dim),
                        generator=gen, device=dev).to(dtype)
            for n in (a.n_heads, a.n_kv, a.n_kv)]


def ssd_inputs(dev, carry: bool, seed: int = 0):
    """x, b, c, dt, a at mamba2-370m's SSD shape, x and B/C scaled as the
    model's own (after a SiLU'd conv).  `carry` False: dt = softplus(randn
    - 2) ~ 0.13 and a = -(1..H), so each chunk's decay exp(seg_end) is below
    e^-33 and the state hardly crosses a chunk.  `carry` True: dt = 0.01
    softplus(randn) and a = -uniform(0.05, 1), a chunk's decay 0.17-0.99,
    so every chunk's output leans on the state carried in from the ones
    before (Mamba2's dt range is 1e-3 to 1e-1)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.mamba import dims
    cfg = get_config("mamba2-370m")
    _, H = dims(cfg.d_model, cfg.ssm)
    P, N = cfg.ssm.head_dim, cfg.ssm.d_state
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = torch.nn.functional.silu(rnd(ZOO_BATCH, ZOO_SEQ, H, P))
    b = torch.nn.functional.silu(rnd(ZOO_BATCH, ZOO_SEQ, N))
    c = torch.nn.functional.silu(rnd(ZOO_BATCH, ZOO_SEQ, N))
    if carry:
        dt = 0.01 * torch.nn.functional.softplus(rnd(ZOO_BATCH, ZOO_SEQ, H))
        a = -(0.05 + 0.95 * torch.rand(H, generator=gen, device=dev))
    else:
        dt = torch.nn.functional.softplus(rnd(ZOO_BATCH, ZOO_SEQ, H) - 2.0)
        a = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
    return x, b, c, dt, a


# mixtral-8x22b's prefill length: S 8192, so that its window of 4096 bites
MIXTRAL_SEQ = 8192
# whisper-large-v3's published 30 s window (1500 encoder frames) and decoder
# length (448 tokens)
WHISPER_FRAMES = 1500
WHISPER_TOKENS = 448
# The causal flash shapes of the later archs' main path (bf16, B 1):
# gemma3-12b's global and local layers (hd 256, window 1024),
# deepseek-moe-16b's (GQA ratio 1), qwen3-32b's and phi3-medium-14b's at
# S 4096, mixtral-8x22b's sliding-window layer at S 8192 (window 4096), and
# whisper-large-v3's decoder self-attention (S 448, hd 64).
ZOO_FLASH_SHAPES = (("gemma3-12b global", "gemma3-12b", ZOO_SEQ, False),
                    ("gemma3-12b local", "gemma3-12b", ZOO_SEQ, True),
                    ("deepseek-moe-16b", "deepseek-moe-16b", ZOO_SEQ, False),
                    ("qwen3-32b", "qwen3-32b", ZOO_SEQ, False),
                    ("phi3-medium-14b", "phi3-medium-14b", ZOO_SEQ, False),
                    ("mixtral-8x22b W", "mixtral-8x22b", MIXTRAL_SEQ, True),
                    ("whisper-large-v3 decoder", "whisper-large-v3",
                     WHISPER_TOKENS, False))
# Non-causal flash with its own key length (label, arch, S, S_kv, dtype, hd
# or None for the arch's): whisper's encoder (bidirectional, S 1500) and
# cross attention (448 x 1500), llama-3.2-vision-11b's cross attention (4096
# text tokens x 1601 image tokens), bf16; then the same mode on the other
# two CUDA kernels (f32 on CUDA cores, and bf16 at hd 32 through mma.sync)
# at whisper's cross shape.
ZOO_KV_SHAPES = (
    ("whisper-large-v3 encoder", "whisper-large-v3", WHISPER_FRAMES,
     WHISPER_FRAMES, "bf16", None),
    ("whisper-large-v3 cross", "whisper-large-v3", WHISPER_TOKENS,
     WHISPER_FRAMES, "bf16", None),
    ("llama-3.2-vision-11b cross", "llama-3.2-vision-11b", ZOO_SEQ, 1601,
     "bf16", None),
    ("whisper-large-v3 cross f32", "whisper-large-v3", WHISPER_TOKENS,
     WHISPER_FRAMES, "f32", None),
    ("whisper-large-v3 cross hd 32", "whisper-large-v3", WHISPER_TOKENS,
     WHISPER_FRAMES, "bf16", 32))


def visible_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs, within `window` of the query if set."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def event_ms(fn, reps: int = 3) -> float:
    """Device time per eager call: one warm call, then `reps` timed with
    CUDA events (for calls of milliseconds, whose launch cost is noise, and
    whose gigabytes of temporaries a graph would hold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def flash_plain(q, k, v, window: int = 0, causal: bool = True):
    """attention_ref on (B, S, H, hd) q and (B, S_kv, K, hd) k/v, one KV
    head's query heads at a time, so the f32 scores of S 8192 stay a few
    GB."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    H, K = q.shape[2], k.shape[2]
    rep = H // K
    outs = [attention_ref(
        q[:, :, j * rep:(j + 1) * rep].transpose(1, 2),
        k[:, :, j:j + 1].expand(-1, -1, rep, -1).transpose(1, 2),
        v[:, :, j:j + 1].expand(-1, -1, rep, -1).transpose(1, 2),
        window=window, causal=causal).transpose(1, 2) for j in range(K)]
    return torch.cat(outs, dim=2)


def zoo_flash_shape(dev, label: str, arch: str, S: int,
                    windowed: bool = False, S_kv: int | None = None,
                    dtype: str = "bf16", hd: int | None = None) -> dict:
    """One later arch's flash shape: the kernel against the plain version
    within BARS, graph-timed, beside its bound (4 H hd x the visible
    query-key pairs at the tensor-core rate of bf16, or the f32 CUDA-core
    rate, or q/k/v/o bytes over HBM) and one SDPA call for the same
    function (the flash backend for bf16 without a mask; a boolean band
    attn_mask for a window; the default backend for f32).  Causal, unless
    `S_kv` is given: then non-causal with keys of that length (the
    encoder's and cross attention)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import BARS, compare, visible
    a = get_config(arch).attn
    H, K, hd = a.n_heads, a.n_kv, hd or a.head_dim
    window = a.window if windowed else 0
    causal = S_kv is None
    S_kv = S if causal else S_kv
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(S + S_kv + hd + window)
    q, k, v = (torch.randn((1, n_s, n, hd), generator=gen, device=dev).to(tdt)
               for n_s, n in ((S, H), (S_kv, K), (S_kv, K)))
    kernel = fops.kernel_for(q.dtype, hd)
    run = lambda: fops.gqa_flash_attention_kv(q, k, v, causal=causal,
                                              window=window)
    before = fops.kernel_launches[kernel]
    got = run()
    want = flash_plain(q, k, v, window, causal)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if fops.kernel_launches[kernel] != before + 1 or not cmp["ok"]:
        raise AssertionError(f"flash_attention {label} ({kernel}): {cmp}, "
                             f"bars {BARS[tdt]}, launches "
                             f"{fops.kernel_launches}")
    del want
    k_ms = graph_ms(run, 20)
    p_ms = event_ms(lambda: flash_plain(q, k, v, window, causal), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        band = visible(S, S, window, dev)
        lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True), 5)
        lib = "SDPA, boolean band attn_mask"
    elif dtype == "bf16":
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        lib = "SDPA, flash backend"
    else:
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        lib = "SDPA, default backend"
    pairs = H * (visible_pairs(S, window) if causal else S * S_kv)
    flops = 4 * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S if dtype == "bf16"
                       else F32_OPS_PER_S)
    log(f"[zoo-kernels] flash_attention {dtype} ({kernel}) {label}: B=1 "
        f"S={S} S_kv={S_kv} H={H} K={K} hd={hd} "
        f"{'causal' if causal else 'non-causal'} window={window}: max abs err "
        f"{cmp['max_abs_err']:.3g}, relative L2 {cmp['rel_l2']:.3g}, worst "
        f"row {cmp['row_rel_l2']:.3g}; kernel {k_ms:.4f} ms/launch (graph), "
        f"plain {p_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {flops:.4g} FLOP over {pairs} visible pairs; "
        f"{flops / k_ms / 1e9:.1f} TFLOP/s)")
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(label=label, S=S, S_kv=S_kv, H=H, K=K, hd=hd, dtype=dtype,
                causal=causal, window=window,
                kernel=kernel, max_abs_err=cmp["max_abs_err"], ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=lib)


def phase_zoo_kernels(dev) -> list[dict]:
    """Flash attention (minitron-8b shape, bf16 and f32; the mma.sync kernel
    at hd 32) and the SSD scan (mamba2-370m shape, f32) against their plain
    versions on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import BARS as flash_bars
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_attention.ref import compare as \
        flash_compare
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    results = []

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # ---- flash attention ----
    a = get_config("minitron-8b").attn
    H, K, hd, S = a.n_heads, a.n_kv, a.head_dim, ZOO_SEQ
    rep = H // K

    def plain(q, k, v):
        kk, vv = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        return attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                             vv.transpose(1, 2)).transpose(1, 2)

    frec = None
    for dtype, rate in ((torch.bfloat16, BF16_OPS_PER_S),
                        (torch.float32, F32_OPS_PER_S)):
        q, k, v = flash_inputs(dev, dtype)
        kernel = fops.kernel_for(dtype, hd)
        before = dict(fops.kernel_launches)
        got = fops.gqa_flash_attention(q, k, v, causal=True)
        want = plain(q, k, v)
        torch.cuda.synchronize()
        if fops.kernel_launches[kernel] != before[kernel] + 1:
            raise AssertionError(f"flash_attention {dtype} did not launch "
                                 f"{kernel}: {fops.kernel_launches}")
        cmp, bar = flash_compare(got, want), flash_bars[dtype]
        err = cmp["max_abs_err"]
        if not cmp["ok"]:
            raise AssertionError(f"flash_attention {dtype} ({kernel}) differs"
                                 f" from its plain version beyond {bar}: "
                                 f"{cmp}")
        k_ms = graph_ms(lambda: fops.gqa_flash_attention(q, k, v,
                                                         causal=True), 20)
        p_ms = graph_ms(lambda: plain(q, k, v), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        pairs = ZOO_BATCH * H * S * (S + 1) // 2      # causal (q, k) pairs
        flops = 4 * hd * pairs
        b_ms, b_by = bound(nb(q, k, v, got), flops, rate)
        log(f"[zoo-kernels] flash_attention {str(dtype)[6:]} ({kernel}) B="
            f"{ZOO_BATCH} S={S} H={H} K={K} hd={hd}: max abs err {err:.3g}, "
            f"relative L2 {cmp['rel_l2']:.3g}, worst row "
            f"{cmp['row_rel_l2']:.3g} (bars {json.dumps(bar)});"
            f" kernel {k_ms:.4f} ms/launch (graph), plain {p_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{flops:.3g} FLOP; {flops / k_ms / 1e9:.1f} TFLOP/s)")
        if dtype == torch.bfloat16:
            frec = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, got, want
    # the mma.sync kernel (bf16 at hd 16 and 32) at the main path's S and
    # heads: off the main path, held to the same bars
    a32 = flash_inputs(dev, torch.bfloat16, hd=32)
    before = fops.kernel_launches["mma_sync_bf16"]
    got = fops.gqa_flash_attention(*a32, causal=True)
    cmp = flash_compare(got, plain(*a32))
    if fops.kernel_launches["mma_sync_bf16"] != before + 1 or not cmp["ok"]:
        raise AssertionError(f"flash_attention bf16 hd 32 (mma_sync_bf16): "
                             f"{cmp}, launches {fops.kernel_launches}")
    m_ms = graph_ms(lambda: fops.gqa_flash_attention(*a32, causal=True), 20)
    log(f"[zoo-kernels] flash_attention bf16 (mma_sync_bf16) hd=32 S={S} "
        f"H={H} K={K}: max abs err {cmp['max_abs_err']:.3g}, relative L2 "
        f"{cmp['rel_l2']:.3g}, worst row {cmp['row_rel_l2']:.3g}; kernel "
        f"{m_ms:.4f} ms/launch (graph)")
    del a32, got
    frec["shapes"] = ([zoo_flash_shape(dev, *shape) for shape in
                       ZOO_FLASH_SHAPES]
                      + [zoo_flash_shape(dev, label, arch, S, S_kv=S_kv,
                                         dtype=dt, hd=hd)
                         for label, arch, S, S_kv, dt, hd in ZOO_KV_SHAPES])
    results.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80", **frec))

    # ---- SSD scan ----
    cfg = get_config("mamba2-370m")
    Q = cfg.ssm.chunk
    err = 0.0
    for carry in (False, True):
        x, b, c, dt, av = ssd_inputs(dev, carry)
        got = sops.ssd(x, b, c, dt, av, chunk=Q)
        want = ssd_chunked(x, b, c, dt, av, chunk=Q)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"ssd_scan (carry {carry}) differs from its"
                                 f" plain version beyond 1e-4: {e}")
        Bz, L, Hs, P = x.shape
        seg_end = (dt[:, :Q] * av).sum(1)                   # chunk 0, (B, H)
        log(f"[zoo-kernels] ssd_scan carry={carry}: chunk decay "
            f"exp(seg_end) {float(seg_end.exp().min()):.3g}-"
            f"{float(seg_end.exp().max()):.3g}, max |y| "
            f"{float(want.abs().max()):.3g}, max abs err {e:.3g} (tol 1e-4)")
        err = max(err, e)
    k_ms = graph_ms(lambda: sops.ssd(x, b, c, dt, av, chunk=Q), 10)
    p_ms = graph_ms(lambda: ssd_chunked(x, b, c, dt, av, chunk=Q), 5)
    N = b.shape[-1]
    nc = L // Q
    # per chunk: the causal half of C.B^T once (shared by the heads); per
    # head the causal intra product (C.B^T-weights) X, the inter term C.R
    # for every chunk but the first (R_0 = 0) and the state update B^T (w x)
    # for every chunk but the last (nothing reads its result)
    flops = Bz * (nc * Q * (Q + 1) * N
                  + Hs * (nc * P * Q * (Q + 1) + (nc - 1) * 4 * Q * N * P))
    moved = nb(x, b, c, dt, av, got)
    f_ms, f_by = bound(moved, flops)
    # the kernel's route: three TF32 tensor-core products per f32 product
    t_ms, t_by = bound(moved, 3 * flops, TF32_OPS_PER_S)
    b_ms, b_by = min((f_ms, f_by), (t_ms, t_by))
    log(f"[zoo-kernels] ssd_scan B={Bz} L={L} H={Hs} P={P} N={N} chunk={Q}:"
        f" max abs err {err:.3g} (tol 1e-4, both cases); kernel {k_ms:.4f} "
        f"ms/launch (graph), plain {p_ms:.4f} ms, bound {f_ms:.4f} ms on f32 "
        f"CUDA cores ({f_by}), {t_ms:.4f} ms as 3xTF32 on the tensor cores "
        f"({t_by}), "
        f"{flops:.4g} FLOP, {moved} B")
    results.append(dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:74", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None))
    return results


ZOO_ARCHS = ("minitron-8b", "mamba2-370m", "whisper-large-v3",
             "llama-3.2-vision-11b")
# The zoo's main path: (arch, layers or None for the published depth,
# prefill S).  mixtral-8x22b (141 B parameters, ~282 GB of bf16 weights)
# runs at full width with its depth cut to 2 layers, at S 8192 so that
# its window of 4096 bites; every other arch at full width and depth,
# whisper-large-v3 at its decoder length of 448 tokens over 1500 encoder
# frames, llama-3.2-vision-11b's S 4096 over its 1601 image tokens.
ZOO_RUNS = (("minitron-8b", None, ZOO_SEQ), ("mamba2-370m", None, ZOO_SEQ),
            ("gemma3-12b", None, ZOO_SEQ), ("deepseek-moe-16b", None, ZOO_SEQ),
            ("qwen3-32b", None, ZOO_SEQ), ("phi3-medium-14b", None, ZOO_SEQ),
            ("mixtral-8x22b", 2, MIXTRAL_SEQ),
            ("whisper-large-v3", None, WHISPER_TOKENS),
            ("llama-3.2-vision-11b", None, ZOO_SEQ))


def zoo_launches() -> dict[str, int]:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    return {**fops.launches, **sops.launches}


def flash_by_kernel() -> dict[str, int]:
    from repro_torch.kernels.flash_attention import ops as fops
    return dict(fops.kernel_launches)


def reset_zoo_launches() -> None:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    fops.reset_launches()
    sops.reset_launches()


def zoo_tokens(dev, cfg, seq: int, seed: int = 0):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(1, cfg.vocab, (ZOO_BATCH, seq), generator=gen,
                         device=dev)


def zoo_batch(dev, cfg, seq: int, seed: int = 0) -> dict:
    """The prefill batch of `cfg` on `dev`: tokens (B, seq), plus the
    stubbed frontend's output in bf16 from the seed: whisper's enc_frames
    (B, 1500, D), llama-vision's img_embed (B, n_img_tokens, D)."""
    import torch
    batch = {"tokens": zoo_tokens(dev, cfg, seq, seed)}
    n_mem = (WHISPER_FRAMES if cfg.encoder is not None else
             cfg.n_img_tokens)
    if n_mem:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        key = "enc_frames" if cfg.encoder is not None else "img_embed"
        batch[key] = torch.randn((ZOO_BATCH, n_mem, cfg.d_model),
                                 generator=gen, device=dev).bfloat16()
    return batch


def zoo_config(arch: str, layers: int | None):
    """`arch` at full width, its depth cut to `layers` if given (an
    encoder's too)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=layers))
    return dataclasses.replace(cfg, n_layers=layers)


def per_forward(cfg) -> dict[str, int]:
    """Kernel launches one prefill forward of `cfg` makes: flash once per
    attention layer (a leading dense block is one), twice per 'C' layer
    (its self-attention and its cross attention) and once per encoder
    layer, the SSD scan once per Mamba layer; no backward."""
    n_attn = sum(mx in "AGWLB" for mx, _ in cfg.pattern) + 2 * sum(
        mx == "C" for mx, _ in cfg.pattern)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_ssd = sum(mx == "M" for mx, _ in cfg.pattern)
    return {"flash_attention": (cfg.first_k_dense + cfg.n_super * n_attn
                                + n_enc),
            "ssd_scan": cfg.n_super * n_ssd,
            "flash_attention_bwd": 0, "ssd_scan_bwd": 0}


def phase_zoo_model(dev) -> tuple[dict[str, int], dict]:
    """The model zoo's main path (ZOO_RUNS), random weights from a seed:
    the prefill forward (`apply` then `logits`, B 1) twice per arch, then
    the serving loop of `launch/serve.py` (4 requests, batch 4, max-seq
    128, max-new 16) on the same weights.  The kernels' counts are zeroed
    just before and read just after; each forward must launch flash once
    per attention layer and the SSD scan once per Mamba layer.  Returns
    the counts and, per arch, its numbers."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models.model import count_params
    full = SHAPES["prefill_32k"]
    log(f"[zoo] prefill shape: {full.name} (S {full.seq}, batch "
        f"{full.global_batch}) cut to batch {ZOO_BATCH} and S {ZOO_SEQ} "
        f"({MIXTRAL_SEQ} for mixtral-8x22b; whisper-large-v3 at its "
        f"published {WHISPER_TOKENS} decoder tokens over {WHISPER_FRAMES} "
        f"encoder frames)")
    reset_zoo_launches()
    by_arch = {}
    for arch, layers, seq in ZOO_RUNS:
        cfg = zoo_config(arch, layers)
        per_fwd = per_forward(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dev)
        t0 = time.perf_counter()
        params = model.init(0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = zoo_batch(dev, cfg, seq)
        walls, arch_before = [], zoo_launches()
        with torch.inference_mode():
            for _ in range(2):
                before, kb = zoo_launches(), flash_by_kernel()
                t0 = time.perf_counter()
                hidden, _ = model.apply(params, batch)
                logits = model.logits(params, hidden)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got = {k: v - before[k] for k, v in zoo_launches().items()}
                if got != per_fwd:
                    raise AssertionError(f"{arch} prefill launched {got}, "
                                         f"expected {per_fwd}")
                kernels = {k: v - kb[k] for k, v in flash_by_kernel().items()
                           if v - kb[k]}
            shape = (ZOO_BATCH, seq, cfg.padded_vocab)
            if tuple(logits.shape) != shape or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} logits {tuple(logits.shape)} "
                                     f"(want {shape}) or not finite")
            peak = torch.cuda.max_memory_allocated()
            lg_std = float(logits.float().std())
            del logits, hidden
            torch.cuda.reset_peak_memory_stats()
            reqs, steps, t_serve = serve(cfg, params=params, device=dev)
            serve_peak = torch.cuda.max_memory_allocated()
        measured = {k: v - arch_before[k] for k, v in zoo_launches().items()}
        if not all(r.done and len(r.generated) == 16 for r in reqs):
            raise AssertionError(f"{arch} serve: not every request completed")
        n, n_act = count_params(cfg), count_params(cfg, active_only=True)
        depth = ("" if layers is None else
                 f", depth cut from {get_config_layers(arch)} to {layers}")
        if cfg.encoder is not None:
            depth += (f", encoder {cfg.encoder.n_layers} layers over "
                      f"{WHISPER_FRAMES} frames")
        elif cfg.n_img_tokens:
            depth += f", {cfg.n_img_tokens} image tokens"
        log(f"[zoo] {arch}: {n / 1e9:.3f} B params ({n_act / 1e9:.3f} B "
            f"active; {cfg.n_layers} layers{depth}, d_model {cfg.d_model}), "
            f"init {t_init:.2f} s; prefill B={ZOO_BATCH} S={seq}: first "
            f"{walls[0]:.3f} s, warm {walls[1]:.3f} s ({ZOO_BATCH * seq / walls[1]:.0f} "
            f"tokens/s), launches per forward {json.dumps(per_fwd)}, flash "
            f"by kernel {json.dumps(kernels)}, logits {shape} finite (std "
            f"{lg_std:.3f}), peak device memory {peak / 2**30:.2f} GiB")
        log(f"[zoo] {arch} serve: {len(reqs)}/{len(reqs)} requests done in "
            f"{steps} decode steps, {t_serve:.3f} s ({steps / t_serve:.1f} "
            f"steps/s, batch 4), peak device memory "
            f"{serve_peak / 2**30:.2f} GiB; launches over the arch's two "
            f"forwards and serve loop {json.dumps(measured)}")
        by_arch[arch] = dict(params=n, active_params=n_act,
                             layers=cfg.n_layers, seq=seq,
                             prefill_s=walls[1],
                             tokens_per_s=ZOO_BATCH * seq / walls[1],
                             per_forward=per_fwd, launches=measured,
                             flash_by_kernel=kernels,
                             peak_gib=peak / 2**30,
                             serve_steps_per_s=steps / t_serve,
                             serve_peak_gib=serve_peak / 2**30)
        del params, model, batch
        torch.cuda.empty_cache()
    launches = zoo_launches()
    log(f"[zoo] launches over the phase: {json.dumps(launches)}, flash by "
        f"kernel {json.dumps(flash_by_kernel())}")
    reduced = {arch: f"n_layers {get_config_layers(arch)} -> {layers}"
               for arch, layers, _ in ZOO_RUNS if layers is not None}
    log(f"[zoo] reduced: {json.dumps(reduced)}")
    return launches, by_arch


def get_config_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).n_layers


# card vs CPU: (arch, layers, S) at full width, B 1; the depth cut to one
# super-block (gemma3-12b's is 6 layers; deepseek-moe-16b's 2 are its dense
# first layer and one MoE layer; llama-3.2-vision-11b's 5 are one 'C' and
# four 'A' layers, over its 1601 image tokens), whisper-large-v3 to 2
# encoder and 2 decoder layers at its 1500 frames and 448 tokens.
ZOO_CPU_RUNS = (("minitron-8b", 2, 256), ("mamba2-370m", 2, 256),
                ("gemma3-12b", 6, 256), ("deepseek-moe-16b", 2, 256),
                ("qwen3-32b", 2, 256), ("phi3-medium-14b", 2, 256),
                ("mixtral-8x22b", 2, 256),
                ("whisper-large-v3", 2, WHISPER_TOKENS),
                ("llama-3.2-vision-11b", 5, 256))
# smoke archs decoded teacher-forced on the card and the CPU: the windowed
# ones past their window of 32, the cross-attention ones on their zero
# cross caches
ZOO_CPU_DECODES = ("gemma3-12b", "mixtral-8x22b", "whisper-large-v3",
                   "llama-3.2-vision-11b")


def phase_zoo_card_vs_cpu(dev) -> None:
    """ZOO_CPU_RUNS at full width, B 1: the final hidden state on the card
    (kernels) against the port's CPU path (plain versions) on the same
    weights and inputs, without the LM head, MoE layers on the CPU run's
    routes.  Bar: rtol 2e-2, atol 2e-2 x max |CPU value| -- bf16 matmuls
    and reductions round at other places on the two devices, and the
    flash kernel rounds P to bf16 for its second product.  Then the smoke
    ZOO_CPU_DECODES through a teacher-forced decode of 48 tokens on both
    (gemma3-12b and mixtral-8x22b past their window of 32: the ring
    buffers wrap on the card), and deepseek-moe-16b's MoE layer at full
    width twice on the card, torch.equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.testing import RouteReplay, hold_bf16, tree_to
    for arch, layers, seq in ZOO_CPU_RUNS:
        cfg = zoo_config(arch, layers)
        card, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
        params = card.init(1)
        on_cpu = tree_to(params, "cpu")
        batch = zoo_batch(dev, cfg, seq, seed=1)
        routes = RouteReplay()
        with torch.inference_mode():
            t0 = time.perf_counter()
            with routes.record():
                h_cpu = cpu.apply(on_cpu, tree_to(batch, "cpu"))[0]
            t_cpu = time.perf_counter() - t0
            with routes.replay():
                h_card = card.apply(params, batch)[0]
        verdict = hold_bf16(h_card, h_cpu, f"{arch} depth {layers}")
        agree = routes.check(f"{arch} depth {layers}")
        mem = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
        log(f"[zoo-cpu] {arch} depth {layers}"
            f"{' (encoder too)' if cfg.encoder is not None else ''}, B 1, "
            f"S {seq}{f', memory {mem}' if mem else ''}, full width: card "
            f"vs CPU {verdict}; {agree}; CPU forward "
            f"{t_cpu:.2f} s")
        del params, on_cpu, card, cpu, batch
        torch.cuda.empty_cache()
    for arch in ZOO_CPU_DECODES:
        cfg = get_config(arch, smoke=True)
        card, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
        params = card.init(2)
        on_cpu = tree_to(params, "cpu")
        B, seq, n_prompt, steps = 2, 64, 8, 48
        prompt = torch.randint(1, cfg.vocab, (B, n_prompt),
                               generator=torch.Generator().manual_seed(2))
        c_card, c_cpu = card.init_caches(B, seq), cpu.init_caches(B, seq)
        routes, worst, token = RouteReplay(), 0.0, prompt[:, :1]
        with torch.inference_mode():
            for t in range(steps):
                with routes.record():
                    l_cpu, c_cpu = cpu.decode_step(on_cpu, token, c_cpu, t)
                with routes.replay():
                    l_card, c_card = card.decode_step(params, token.to(dev),
                                                      c_card, t)
                hold_bf16(l_card, l_cpu, f"{arch} smoke decode step {t}")
                worst = max(worst, float((l_card.float().cpu()
                                          - l_cpu.float()).abs().max()))
                token = (prompt[:, t + 1:t + 2] if t + 1 < n_prompt
                         else l_cpu[:, -1].float().argmax(-1)[:, None])
        agree = routes.check(f"{arch} smoke decode")
        windowed = any(mx in "WL" for mx, _ in cfg.pattern)
        n_cross = sum(mx == "C" for mx, _ in cfg.pattern) * cfg.n_super
        log(f"[zoo-cpu] {arch} smoke ("
            + (f"window {cfg.attn.window}" if windowed else
               f"{n_cross} 'C' blocks on zero cross caches")
            + f"): teacher-forced decode of {steps} tokens, B {B}, {seq}-"
            f"entry caches, "
            f"card vs CPU within the bar at every step (max abs err "
            f"{worst:.4g}); {agree}")
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    mp = moe.init_moe(gen, cfg.d_model, cfg.moe)
    x = torch.randn((ZOO_BATCH, ZOO_SEQ, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    with torch.inference_mode():
        (y0, a0), (y1, a1) = (moe.moe_ffn(mp, x, cfg.moe) for _ in range(2))
    if not (torch.equal(y0, y1) and all(torch.equal(a0[k], a1[k])
                                        for k in a0)):
        raise AssertionError("deepseek-moe-16b MoE layer: two card runs "
                             "differ")
    log(f"[zoo-cpu] deepseek-moe-16b MoE layer at full width (E 64, top 6, "
        f"2 shared, T {ZOO_SEQ}): two card runs torch.equal (output and "
        f"aux; drop_frac {float(a0['drop_frac']):.4f})")


def phase_cells(dev) -> None:
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.stats import summarize
    from repro_torch.nmp.traces import make_trace
    for app, n, tech, mapper, forced in (("SPMV", 2048, "pei", "tom", -1),
                                         ("KM", 384, "pei", "aimm", 5),
                                         ("KM", 384, "bnmp", "aimm", 1),
                                         ("KM", 384, "bnmp", "aimm", 3)):
        tr = make_trace(app, n_ops=n)
        runs = {d: run_episode(tr, NMPConfig(), tech, mapper, seed=2,
                               forced_action=forced, device=d)
                for d in (dev, "cpu")}
        card, cpu = summarize(runs[dev]), summarize(runs["cpu"])
        assert card["ops"] == cpu["ops"] == n, (card["ops"], cpu["ops"])
        for k in ("action", "invoke", "valid", "util"):
            a = runs[dev].metrics[k].cpu()
            if not torch.equal(a, runs["cpu"].metrics[k]):
                raise AssertionError(f"{app}/{n} {tech}/{mapper}: per-epoch "
                                     f"{k} differs between card and CPU")
        for k in ("cycles", "opc"):
            a = runs[dev].metrics[k].cpu().double()
            b = runs["cpu"].metrics[k].double()
            if not torch.allclose(a, b, rtol=1e-5, atol=0):
                raise AssertionError(f"{app}/{n} {tech}/{mapper}: {k} off by "
                                     f"more than rtol 1e-5")
        same = card["cycles"] == cpu["cycles"]
        log(f"[cells] {app}/{n} {tech}/{mapper}/{forced} seed 2: ops "
            f"{card['ops']:.0f}, per-epoch action/invoke/valid/util equal, "
            f"cycles card {card['cycles']!r} cpu {cpu['cycles']!r} "
            f"({'==' if same else 'within rtol 1e-5'})")


def phase_main_path(dev) -> dict[str, int]:
    import math
    import torch
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.threefry import ops as tops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode, run_program
    from repro_torch.nmp.stats import summarize
    from repro_torch.nmp.traces import make_trace
    cfg = NMPConfig()
    tr = make_trace("BP", n_ops=BP_OPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eops.reset_launches()
    qops.reset_launches()
    tops.reset_launches()
    lops.reset_launches()
    t0 = time.perf_counter()
    results = run_program(tr, cfg, "bnmp", "aimm", episodes=2, seed=0,
                          device=dev)
    torch.cuda.synchronize()
    t_prog = time.perf_counter() - t0
    fused_prog = eops.launches["fused_epoch"]
    threefry_prog = tops.launches["threefry"]
    t0 = time.perf_counter()
    tom = run_episode(tr, cfg, "pei", "tom", seed=0, device=dev)
    torch.cuda.synchronize()
    t_tom = time.perf_counter() - t0
    launches = {**eops.launches, **qops.launches, **tops.launches,
                **lops.launches}
    peak = torch.cuda.max_memory_allocated()

    epochs = 0
    for i, res in enumerate(results + [tom]):
        s = summarize(res)
        n_ep = int(res.metrics["valid"].shape[0])
        epochs += n_ep
        assert s["ops"] == BP_OPS, s["ops"]
        assert math.isfinite(s["cycles"]) and s["cycles"] > 0, s["cycles"]
        label = (f"run_program bnmp/aimm episode {i}" if i < len(results)
                 else "run_episode pei/tom")
        log(f"[main] {label}: {n_ep} epochs, ops {s['ops']:.0f}, cycles "
            f"{s['cycles']!r}, OPC {s['opc']!r}, migrations "
            f"{s['migrations']:.0f}")
    agent = results[-1].agent
    log(f"[main] agent after 2 episodes: train_steps "
        f"{int(agent.train_steps[0])}, replay size "
        f"{int(agent.replay.size[0])}")
    log(f"[main] run_program 2 episodes: {t_prog:.3f} s "
        f"({t_prog / 2:.3f} s/episode, {2 * 128 / t_prog:.1f} epochs/s); "
        f"run_episode pei/tom: {t_tom:.3f} s ({128 / t_tom:.1f} epochs/s); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    # by shape: the fused epoch per program (flag set), the qnet per row
    # count (1: act; 64: the TD step's target and online networks), the TOM
    # scorer standalone and folded into the fused epoch launch
    split = {"fused_epoch": dict(launches_bnmp_aimm=fused_prog,
                                 launches_pei=launches["fused_epoch"]
                                 - fused_prog),
             "dueling_qnet": {f"launches_n{n}": c for n, c in
                              sorted(qops.launches_by_rows.items())},
             "tom_scores": dict(
                 launches_standalone=launches["tom_scores"],
                 launches_folded=launches["tom_scores_folded"]),
             "threefry": {f"launches_{m}": c for m, c in
                          sorted(tops.launches_by_mode.items())}}
    log(f"[main] launches: {json.dumps(launches)}; by shape "
        f"{json.dumps(split)}")
    tom_epochs = int(tom.metrics["valid"].shape[0])
    assert launches["fused_epoch"] == epochs, (launches, epochs)
    assert launches["dueling_qnet"] > 0, launches
    assert launches["tom_scores"] == 0, launches
    assert launches["tom_scores_folded"] == tom_epochs, (launches,
                                                         tom_epochs)
    # every random draw of the learned episodes is a threefry launch; the
    # PEI + TOM episode draws nothing
    assert threefry_prog > 0, launches
    assert launches["threefry"] == threefry_prog, launches
    assert launches["batched_linear"] > 0, launches
    rates = {"bnmp/aimm": 2 * 128 / t_prog, "pei/tom": 128 / t_tom}
    # the TOM scorer's count on the main path: its scorings in any form
    launches["tom_scores"] += launches.pop("tom_scores_folded")
    return launches, split, rates


def figure_grid(aimm_episodes: int = GRID_AIMM_EPISODES,
                eval_episode: bool = True,
                mappers: tuple[str, ...] = ("none", "tom", "aimm")):
    """benchmarks/common.py figure_grid at BP_OPS ops with three seeds."""
    from repro_torch.nmp import scenarios
    return scenarios.build("single", apps=GRID_APPS, techniques=GRID_TECHS,
                           mappers=mappers, n_ops=BP_OPS, seeds=GRID_SEEDS,
                           aimm_episodes=aimm_episodes,
                           eval_episode=eval_episode)


def q_gap(dev, sc, cfg, agent, explore: bool, seed: int, at: int):
    """Replay one serial episode of a learned lane on the card up to epoch
    `at` and return the relative top-two Q gap (q1 - q2) / |q1| of the Q
    values the agent's greedy choice at that epoch's invocation is made from
    (after the invocation's TD step), or None if it does not act there."""
    import torch
    from repro_torch.core import dqn
    from repro_torch.nmp import engine as eng
    st = eng.episode_setup(sc.trace, cfg, sc.technique, "aimm", agent, None,
                           seed, sc.page_table, explore, -1, dev)
    env, ag, ctx = st.env, st.agent, st.ctx
    with torch.no_grad():
        for e in range(at):
            env, ag, _ = eng._epoch(env, ag, st.trace, st.rw_pages,
                                    st.tom_cands, ctx, ctx, cfg, st.spec,
                                    st.agent_cfg, st.flags, st.topo)
        win = eng._fetch_window(env.op_ptr, st.trace, ctx, cfg)
        mid = eng._epoch_sim(env, win, st.tom_cands, ctx, cfg, st.spec,
                             st.agent_cfg, st.flags, st.topo)
        if not bool(mid.invoke[0]):
            return None
        acted, _ = eng._invoke_agent(
            ag, mid.svec, mid.reward, mid.invoke, env.prev_state_vec,
            env.prev_action, ctx.explore, mid.invoke,
            env.prev_span_mean >= 0.0, st.agent_cfg)
        q = dqn.q_values_infer(acted.params, mid.svec, st.agent_cfg.dqn)[0]
        top = torch.topk(q, 2).values
        return float((top[0] - top[1]).abs() / top[0].abs().clamp(min=1e-12))


def hold_learned_lane(dev, res, i, sc, cfg) -> str:
    """A learned lane of the grid against its serial run on the card, every
    episode epoch by epoch: the action and invoke flag `==` and OPC within
    rtol 1e-5.  At the first epoch t where they part, the rule of a
    float-order near-tie applies: the two runs' actions must differ at t, t
    must be an invocation, and the serial run's top-two Q gap at that
    invocation must be below 1e-4 relative; anything else fails.  After such
    a flip both runs act on other states, so the lane's later epochs and
    episodes are not compared."""
    import numpy as np
    from repro_torch.nmp.engine import run_episode, run_program
    runs = run_program(sc.trace, cfg, sc.technique, "aimm",
                       episodes=sc.episodes, seed=sc.seed, device=dev)
    runs.append(run_episode(sc.trace, cfg, sc.technique, "aimm",
                            agent=runs[-1].agent, seed=sc.seed,
                            explore=False, device=dev))
    for e, r in enumerate(runs):
        act = r.metrics["action"].cpu().numpy()
        inv = r.metrics["invoke"].cpu().numpy()
        opc = r.metrics["opc"].cpu().numpy().astype(np.float64)
        n = len(act)
        g_act = res.actions[i, e, :n]
        g_inv = res.metrics["invoke_t"][i, e, :n].astype(np.float32)
        g_opc = res.metrics["opc_t"][i, e, :n].astype(np.float64)
        bad = np.flatnonzero((act != g_act) | (inv != g_inv) | ~np.isclose(
            opc, g_opc, rtol=1e-5, atol=0.0))
        if bad.size:
            t = int(bad[0])
            where = f"{sc.name}: grid and serial part at episode {e} epoch {t}"
            if act[t] == g_act[t] or inv[t] == 0 or inv[t] != g_inv[t]:
                raise AssertionError(
                    f"{where} with equal actions there (invoke {inv[t]} / "
                    f"{g_inv[t]}, OPC {opc[t]!r} / {g_opc[t]!r})")
            explore = e < sc.episodes
            gap = q_gap(dev, sc, cfg, runs[e - 1].agent if e else None,
                        explore, sc.seed + e if explore else sc.seed, t)
            if gap is None or not gap < 1e-4:
                raise AssertionError(
                    f"{where}: actions {act[t]} / {g_act[t]} with no near-tie "
                    f"(top-two Q gap {gap!r} relative, bar 1e-4)")
            return (f"== up to episode {e} epoch {t}; the actions part there "
                    f"at a near-tie (top-two Q gap {gap:.3g} relative, below "
                    f"1e-4)")
    same = all(float(r.env.cycles) == float(res.metrics["cycles"][i, e])
               for e, r in enumerate(runs))
    return ("every episode's per-epoch action and invoke ==, OPC "
            "within rtol 1e-5, cycles " + ("==" if same else
                                           "within rtol 1e-5"))


def phase_grid(dev, rates: dict) -> tuple[dict, dict]:
    """The batched engine's main path: `run_grid` over the 135-cell figure
    grid on the paper's Table-1 system, with the kernels' counts set to 0
    just before and read just after; then 6 of its cells through
    `run_grid_serial` on the card, and a profile of one agent group."""
    import math
    import numpy as np
    import torch
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.threefry import ops as tops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.sweep import run_grid, run_grid_serial
    cfg = NMPConfig()
    grid = figure_grid()
    assert len(grid) == 135, len(grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ops in (eops, qops, tops, lops):
        ops.reset_launches()
    t0 = time.perf_counter()
    res = run_grid(grid, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**eops.launches, **qops.launches, **tops.launches,
                **lops.launches}
    shapes = {"fused_epoch": dict(eops.launches_by_shape),
              "dueling_qnet": dict(qops.launches_by_shape),
              "threefry": dict(tops.launches_by_shape),
              "batched_linear": dict(lops.launches_by_shape)}
    peak = torch.cuda.max_memory_allocated()
    for k in ("fused_epoch", "dueling_qnet", "threefry", "batched_linear",
              "tom_scores_folded"):
        if not launches[k] > 0:
            raise AssertionError(f"run_grid launched no {k}: {launches}")
    assert launches["tom_scores"] == 0, launches
    m = res.metrics
    delivered = 0
    for i, sc in enumerate(grid):
        for e in range(sc.total_episodes):
            s = res.episode_summary(i, e)
            assert s["ops"] == BP_OPS, (sc.name, e, s["ops"])
            assert math.isfinite(s["cycles"]) and s["cycles"] > 0, sc.name
        delivered += int((m["valid_t"][i, :sc.total_episodes] > 0).sum())
    simulated = res.plan.n_epochs * sum(g.n_lanes * g.n_seeds * g.n_episodes
                                        for g in res.plan.groups)
    groups = [(g.n_lanes, g.n_seeds, g.n_episodes,
               "share" if g.flags.share_seed_inv else "fused")
              for g in res.plan.groups]
    log(f"[grid] figure grid: {len(grid)} cells ({', '.join(GRID_APPS)} x "
        f"{'/'.join(GRID_TECHS)} x none/tom/aimm x seeds {GRID_SEEDS}), "
        f"groups (lanes, seeds, episodes, stages) {groups}")
    log(f"[grid] run_grid wall {wall:.3f} s; delivered cell-epochs "
        f"{delivered} ({delivered / wall:.1f}/s), simulated cell-epochs "
        f"{simulated} ({simulated / wall:.1f}/s); single-episode epochs/s "
        f"this call: learned AIMM {rates['bnmp/aimm']:.1f}, PEI + TOM "
        f"{rates['pei/tom']:.1f}; peak device memory {peak / 2**20:.1f} MiB")
    log(f"[grid] launches: {json.dumps(launches)}")
    log(f"[grid] launches by shape: {json.dumps(shapes)}")
    for i, sc in enumerate(grid[:3]):
        log(f"[grid] {sc.name}: cycles {res.summary(i)['cycles']!r}, OPC "
            f"{res.summary(i)['opc']!r}")

    # six cells again through the serial runner, on the card
    names = [f"{a}/{t}/{mp}/s0" for a, t in (("BP", "bnmp"), ("SPMV", "pei"))
             for mp in ("none", "tom", "aimm")]
    for name in names:
        i = next(j for j, sc in enumerate(grid) if sc.name == name)
        sc = grid[i]
        if sc.mapper == "aimm":
            verdict = hold_learned_lane(dev, res, i, sc, cfg)
        else:
            want = run_grid_serial([sc], cfg, device=dev)[0]
            got = res.summary(i)
            for k in ("cycles", "ops", "opc"):
                if got[k] != want[k]:
                    raise AssertionError(f"{name}: run_grid {k} {got[k]!r} "
                                         f"!= serial {want[k]!r}")
            verdict = f"cycles, ops and OPC == ({got['cycles']!r})"
        log(f"[grid] {name} against run_grid_serial on the card: {verdict}")

    # profile one agent group's epoch loop: the 45 learned cells, 1 episode
    sub = figure_grid(aimm_episodes=1, eval_episode=False,
                      mappers=("aimm",))
    run_grid(sub, cfg, device=dev)                 # warm
    pwall, rows = profiled(lambda: run_grid(sub, cfg, device=dev))
    dev_us = sum(r[0] for r in rows)
    n_kern = sum(r[1] for r in rows)
    log(f"[grid-profile] {len(sub)} learned cells (one group, B = "
        f"{len(sub)}), {BP_OPS // W} epochs: wall {pwall * 1e3:.1f} ms "
        f"(profiler on), device kernels {dev_us / 1e3:.2f} ms in {n_kern} "
        f"launches, busy share {dev_us / 1e6 / pwall:.4f}, "
        f"{n_kern / (BP_OPS // W):.1f} launches/epoch")
    for us, cnt, key in rows[:8]:
        log(f"[grid-profile]   {us / 1e3:8.3f} ms {cnt:6d}x  {key[:90]}")
    launches["tom_scores"] += launches.pop("tom_scores_folded")
    return launches, shapes


# ---------------------------------------------------------------------------
# Continual learning, serving and fault drills (the continual layer's paths)
# ---------------------------------------------------------------------------

# bench_continual.py's switch stream at its full size: KM -> KM+SC -> SC,
# bnmp, a baseline lane and a learned lane with lineage "stream"
STREAM_N_OPS = 4096
STREAM_EPISODES = 5
# bench_serving.py's full fleet
FLEET_TENANTS = 96
FLEET_SLOTS = 16
FLEET_PHASES = 3
FLEET_N_OPS = 1024
FLEET_CAPACITY = 48
FLEET_SPOT = ("t000", "t031", "t063", "t095")
# the fault drills' small fleet
DRILL_TENANTS = 3
DRILL_N_OPS = 1024


def aimm_kernel_ops():
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.threefry import ops as tops
    return eops, qops, tops, lops


def reset_aimm_launches() -> None:
    for ops in aimm_kernel_ops():
        ops.reset_launches()


def aimm_launches() -> dict[str, int]:
    launches = {}
    for ops in aimm_kernel_ops():
        launches.update(ops.launches)
    # the TOM scorer's count: its scorings in any form
    launches["tom_scores"] += launches.pop("tom_scores_folded")
    return launches


def simulated_epochs(res) -> int:
    """Cell-epochs one run_grid simulated (padding cells included)."""
    return res.plan.n_epochs * sum(g.n_lanes * g.n_seeds * g.n_episodes
                                   for g in res.plan.groups)


def same_results(a, b) -> bool:
    """Two SweepResults' metrics and per-epoch actions equal, dtype too."""
    import numpy as np
    return (set(a.metrics) == set(b.metrics)
            and all(a.metrics[k].dtype == b.metrics[k].dtype
                    and np.array_equal(a.metrics[k], b.metrics[k])
                    for k in a.metrics)
            and np.array_equal(a.actions, b.actions))


def same_snapshot(a, b) -> bool:
    import numpy as np
    from repro_torch.train.checkpoint import leaf_paths
    la, lb = leaf_paths(a), leaf_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and np.array_equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def phase_continual(dev) -> dict[str, int]:
    """The switch stream through `run_stream` on the card with a checkpoint
    after every phase, counts set to 0 just before and read just after; then
    the kill-and-resume drill (step 0 restored into a fresh store, phases
    1-2 run again) and the stream as chained `run_grid(store=)` calls, both
    `==` to the uninterrupted run in every metric and stored leaf."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import PolicyStore, run_stream
    from repro_torch.nmp.engine import default_agent_cfg
    from repro_torch.nmp.scenarios import continual_stream
    from repro_torch.nmp.sweep import run_grid
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = NMPConfig()
    stream = continual_stream(n_ops_per_app=STREAM_N_OPS,
                              episodes=STREAM_EPISODES, technique="bnmp")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck_",
                                     dir=ROOT / "build") as ck:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_aimm_launches()
        t0 = time.perf_counter()
        full = run_stream(stream, cfg, checkpoint_dir=ck, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = aimm_launches()
        peak = torch.cuda.max_memory_allocated()
        for k in ("fused_epoch", "dueling_qnet", "threefry",
                  "batched_linear"):
            if not launches[k] > 0:
                raise AssertionError(f"run_stream launched no {k}: "
                                     f"{launches}")
        assert CheckpointManager(ck).all_steps() == [0, 1, 2]
        store = full.store
        log(f"[continual] switch stream (KM -> KM+SC -> SC, "
            f"{STREAM_N_OPS} ops per app, {STREAM_EPISODES} episodes, "
            f"bnmp, baseline + aimm lineage 'stream'): {wall:.3f} s with a "
            f"checkpoint after every phase; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        for pi, res in enumerate(full.phases):
            n = simulated_epochs(res)
            lane = next(i for i, sc in enumerate(res.scenarios)
                        if sc.mapper == "aimm")
            s = res.summary(lane)
            assert s["ops"] == res.scenarios[lane].trace.n_ops, s["ops"]
            assert np.isfinite(res.metrics["opc_t"]).all()
            log(f"[continual] phase {pi} {res.scenarios[lane].name}: wall "
                f"{res.wall_s:.3f} s, {n} cell-epochs ({n / res.wall_s:.1f}"
                f"/s), last-episode OPC {s['opc']!r} (baseline "
                f"{res.summary(1 - lane)['opc']!r}), invocations "
                f"{res.invocations(lane)}")
        meta = store.meta["stream"]
        log(f"[continual] store: tags {store.tags}, version "
            f"{store.version('stream')}, phases {meta['phases']}, "
            f"global_step {meta['global_step']}, train_steps "
            f"{meta['train_steps']}")
        log(f"[continual] launches: {json.dumps(launches)}")
        assert store.version("stream") == 3 and meta["train_steps"] > 0

        acfg = default_agent_cfg(cfg)
        resumed_store = PolicyStore.restore(ck, acfg, step=0)
        t0 = time.perf_counter()
        resumed = run_stream(stream[1:], cfg, store=resumed_store,
                             checkpoint_dir=ck, device=dev)
        t_res = time.perf_counter() - t0
        for pi, res in enumerate(resumed.phases):
            if not same_results(res, full.phases[pi + 1]):
                raise AssertionError(f"resumed phase {pi + 1} differs from "
                                     "the uninterrupted run")
        if not same_snapshot(resumed.store.get("stream"),
                             store.get("stream")):
            raise AssertionError("resumed store differs from the "
                                 "uninterrupted run's")
        if not same_snapshot(PolicyStore.restore(ck, acfg).get("stream"),
                             store.get("stream")):
            raise AssertionError("rewritten step 2 differs")
    log(f"[continual] kill-and-resume: step 0 restored into a fresh store, "
        f"phases 1-2 in {t_res:.3f} s: every metric, per-epoch action and "
        f"stored leaf == the uninterrupted run")
    chained = PolicyStore()
    for pi, phase in enumerate(stream):
        res = run_grid(phase, cfg, store=chained, device=dev)
        if not same_results(res, full.phases[pi]):
            raise AssertionError(f"chained run_grid phase {pi} differs from "
                                 "run_stream")
    if not same_snapshot(chained.get("stream"), store.get("stream")):
        raise AssertionError("chained run_grid store differs")
    log("[continual] chained run_grid(store=) calls: every metric, "
        "per-epoch action and stored leaf == run_stream")
    return launches


def solo_near_tie(dev, cfg, tid, stream, pi, e, t) -> float | None:
    """The relative top-two Q gap at epoch t of episode e of phase pi of a
    tenant's solo stream on the card (the agent replayed to the start of
    that episode), or None if the agent does not act there."""
    from repro_torch.nmp.continual import run_stream
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.serving import solo_stream
    solo = solo_stream(tid, stream)
    agent = None
    if pi:
        agent = run_stream(solo[:pi], cfg, device=dev).store.checkout(tid,
                                                                      dev)
    sc = solo[pi][0]
    for ep in range(e):
        agent = run_episode(sc.trace, cfg, sc.technique, "aimm", agent=agent,
                            seed=sc.seed + ep, page_table=sc.page_table,
                            device=dev).agent
    return q_gap(dev, sc, cfg, agent, True, sc.seed + e, t)


def hold_tenant(dev, cfg, srv, tid, stream) -> str:
    """A served tenant against its solo stream on the card, phase by phase
    and epoch by epoch: action and invoke `==`, OPC within rtol 1e-5, up to
    a float-order near-tie (hold_learned_lane's rule), after which the
    tenant's later epochs are not compared."""
    import numpy as np
    from repro_torch.nmp.continual import run_stream
    from repro_torch.nmp.serving import solo_stream
    solo = run_stream(solo_stream(tid, stream), cfg, device=dev)
    same = True
    for pi in range(len(stream)):
        res, lane = srv.tenant(tid).results[pi]
        want = solo.phases[pi]
        for e in range(want.n_episodes):
            act, g_act = want.actions[0, e], res.actions[lane, e]
            inv = want.metrics["invoke_t"][0, e]
            g_inv = res.metrics["invoke_t"][lane, e]
            opc = want.metrics["opc_t"][0, e].astype(np.float64)
            g_opc = res.metrics["opc_t"][lane, e].astype(np.float64)
            bad = np.flatnonzero((act != g_act) | (inv != g_inv) | ~np.isclose(
                opc, g_opc, rtol=1e-5, atol=0.0))
            if bad.size:
                t = int(bad[0])
                where = (f"{tid}: served and solo part at phase {pi} "
                         f"episode {e} epoch {t}")
                if act[t] == g_act[t] or inv[t] == 0 or inv[t] != g_inv[t]:
                    raise AssertionError(f"{where} with equal actions there")
                gap = solo_near_tie(dev, cfg, tid, stream, pi, e, t)
                if gap is None or not gap < 1e-4:
                    raise AssertionError(f"{where}: no near-tie (top-two Q "
                                         f"gap {gap!r} relative, bar 1e-4)")
                return (f"== up to phase {pi} episode {e} epoch {t}; a "
                        f"near-tie there (gap {gap:.3g})")
        same &= all(np.array_equal(res.metrics[k][lane], want.metrics[k][0])
                    for k in want.metrics)
    return ("per-epoch action and invoke ==, OPC within rtol 1e-5, every "
            "metric " + ("==" if same else "within that bar"))


def phase_serving(dev) -> dict[str, int]:
    """bench_serving.py's full fleet through the MappingServer on the card,
    counts set to 0 just before and read just after; then 4 tenants against
    their solo streams on the card."""
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.scenarios import tenant_fleet
    from repro_torch.nmp.serving import MappingServer
    cfg = NMPConfig()
    fleet = tenant_fleet(n_tenants=FLEET_TENANTS, n_phases=FLEET_PHASES,
                         n_ops_per_app=FLEET_N_OPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_aimm_launches()
    t0 = time.perf_counter()
    srv = MappingServer(cfg, n_slots=FLEET_SLOTS,
                        store_capacity=FLEET_CAPACITY, device=dev)
    for tid, stream in fleet.items():
        srv.submit(tid, stream)
    attempts = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = aimm_launches()
    peak = torch.cuda.max_memory_allocated()
    st = srv.stats()
    for k in ("fused_epoch", "dueling_qnet", "threefry", "batched_linear"):
        if not launches[k] > 0:
            raise AssertionError(f"serving launched no {k}: {launches}")
    if st["tenants_done"] != FLEET_TENANTS or st["phases_served"] != (
            FLEET_TENANTS * FLEET_PHASES):
        raise AssertionError(f"fleet not drained: {st}")
    if st["recompiles_after_first_tick"] != 0:
        raise AssertionError(f"new dispatch signatures after the first "
                             f"tick: {st['recompiles_after_first_tick']}")
    log(f"[serving] {FLEET_TENANTS} tenants x {FLEET_PHASES} phases "
        f"({FLEET_N_OPS} ops per app, 1 episode), {st['n_slots']} slots, "
        f"store capacity {FLEET_CAPACITY}: {wall:.3f} s wall, {st['ticks']} "
        f"ticks ({attempts} dispatch attempts), steady-state epochs/s "
        f"{st['steady_epochs_per_sec']!r}, phase latency p50 "
        f"{st['phase_latency_p50_s']!r} s p99 {st['phase_latency_p99_s']!r} "
        f"s, compile_s {st['compile_s']!r} (ticks of a new signature), "
        f"recompiles after the first tick {st['recompiles_after_first_tick']}"
        f", evictions {st['store']['evictions']}, slot occupancy "
        f"{st['slot_occupancy']!r}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[serving] launches: {json.dumps(launches)}")
    for tid in FLEET_SPOT:
        verdict = hold_tenant(dev, cfg, srv, tid, fleet[tid])
        log(f"[serving] {tid} against solo_stream on the card: {verdict}")
    return launches


def phase_faults(dev) -> dict[str, int]:
    """The fault drills on a small fleet on the card, each against the same
    fleet served fault-free on the same shapes: a poisoned warm agent, the
    store poison with rollback, attributed failures up to quarantine, and a
    stall over the deadline.  Every healthy tenant `==` to the fault-free
    run (metrics and per-epoch actions)."""
    import numpy as np
    from repro_torch.nmp import faults
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.faults import FaultEvent, FaultPlan
    from repro_torch.nmp.scenarios import tenant_fleet, tenant_stream
    from repro_torch.nmp.serving import MappingServer
    cfg = NMPConfig()
    reset_aimm_launches()

    def serve(fleet, **kw):
        srv = MappingServer(cfg, n_slots=2, backoff_base_s=0.001,
                            device=dev, **kw)
        for tid, stream in fleet.items():
            srv.submit(tid, stream)
        srv.run()
        return srv

    def same_tenant(srv, ref, tid, phases=None, ref_phases=None):
        phases = phases or range(len(ref.tenant(tid).results))
        ref_phases = ref_phases or phases
        for pi, rpi in zip(phases, ref_phases):
            (res, lane), (want, wl) = (srv.tenant(tid).results[pi],
                                       ref.tenant(tid).results[rpi])
            for k in want.metrics:
                if not np.array_equal(res.metrics[k][lane],
                                      want.metrics[k][wl]):
                    raise AssertionError(f"{tid} phase {pi}: {k} differs "
                                         "from the fault-free run")
            if not np.array_equal(res.actions[lane], want.actions[wl]):
                raise AssertionError(f"{tid} phase {pi}: actions differ")

    fleet = tenant_fleet(n_tenants=DRILL_TENANTS, apps=("KM", "SC"),
                         n_phases=2, n_ops_per_app=DRILL_N_OPS)
    clean = serve(fleet)
    p50 = clean.stats()["phase_latency_p50_s"]

    srv = serve(fleet, faults=FaultPlan([FaultEvent("poison_agent", at=1,
                                                    tenant="t001")]))
    st = srv.stats()["faults"]
    assert st["divergences"] >= 1 and st["quarantines"] == 0, st
    for tid in fleet:
        same_tenant(srv, clean, tid)
    log(f"[faults] poisoned warm agent (t001 at attempt 1): divergences "
        f"{st['divergences']}, retries {st['retries']}; every tenant == the "
        "fault-free run")

    srv = serve(fleet, max_phase_retries=1, faults=FaultPlan(
        [FaultEvent("fail_tick", at=i, tenant="t000") for i in range(10)]))
    st = srv.stats()
    assert srv.tenant("t000").quarantined, st
    assert st["faults"]["quarantines"] == 1, st
    for tid in ("t001", "t002"):
        same_tenant(srv, clean, tid)
    log(f"[faults] fail_tick on t000 (max_phase_retries 1): quarantined "
        f"after {st['faults']['tick_failures']} failed attempts; t001, t002 "
        "== the fault-free run")

    stream = tenant_stream(apps=("KM", "SC"), n_phases=3,
                           n_ops_per_app=DRILL_N_OPS)
    clean3 = serve({"t": stream})
    rolled = serve({"t": [stream[0], stream[2]]})
    srv = MappingServer(cfg, n_slots=2, backoff_base_s=0.001, device=dev)
    srv.submit("t", stream)
    srv.tick()
    srv.tick()
    faults.poison_store_agent(srv.store, "t")
    srv.run()
    st = srv.stats()["faults"]
    assert st["rollbacks"] >= 1 and srv.tenant("t").done, st
    same_tenant(srv, clean3, "t", phases=(0, 1))
    same_tenant(srv, rolled, "t", phases=(2,), ref_phases=(1,))
    log(f"[faults] store poison after phase 1: divergences "
        f"{st['divergences']}, rollbacks {st['rollbacks']}; phases 0-1 == "
        "the fault-free run, phase 2 == a run of phase 2 right after phase "
        "0")

    deadline = max(4 * p50, 0.5)
    srv = serve(fleet, phase_deadline_s=deadline, faults=FaultPlan(
        [FaultEvent("stall_tick", at=0, tenant="t000",
                    stall_s=2.5 * deadline)]))
    st = srv.stats()["faults"]
    assert st["deadline_misses"] >= 1 and st["retries"] >= 1, st
    for tid in fleet:
        same_tenant(srv, clean, tid)
    launches = aimm_launches()
    log(f"[faults] stall of {2.5 * deadline:.3f} s on t000 (deadline "
        f"{deadline:.3f} s): deadline misses {st['deadline_misses']}, retries "
        f"{st['retries']}; every tenant == the fault-free run")
    log(f"[faults] launches: {json.dumps(launches)}")
    return launches


def profiled(fn):
    """Run fn() under torch.profiler, tracing the device alone (the busy
    share and the kernel table need no host-op events, and recording and
    collecting them slows the host); returns (wall s with the profiler
    on, [(device us, launches, kernel name)] by kernel).  Fails if the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((us, e.count, e.key))
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    return wall, sorted(rows, reverse=True)


def phase_profile(dev) -> None:
    """torch.profiler over one warm BP/16384 episode of each main-path
    program (after the main path was timed, so the profiler's host cost
    does not touch those times); device busy share = summed kernel time /
    wall time.  Fails if the profiler saw no device time."""
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.traces import make_trace
    tr = make_trace("BP", n_ops=BP_OPS)
    for tech, mapper in (("bnmp", "aimm"), ("pei", "tom")):
        warm = run_episode(tr, NMPConfig(), tech, mapper, seed=0, device=dev)
        wall, rows = profiled(lambda: run_episode(
            tr, NMPConfig(), tech, mapper, agent=warm.agent, seed=1,
            device=dev))
        dev_us = sum(r[0] for r in rows)
        n_kern = sum(r[1] for r in rows)
        log(f"[profile] BP/{BP_OPS} {tech}/{mapper}, 128 epochs: wall "
            f"{wall * 1e3:.1f} ms (profiler on), device kernels "
            f"{dev_us / 1e3:.2f} ms in {n_kern} launches, busy share "
            f"{dev_us / 1e6 / wall:.4f}, {n_kern / 128:.1f} launches/epoch")
        for us, cnt, key in rows[:8]:
            log(f"[profile]   {us / 1e3:8.3f} ms {cnt:6d}x  {key[:90]}")
        for us, cnt, key in rows:   # the AIMM kernels, wherever they rank
            if any(k in key for k in ("fused_epoch_kernel", "tom_scores_kernel",
                                      "dueling_qnet_kernel")):
                log(f"[profile]   port kernel {us / 1e3:8.3f} ms {cnt:6d}x "
                    f"({us / cnt:.2f} us each)  {key[:70]}")


def phase_zoo_profile(dev) -> None:
    """torch.profiler over one warm prefill forward (B 1, S 4096; whisper
    448 tokens over 1500 frames) and one serving loop of each of
    ZOO_ARCHS, after their timed runs: device busy share, launches, and
    the top kernels by device time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    for arch in ZOO_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg, dev)
        params = model.init(0)
        batch = zoo_batch(dev, cfg, WHISPER_TOKENS if cfg.encoder is not None
                          else ZOO_SEQ)
        prefill = lambda: model.logits(params, model.apply(params, batch)[0])
        with torch.inference_mode():
            prefill()
            runs = (("prefill", profiled(prefill)),
                    ("serve", profiled(lambda: serve(cfg, params=params,
                                                     device=dev))))
        for what, (wall, rows) in runs:
            dev_us = sum(r[0] for r in rows)
            log(f"[zoo-profile] {arch} {what}: wall {wall * 1e3:.1f} ms "
                f"(profiler on), device kernels {dev_us / 1e3:.2f} ms in "
                f"{sum(r[1] for r in rows)} launches, busy share "
                f"{dev_us / 1e6 / wall:.4f}")
            for us, cnt, key in rows[:6]:
                log(f"[zoo-profile]   {us / 1e3:8.3f} ms {cnt:6d}x "
                    f"({100 * us / dev_us:4.1f}%)  {key[:80]}")
        del params, model, batch
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training (the LM training path of launch/train.py and its backward
# kernels)
# ---------------------------------------------------------------------------

# The training cells: minitron-8b at full width with its depth cut from 32
# to 4 layers (the training state of 32 layers, ~119 GB, exceeds the card),
# mamba2-370m at full width and depth; both at S 4096, global batch 2 in 2
# microbatches, 4 steps with a checkpoint every 2 and a node failure
# injected before step 3 (the loop resumes at the step-2 checkpoint, so step
# 2 runs twice: the replay must give the first run's loss, and the state
# read back must be `torch.equal` to the state that was saved).
# minitron-8b keeps int8 moments (`--quantized-opt`): with f32 moments its
# checkpoint is 29 GB, whose writes and read take minutes on the local
# disk of a one-H100 machine (`train_restart_probe.py` runs that restart
# and times them), over this run's time budget; int8 moments make it
# ~12 GB.  (arch, layers or None, quantized optimizer)
TRAIN_RUNS = (("minitron-8b", 4, True), ("mamba2-370m", None, False))
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 4
TRAIN_FAIL_AT = 3
# card vs CPU, one step's loss and gradients (no optimizer step): the
# [zoo-cpu] depth, B 1, S 256
TRAIN_CPU_RUNS = (("minitron-8b", 2, 256), ("mamba2-370m", 2, 256))


def _flash_bwd_inputs(dev, dtype, seed: int = 0):
    """q, k, v and an output cotangent at minitron-8b's attention shape."""
    import torch
    q, k, v = flash_inputs(dev, dtype, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _kernel_grads(fn, xs, dy):
    """torch.autograd.grad of fn(*xs) with cotangent dy, the inputs
    detached and requiring grad (the card's path: the backward kernels)."""
    import torch
    xs = [t.detach().requires_grad_() for t in xs]
    return torch.autograd.grad(fn(*xs), xs, dy)


def phase_train_kernels(dev) -> list[dict]:
    """The backward kernels (kernel rows 8 and 9) against autograd through
    their plain versions on the same card inputs: flash attention's at
    minitron-8b's shape (B 1, S 4096, H 32, K 8, hd 128), in f32 and bf16
    within `GRAD_BARS` (flash_attention/ref.py), the SSD scan's at
    mamba2-370m's (chunk 256), both decay cases, within 1e-4 relative L2
    per gradient; two runs torch.equal; device time per launch from a CUDA
    graph beside the bound, the plain version (autograd's forward plus
    backward less its forward, CUDA events) and, for flash, SDPA's backward
    (flash backend, timed alike); the variants not ported raise."""
    from contextlib import nullcontext
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, attention_ref, compare_grad)
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_grads_ref
    results = []

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # ---- flash attention backward ----
    a = get_config("minitron-8b").attn
    H, K, hd, S = a.n_heads, a.n_kv, a.head_dim, ZOO_SEQ
    scale = hd ** -0.5
    flash = lambda q, k, v: fops.gqa_flash_attention_kv(q, k, v, causal=True)
    frec = {}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, do = _flash_bwd_inputs(dev, dtype)
        before = fops.launches["flash_attention_bwd"]
        runs = [_kernel_grads(flash, (q, k, v), do) for _ in range(2)]
        torch.cuda.synchronize()
        if fops.launches["flash_attention_bwd"] != before + 2:
            raise AssertionError(f"flash backward {label}: launches "
                                 f"{fops.launches}")
        if not all_equal(runs[0], runs[1]):
            raise AssertionError(f"flash backward {label}: two card runs "
                                 f"differ")
        _, *want = attention_grads_ref(q, k, v, do)
        cmps = {n: compare_grad(g, w) for n, g, w in
                zip(("dq", "dk", "dv"), runs[0], want)}
        if not all(c["ok"] for c in cmps.values()):
            raise AssertionError(f"flash backward {label} beyond "
                                 f"{GRAD_BARS[dtype]}: {cmps}")
        del runs, want
        lse = torch.empty((1, H, S), dtype=torch.float32, device=dev)
        o = fops._forward(q, k, v, scale, True, 0, lse)
        k_ms = graph_ms(lambda: fops.flash_backward(q, k, v, o, lse, do,
                                                    scale), 5)

        def plain_fb():
            attention_grads_ref(q, k, v, do)

        def plain_f():
            kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
            attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                          vv.transpose(1, 2))
        p_ms = event_ms(plain_fb, 2) - event_ms(plain_f, 2)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)
        # SDPA's flash backend for bf16; torch's own choice for f32, which
        # the flash backend does not take
        backend = lambda: (sdpa_kernel(SDPBackend.FLASH_ATTENTION)
                           if dtype == torch.bfloat16 else nullcontext())

        def sdpa_fb():
            with backend():
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True,
                                                     enable_gqa=True)
                torch.autograd.grad(out, (qt, kt, vt), dot)

        def sdpa_f():
            with backend(), torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        lib_ms = event_ms(sdpa_fb, 5) - event_ms(sdpa_f, 5)
        lib = ("SDPA backward, flash backend" if dtype == torch.bfloat16
               else "SDPA backward, default backend")
        pairs = H * visible_pairs(S, 0)
        flops = 2.5 * 4 * hd * pairs        # 2.5 x the forward's products
        nbytes = nb(q, k, v, o, do, lse) + nb(q, k, v)   # + dq, dk, dv
        b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S if
                           dtype == torch.bfloat16 else F32_OPS_PER_S)
        err = max(c["max_abs_err"] for c in cmps.values())
        log(f"[train-kernels] flash_attention_bwd {label}: B=1 S={S} H={H} "
            f"K={K} hd={hd} causal: "
            + ", ".join(f"{n} max abs err {c['max_abs_err']:.3g} rel L2 "
                        f"{c['rel_l2']:.3g}" for n, c in cmps.items())
            + f" (bars {GRAD_BARS[dtype]}); two runs torch.equal; kernel "
            f"{k_ms:.4f} ms/launch (graph), plain {p_ms:.4f} ms, {lib} "
            f"{lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {flops:.4g} FLOP; "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s)")
        frec[label] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                           library=lib)
        del q, k, v, do, o, lse, qt, kt, vt
        torch.cuda.empty_cache()
    # the variants not ported: the forward runs, the backward raises
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for what, kw, d, skv in (("window", dict(window=64), 128, 200),
                             ("non-causal", dict(causal=False), 128, 200),
                             ("S_kv != S", dict(causal=False), 64, 300),
                             ("hd 32", {}, 32, 200), ("hd 16", {}, 16, 200),
                             ("hd 256", {}, 256, 200)):
        q = torch.randn((1, 200, 4, d), generator=gen, device=dev).bfloat16()
        kv = torch.randn((1, skv, 2, d), generator=gen, device=dev
                         ).bfloat16()
        q.requires_grad_()
        out = fops.gqa_flash_attention_kv(q, kv, kv, **kw)
        try:
            out.sum().backward()
        except NotImplementedError:
            continue
        raise AssertionError(f"flash backward {what}: did not raise")
    log("[train-kernels] flash backward of a window, non-causal, S_kv != S,"
        " hd 32, 16 and 256: each forward ran, each backward raised "
        "NotImplementedError")
    results.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: XLA's autodiff of src/repro/models/attention.py:83 "
                 "attend / :92 attend_chunked (jax.value_and_grad, "
                 "src/repro/train/train_step.py:541)",
        **frec["bf16"], f32={k: v for k, v in frec["f32"].items()}))

    # ---- SSD scan backward ----
    cfg = get_config("mamba2-370m")
    Q = cfg.ssm.chunk
    err = 0.0
    for carry in (False, True):
        xs = ssd_inputs(dev, carry)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        dy = torch.randn(xs[0].shape, generator=gen, device=dev)
        before = sops.launches["ssd_scan_bwd"]
        runs = [_kernel_grads(lambda *t: sops.ssd(*t, chunk=Q), xs, dy)
                for _ in range(2)]
        torch.cuda.synchronize()
        if sops.launches["ssd_scan_bwd"] != before + 2:
            raise AssertionError(f"ssd backward: launches {sops.launches}")
        if not all_equal(runs[0], runs[1]):
            raise AssertionError(f"ssd backward (carry {carry}): two card "
                                 f"runs differ")
        want = ssd_grads_ref(*xs, dy, chunk=Q)
        rels = {n: float((g - w).norm() / w.norm()) for n, g, w in
                zip(("dx", "db", "dc", "ddt", "da"), runs[0], want)}
        if max(rels.values()) > 1e-4:
            raise AssertionError(f"ssd backward (carry {carry}) beyond 1e-4 "
                                 f"relative L2: {rels}")
        e = max_abs_err(runs[0], want)
        err = max(err, e)
        log(f"[train-kernels] ssd_scan_bwd carry={carry}: relative L2 "
            + ", ".join(f"{n} {r:.3g}" for n, r in rels.items())
            + f" (bar 1e-4), max abs err {e:.3g}; two runs torch.equal")
        del runs, want
    xf = [t.contiguous() for t in xs]
    y, states, seg_end, seg, cb = sops._forward(xf, Q)
    k_ms = graph_ms(lambda: sops.ssd_backward(xf, dy, states, seg_end, seg,
                                              cb, Q), 10)
    p_ms = (event_ms(lambda: ssd_grads_ref(*xs, dy, chunk=Q), 2)
            - event_ms(lambda: ssd_chunked(*xs, chunk=Q), 2))
    Bz, L, Hs, P = xs[0].shape
    N = xs[1].shape[-1]
    nc = L // Q
    # multiply-adds, from the kernels' loops at these shapes: the reverse
    # state T_c (chunks 1..), per head the inter term's C R and the state's
    # B G (chunks but the first / the last), M = dy x^T and (CB E dt)^T dy
    # over the causal half, the head-summed dC / dB state terms again per
    # head, and dCB's two products over the causal half
    half = Q * (Q + 1) // 2
    macs = Bz * (5 * (nc - 1) * Hs * Q * N * P + 2 * Hs * nc * half * P
                 + 2 * nc * half * N)
    flops = 2 * macs
    moved = nb(*xs, dy, states, seg_end, seg, cb) + nb(*xs)
    f_ms, f_by = bound(moved, flops)
    t_ms, t_by = bound(moved, 3 * flops, TF32_OPS_PER_S)
    b_ms, b_by = min((f_ms, f_by), (t_ms, t_by))
    log(f"[train-kernels] ssd_scan_bwd B={Bz} L={L} H={Hs} P={P} N={N} "
        f"chunk={Q}: kernel {k_ms:.4f} ms/launch (graph), plain {p_ms:.4f} "
        f"ms, bound {f_ms:.4f} ms on f32 CUDA cores ({f_by}), {t_ms:.4f} ms "
        f"as 3xTF32 ({t_by}), {flops:.4g} FLOP, {moved} B; "
        f"{flops / k_ms / 1e9:.1f} TFLOP/s")
    results.append(dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="none: XLA's autodiff of src/repro/models/mamba.py:104 "
                 "chunk_step (jax.value_and_grad, "
                 "src/repro/train/train_step.py:541)",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    return results


@contextlib.contextmanager
def restore_spy():
    """Within the block, `train_loop`'s first checkpoint also keeps a host
    copy of the params and optimizer state it saves, in the port's layout,
    and each restore, once it has copied the checkpoint into the state's
    tensors, appends whether they are `torch.equal` to that copy to the
    list yielded (the check runs through both layout conversions, the disk
    and the copy back onto the device)."""
    import torch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.train import loop
    to_disk, load_into = loop._to_disk, loop._load_into
    saved, results = [], []

    def spy_to_disk(model_cfg, params, opt_state):
        if not saved:
            saved.append(tree_leaves(tree_map(
                lambda t: t.detach().to("cpu", copy=True),
                [params, opt_state])))
        return to_disk(model_cfg, params, opt_state)

    def spy_load_into(params, opt_state, tree):
        load_into(params, opt_state, tree)
        got = tree_leaves([params, opt_state])
        results.append(bool(saved) and len(got) == len(saved[0]) and all(
            torch.equal(g, w.to(g.device)) for g, w in zip(got, saved[0])))

    loop._to_disk, loop._load_into = spy_to_disk, spy_load_into
    try:
        yield results
    finally:
        loop._to_disk, loop._load_into = to_disk, load_into


def phase_train(dev) -> tuple[dict[str, int], dict]:
    """The training main path (TRAIN_RUNS) through launch/train.py's
    `train`: 4 steps with the restart drill, the kernels' counts set to 0
    just before each arch and read just after.  Each step must launch the
    arch's kernel exactly n_layers x microbatches times forward and as
    often backward, the losses must be finite, the params and optimizer
    state read back at the restart `torch.equal` to those saved at step 2
    (`restore_spy`) and the replayed step's loss the first run's.  Then one more step under torch.profiler (busy share,
    top kernels).  Returns the counts over the phase and the per-arch
    numbers."""
    import shutil
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.train import train
    from repro_torch.models.model import (build_model, count_params,
                                          model_flops)
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_train_step
    ckpt_root = ROOT / "build" / "train_ckpt"
    total = {}
    by_arch = {}
    log(f"[train] cells: S {TRAIN_SEQ}, global batch {TRAIN_BATCH} in "
        f"{TRAIN_MICROBATCHES} microbatches, {TRAIN_STEPS} steps, a "
        f"checkpoint every 2, a node failure injected before step "
        f"{TRAIN_FAIL_AT}; AdamW (lr 1e-3, weight decay 0.01, clip 1.0), "
        f"int8 moments where marked")
    for arch, layers, quantized in TRAIN_RUNS:
        shutil.rmtree(ckpt_root / arch, ignore_errors=True)
        reset_zoo_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with restore_spy() as restored:
            res = train(arch, steps=TRAIN_STEPS, seq=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH,
                        microbatches=TRAIN_MICROBATCHES, device=str(dev),
                        layers=layers, fail_at=(TRAIN_FAIL_AT,),
                        checkpoint_every=2, keep=1, quantized_opt=quantized,
                        ckpt_dir=str(ckpt_root / arch),
                        log=lambda m, a=arch: log(f"[train] {a}: {m}"))
        wall = time.perf_counter() - t0
        if restored != [True]:
            raise AssertionError(f"{arch}: the restart read back a state "
                                 f"that differs from the one saved at step "
                                 f"2 (or restored {len(restored)} times): "
                                 f"{restored}")
        peak = torch.cuda.max_memory_allocated()
        counts = zoo_launches()
        cfg = res["cfg"]
        L = res["losses"]
        n_runs = len(L)                 # steps run, the replay included
        mixer = "ssd_scan" if cfg.ssm is not None else "flash_attention"
        per_step = cfg.n_layers * TRAIN_MICROBATCHES
        want = {mixer: per_step * n_runs, f"{mixer}_bwd": per_step * n_runs}
        other = "flash_attention" if mixer == "ssd_scan" else "ssd_scan"
        want.update({other: 0, f"{other}_bwd": 0})
        if counts != want:
            raise AssertionError(f"{arch} training launched {counts}, "
                                 f"expected {want}")
        if res["restarts"] != 1 or n_runs != TRAIN_STEPS + 1:
            raise AssertionError(f"{arch}: restarts {res['restarts']}, "
                                 f"{n_runs} steps run")
        if not all(map(lambda x: x == x and abs(x) < float("inf"), L)):
            raise AssertionError(f"{arch}: losses not finite: {L}")
        if L[2] != L[3]:
            raise AssertionError(f"{arch}: step 2 gave {L[2]} and, replayed "
                                 f"from the checkpoint, {L[3]}")
        times = res["step_times"]
        step_s = sorted(times[1:])[len(times[1:]) // 2]     # median, warm
        tokens = res["tokens_per_step"]
        mflops = model_flops(cfg, ShapeCfg("train_cell", TRAIN_SEQ,
                                           TRAIN_BATCH, "train"))
        # one more step under the profiler, on the trained state
        model = build_model(cfg, dev)
        opt = (quantized_adamw if quantized else adamw)(
            1e-3, weight_decay=0.01, grad_clip=1.0)
        step_fn = make_train_step(model, opt,
                                  microbatches=TRAIN_MICROBATCHES)
        from repro_torch.train.data import DataConfig, SyntheticDataset
        batch = next(SyntheticDataset(DataConfig(
            vocab=cfg.vocab, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH),
            start_step=TRAIN_STEPS, device=dev))
        p, s = res["params"], res["opt_state"]
        prof_wall, rows = profiled(lambda: step_fn(
            p, s, batch, torch.tensor(TRAIN_STEPS, device=dev)))
        dev_us = sum(r[0] for r in rows)
        busy = dev_us / 1e6 / prof_wall
        n = count_params(cfg)
        depth = ("" if layers is None else
                 f", depth cut from {get_config_layers(arch)} to {layers}")
        log(f"[train] {arch}: {n / 1e9:.3f} B params ({cfg.n_layers} layers"
            f"{depth}, d_model {cfg.d_model}; "
            f"{'int8' if quantized else 'f32'} moments); losses "
            f"{[round(x, 4) for x in L]} (step 2 replayed after the restart:"
            f" {L[2]} == {L[3]}; the restored params and optimizer state "
            f"torch.equal to those saved at step 2); step {step_s:.3f} s warm (steps "
            f"{[round(t, 3) for t in times]}), {tokens / step_s:.0f} "
            f"tokens/s, model_flops {mflops:.4g} = "
            f"{mflops / step_s / BF16_OPS_PER_S:.4f} of the bf16 peak; "
            f"peak device memory {peak / 2**30:.2f} GiB; wall {wall:.1f} s "
            f"with the checkpoints; launches {json.dumps(counts)} "
            f"({per_step} forward and {per_step} backward a step)")
        log(f"[train] {arch} profile of one step: wall {prof_wall:.3f} s "
            f"(profiler on), device kernels {dev_us / 1e3:.1f} ms in "
            f"{sum(r[1] for r in rows)} launches, busy share {busy:.4f}")
        for us, cnt, key in rows[:6]:
            log(f"[train]   {us / 1e3:8.3f} ms {cnt:6d}x "
                f"({100 * us / dev_us:4.1f}%)  {key[:80]}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        by_arch[arch] = dict(params=n, layers=cfg.n_layers, step_s=step_s,
                             quantized_opt=quantized,
                             tokens_per_s=tokens / step_s,
                             mfu=mflops / step_s / BF16_OPS_PER_S,
                             peak_gib=peak / 2**30, busy_share=busy,
                             losses=L, launches=counts)
        del res, p, s, model, step_fn, batch
        shutil.rmtree(ckpt_root / arch, ignore_errors=True)
        torch.cuda.empty_cache()
    reduced = {arch: f"n_layers {get_config_layers(arch)} -> {layers}"
               for arch, layers, _ in TRAIN_RUNS if layers is not None}
    log(f"[train] reduced: {json.dumps(reduced)}")
    return total, by_arch


def hold_bf16_on_card(got, want, what: str) -> float:
    """The zoo's bf16 bar (`repro_torch.testing.hold_bf16`: rtol
    BF16_RTOL, atol BF16_RTOL x max |want|) evaluated on the card, where
    a billion-entry embedding gradient compares in a fraction of a second;
    returns max abs err / max |want|."""
    import torch
    from repro_torch.testing import BF16_RTOL
    g, w = got.float(), want.to(got.device).float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} against "
                             f"{tuple(w.shape)}")
    top = float(w.abs().max())
    if not torch.allclose(g, w, rtol=BF16_RTOL, atol=BF16_RTOL * top):
        raise AssertionError(f"{what}: differs beyond rtol {BF16_RTOL}, "
                             f"atol {BF16_RTOL * top:.3g}: max abs "
                             f"{float((g - w).abs().max()):.3g}")
    return float((g - w).abs().max()) / max(top, 1e-30)


def phase_train_card_vs_cpu(dev) -> None:
    """TRAIN_CPU_RUNS at full width, B 1: one step's loss and every
    gradient leaf (no optimizer step) on the card (kernels forward and
    backward) against the port's CPU path (plain versions, autograd) on
    the same weights and tokens, within the zoo's bf16 bar (the leaves
    compared on the card)."""
    import torch
    from repro_torch.core.tree import leaf_paths, tree_leaves, tree_unflatten
    from repro_torch.models import build_model
    from repro_torch.testing import hold_bf16, tree_to
    from repro_torch.train.train_step import make_loss_fn

    def value_and_grad(model, params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = make_loss_fn(model)(tree_unflatten(params, leaves), batch)
        return loss, tree_unflatten(params, list(torch.autograd.grad(
            loss, leaves)))

    for arch, layers, seq in TRAIN_CPU_RUNS:
        cfg = zoo_config(arch, layers)
        card, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
        params = card.init(1)
        tokens = zoo_tokens(dev, cfg, seq + 1, seed=1)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        reset_zoo_launches()
        loss_card, g_card = value_and_grad(card, params, batch)
        torch.cuda.synchronize()
        counts = zoo_launches()
        t0 = time.perf_counter()
        loss_cpu, g_cpu = value_and_grad(cpu, tree_to(params, "cpu"),
                                         tree_to(batch, "cpu"))
        t_cpu = time.perf_counter() - t0
        verdict = hold_bf16(loss_card.detach(), loss_cpu.detach(),
                            f"{arch} loss")
        worst = max((hold_bf16_on_card(gc, gp, f"{arch} gradient {k}"), k)
                    for (k, gc), (_, gp) in zip(leaf_paths(g_card),
                                                leaf_paths(g_cpu)))
        log(f"[train-cpu] {arch} depth {layers}, B 1, S {seq}, full width: "
            f"loss card {float(loss_card.detach()):.5f} vs CPU "
            f"{float(loss_cpu.detach()):.5f} "
            f"({verdict}); every one of {len(tree_leaves(g_cpu))} gradient "
            f"leaves within the bar (worst max abs / max |CPU| "
            f"{worst[0]:.3g} at {worst[1]}); card launches "
            f"{json.dumps(counts)}; CPU step {t_cpu:.1f} s")
        del params, g_card, g_cpu, card, cpu
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(secs) or 'nothing (cached)'} "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        logf = build.library_path(name).with_suffix(".so.log")
        for line in logf.read_text().splitlines() if logf.exists() else []:
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    walls = {}

    def timed(fn, *args):
        """fn(*args), its wall seconds kept under its name."""
        t = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__] = round(time.perf_counter() - t, 1)
        return out

    kernels = timed(phase_kernels, dev)
    floor = kernels[0]["launch_floor_ms"]
    kernels.append(timed(phase_prng, dev, floor))
    kernels.append(timed(phase_batched_linear, dev, floor))
    widths = timed(phase_sweep_widths, dev, floor)
    timed(phase_cells, dev)
    launches, split, rates = timed(phase_main_path, dev)
    timed(phase_profile, dev)
    grid_launches, grid_shapes = timed(phase_grid, dev, rates)
    lifecycle = {"continual": timed(phase_continual, dev),
                 "serving": timed(phase_serving, dev),
                 "faults": timed(phase_faults, dev)}
    kernels += timed(phase_zoo_kernels, dev)
    timed(phase_zoo_card_vs_cpu, dev)
    zoo_counts, zoo_archs = timed(phase_zoo_model, dev)
    launches.update(zoo_counts)
    timed(phase_zoo_profile, dev)
    kernels += timed(phase_train_kernels, dev)
    timed(phase_train_card_vs_cpu, dev)
    train_counts, train_archs = timed(phase_train, dev)
    for name, n in train_counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"[time] wall seconds by phase: {json.dumps(walls)}")
    for k in kernels:
        name = k["name"]
        # each main path's own run: the episodes, the grid, the zoo
        k["launches"] = (launches[name] + grid_launches.get(name, 0)
                         + sum(ph.get(name, 0) for ph in lifecycle.values()))
        k.update(split.get(name, {}))
        k.update(widths.get(name, {}))
        if name in grid_launches:
            k["launches_episodes"] = launches[name]
            k["launches_grid"] = grid_launches[name]
            k["launches_grid_by_shape"] = grid_shapes.get(name, {})
        for phase, counts in lifecycle.items():
            if name in counts:
                k[f"launches_{phase}"] = counts[name]
        if name == "flash_attention":
            k["launches_by_arch"] = {a: r["launches"][name]
                                     for a, r in zoo_archs.items()
                                     if r["launches"][name]}
        if train_counts.get(name):
            # the training cells' run (forward with the LSE store, and the
            # backward kernels)
            k["launches_train"] = train_counts[name]
            k["launches_train_by_arch"] = {
                a: r["launches"][name] for a, r in train_archs.items()
                if r["launches"][name]}
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[card] {card}")
    print(json.dumps({"kernels": [
        {**{f: k[f] for f in order},
         **{f: v for f, v in k.items() if f not in order}}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
