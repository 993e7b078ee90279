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
    the bound (the bytes in 32-bit words, or in the int64 key layout, or
    the hashes' integer instructions at the INT32 issue rate);
    the TD step's kernels (`[batched_linear]`): `td_grad`
    (`csrc/td_grad.cu`, forward, loss and backward in one launch) at G 1,
    3 and 45 agents and state 106, 24 and 298 within rtol 1e-5 of its
    plain versions (the card path before it, and plain torch), two runs
    and agent 0 alone equal bit for bit, agents not ready exactly 0;
    `adamw_lanes` (`csrc/adamw_lanes.cu`, the clipped AdamW step in one
    launch) torch.equal to the card path's update at G 1, 3 and 45; both
    graph-timed beside their bound and their plain versions' device time;
    the batch-invariant products and sums (`csrc/batched_linear.cu`, now
    the TD step of shapes td_grad does not cover) at G = 45 within 1e-5
    of their plain versions, agent 0 alone equal bit for bit to agent 0 of
    45; a whole TD step's wall, host
    issue and device time and launches at G = 1 and 45, the new kernels,
    the card path before them and plain torch in turns;
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
 5e. the partition layer over ranks (`[mesh]`): rank processes started
    on this card in a gloo group on localhost through the REPRO_DIST_*
    knobs, each holding the run to one rank on the card: the figure grid
    at MESH_OPS ops (135 cells, seeds 0-2, so S = 3 pads on seed dims 2
    and 4) on 4 ranks under REPRO_SWEEP_MESH 4x1, 2x2, 1x4 and auto
    (deterministic lanes `==`, learned lanes `==` or by 5b's rule, with
    the count `==`); then on 2 ranks the switch stream through
    `run_stream` (rank 0's checkpoints restored on every rank), 8 tenants
    on 4 slots through the MappingServer (every tenant `==` to one rank, 4
    against `solo_stream`) and the shrink drill 2 -> 1 (every tenant `==`
    to the fault-free run); each shape's walls, each rank's launches by
    kernel and peak memory.  The ranks share the one card, so the walls say
    nothing of scaling over cards.
 5d. the planning layer (`[plan]`): shape_applicable, model_flops,
    memory_bytes and the card's Roofline for every arch x shape; the
    mapper's dueling_qnet at state 24 (N 1 and 64) within 1e-4 and its TD
    step's td_grad at state 24 as `[batched_linear]` holds it; then its
    main path, `core/sharding_mapper.search` for every
    arch at train_4k on a (16, 16) mesh of H100s (300 steps, seed 0)
    beside `exhaustive_best`, and jamba-1.5-large-398b's OOM escape on
    (8, 8), the AIMM kernels' counts set to 0 just before and read just
    after: qwen3-32b within 1.3x of its optimum, jamba leaving the OOM
    plateau with FSDP and int8 moments; wall and launches a search step,
    a profile of one search; jamba and qwen3-32b searched again on the
    CPU, `==` to the card or parting once at a greedy near-tie below 1e-4
    relative.
 6. model-zoo kernels vs their plain-torch versions on the card, at the
    main-path shapes (B 1, S 4096): flash attention at minitron-8b's
    (H 32, K 8, hd 128) in bf16 (the wgmma kernel) and f32 within the bars
    of `flash_attention/ref.py` BARS (elementwise, relative L2 overall and
    per row), and in bf16 at hd 16 and 32 (the mma.sync kernel, beside its
    bound and SDPA); then in bf16 at
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
    1 layer; gemma3-12b: 6; deepseek-moe-16b: its dense first layer and
    one MoE layer; llama-3.2-vision-11b: one 'C' and four 'A' layers over
    1601 image tokens; whisper-large-v3: 1 encoder and 1 decoder layer,
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
8b. the reference's production serving cells (`[serve-32k]`, inside
    phase 8 on each arch's weights): prefill_32k and decode_32k at S 32768
    through the dry run's own step functions (`launch/dryrun.py`
    `serve_fn`) on real inputs from the seed (`dryrun.serve_inputs`:
    decode caches of 32768 entries filled, position 32767); prefill at
    batch 1 for every arch and, for minitron-8b and mamba2-370m, at the
    largest batch the dry run fits on the card (`dryrun.serve_batch`,
    minitron-8b's cut for the time limit), decode at each arch's largest
    fitting batch for 8 steps; each cell's wall, tokens/s or steps/s,
    launches (prefill `==` per_forward, decode none), finite logits, the
    dry run's predicted bytes beside the measured peak, a decode step's
    peak at most 5% over its params and caches, the Roofline bound and the
    busy share; every cut in the `reduced` line.  Then
    `[serve-32k-kernels]`: flash at S 32768 at four of the cells' shapes
    (minitron-8b causal, gemma3-12b's window 1024 at hd 256, mixtral's
    window 4096, whisper's bidirectional encoder) within BARS, graph-timed
    beside the bound and SDPA, and the SSD scan at L 32768 at the mamba
    prefill cell's batch within 1e-4; `[serve-32k-cpu]`: both cells card
    vs CPU at S 32768 at the smoke widths of six families (dense,
    local/global, MoE on the CPU's routes, Mamba, encoder-decoder,
    vision) within the bf16 bar, decode's greedy tokens `==` where sure.
    `python3 chip_smoke.py --serve-32k` runs these alone.
 9. profile: torch.profiler over one warm prefill forward and one serving
    loop of minitron-8b, mamba2-370m, whisper-large-v3 and
    llama-3.2-vision-11b at a quarter of their depth (ZOO_PROFILE_LAYERS;
    busy share, top kernels by device time).
9b. training: `[train-kernels]`, the flash and SSD backward kernels
    against autograd through their plain versions at minitron-8b's and
    mamba2-370m's shapes (flash in bf16 and f32 within GRAD_BARS, SSD
    within 1e-4), then the flash backward's other variants at the zoo's
    full shapes (TRAIN_FLASH_SHAPES: gemma3-12b's global and local hd-256
    layers, whisper-large-v3's encoder and cross attention,
    llama-3.2-vision-11b's cross attention, mixtral-8x22b's window at S
    8192), each in f32 at a small shape, two runs torch.equal, timed
    beside the bound and SDPA's backward; and at the smoke configs' hd 16
    and 32 (bf16 on mma.sync, f32 on CUDA cores) at each mask, and bf16
    timed at minitron-8b's shape cut to each width beside a bound with
    the exp2 term;
    `[train-smoke]`, the reference's documented `launch.train --smoke`
    through `launch/train.py`'s `train` on the card for the eight archs
    whose reference command runs (TRAIN_SMOKE_RUNS: minitron-8b 50 steps,
    the rest 3, at S 128 and global batch 4), finite losses, each run's
    launches `step_launches`, then every arch's smoke step card vs CPU
    (TRAIN_SMOKE_CPU);
    `[train-cpu]`, one step's loss and every gradient leaf card vs CPU at
    full width (TRAIN_CPU_RUNS; MoE on the card's routes); `[train]`,
    the training main path: minitron-8b (4 layers, int8 moments) and
    mamba2-370m through `launch/train.py` with a checkpoint every 2 steps
    and a failure injected before step 3, the restored state torch.equal
    to the saved one, then gemma3-12b (6 layers), whisper-large-v3 (full
    depth), llama-3.2-vision-11b (5 layers) and deepseek-moe-16b (4
    layers) for 3 steps each (TRAIN_FAMILY_RUNS; the depth cuts in the
    phase's `reduced` line), each step launching the kernels per_forward
    x 2 microbatches times forward and as often backward, and one
    profiled step per cell; also qwen3-32b (4 of 64 layers) and
    phi3-medium-14b (8 of 40) through `launch/train.py`, and the flash
    backward at their shapes, whisper-large-v3's decoder and
    deepseek-moe-16b's.
    Then `[shard]`, the sharded steps on a (1, 1) mesh of a world-1 nccl
    group against the unsharded ones; `[train-mesh]`, `launch/train.py`'s
    `train` in its own world-1 nccl group, so on a (1, 1) mesh of DTensor
    params, optimizer state, batch and gradients: mamba2-370m with the
    restart drill and minitron-8b (4 layers, int8 moments) for 3 steps,
    each step's loss torch.equal to `[train]`'s, the restored state
    torch.equal to the saved one, the launches `step_launches`' (a mesh of
    several cards needs several cards: NCCL refuses two ranks on one);
    then `[dryrun]`.
9c. `[roofline]`: every training cell's and prefill's measured warm step
    against the card's Roofline bound of its own cut config and shape
    (fails below it), the training cells' model_flops share (`==`
    [train]'s) and the cost model's hbm_per_chip beside the measured
    peak; full-depth minitron-8b's memory by the same model.
9d. `[examples]`: the four `examples/torch_*.py` on the card at reduced
    arguments (2 AIMM episodes, one arch, 40 training steps with a
    failure injected).
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
H100_SMS = 132
# results a clock per SM at compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): exp2 on the SFU (MUFU), and
# 32-bit integer add, logic and shift
EX2_PER_CLOCK_SM = 16
INT32_PER_CLOCK_SM = 64
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


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


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


def td_agents(dev, G: int, hidden: tuple[int, ...] = (128, 128)):
    """G fresh agents of the paper's Q network (state 106, hidden 128 x 2,
    8 actions; another hidden shape if given) with full replays of random
    transitions, so a TD step samples, trains and updates every agent."""
    import dataclasses
    import torch
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import default_agent_cfg
    cfg = default_agent_cfg(NMPConfig())
    cfg = cfg._replace(dqn=dataclasses.replace(cfg.dqn, hidden=hidden))
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


# the TD step's three ways on the card: the port's kernels (one td_grad and
# one adamw_lanes launch), the card path before them (autograd over
# batched_linear's products, its sq_norm and update_lanes' torch ops: the
# two kernels' plain versions on the card), and that with cuBLAS products
# and torch sums in place of batched_linear (all plain torch)
TD_PATHS = ("kernels", "card", "plain")
# the TD step's state widths: Table 1, the sharding mapper, the 8x8 mesh
TD_STATES = (106, 24, 298)


@contextlib.contextmanager
def td_path(mode: str):
    """Run the TD step (`dqn.td_loss_and_grads`, `update_lanes`) the
    TD_PATHS way `mode` within the block."""
    from repro_torch.kernels.adamw_lanes import ops as aops
    from repro_torch.kernels.adamw_lanes import ref as aref
    from repro_torch.kernels.batched_linear import ref as lref
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.td_grad import ref as gref
    if mode not in TD_PATHS:
        raise ValueError(f"td_path: {mode!r} not in {TD_PATHS}")
    saved = gops.td_grad, aops.adamw_lanes, gref.linear, aref.sq_norm
    if mode != "kernels":
        gops.td_grad, aops.adamw_lanes = gref.td_grad, aref.adamw_lanes
    if mode == "plain":
        gref.linear, aref.sq_norm = lref.linear, lref.sq_norm
    try:
        yield
    finally:
        gops.td_grad, aops.adamw_lanes, gref.linear, aref.sq_norm = saved


def td_step_times(dev, G: int, mode: str) -> dict:
    """One TD step (`agent.train`: minibatch draw, targets, loss and
    gradients, clipped Adam) for G agents, eager, the TD_PATHS way `mode`:
    the wall per step over 30 steps ending in a synchronize, the host's
    issue time per step (the same loop timed without the synchronize: the
    host is the bound when it is close to the wall), the device's kernel
    time and launches per step from torch.profiler, and one step's
    launches of the TD step's own kernels."""
    import torch
    from repro_torch.core import agent as agent_mod
    ag, cfg = td_agents(dev, G)
    with td_path(mode):
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
        ops = aimm_kernel_ops()
        before = [dict(o.launches) for o in ops]
        step()
        kern = {k: v - b[k] for o, b in zip(ops, before)
                for k, v in o.launches.items() if v - b[k]}
        _, rows = profiled(lambda: [step() for _ in range(10)])
    return dict(wall_ms=wall * 1e3, issue_ms=issue * 1e3,
                device_ms=sum(r[0] for r in rows) / 10 / 1e3,
                launches=sum(r[1] for r in rows) / 10, kernel_launches=kern)


def td_inputs(dev, G: int, S: int, ready=None):
    """G agents of the paper's Q network at state S (biases random, weights
    off the seeded init by noise, so the agents differ) and a minibatch for
    `td_grad`: s (G, 64, S), a, y, w (a fifth of the rows masked) and
    `ready` (given, else every third agent from the second not ready),
    the rows of an agent not ready masked as `train_step` masks them."""
    import torch
    from repro_torch.core import dqn, prng
    cfg = dqn.DQNConfig(state_dim=S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * S + G)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    params = dqn.init_params(prng.PRNGKey(S, dev), cfg, G, dev)
    params = {k: v + (0.1 if k.startswith("b") else 0.02) * rnd(*v.shape)
              for k, v in params.items()}
    if ready is None:
        ready = torch.ones(G, device=dev)
        ready[1::3] = 0.0
    w = (torch.rand((G, 64), generator=gen, device=dev) < 0.8).to(
        torch.float32) * ready[:, None]
    a = torch.randint(0, cfg.n_actions, (G, 64), generator=gen, device=dev,
                      dtype=torch.int32)
    return params, (rnd(G, 64, S), a, rnd(G, 64), w, ready, cfg)


def _loss_and_leaves(res) -> list:
    return [("loss", res[0])] + list(res[1].items())


def hold_td_grad(dev, G: int, S: int, ready=None) -> dict:
    """`td_grad` for G agents at state S against its plain version on the
    same inputs, on the card the card path (td_grad/ref.py over
    batched_linear) and all plain torch (cuBLAS): the loss and every
    gradient leaf within rtol 1e-5 and atol 1e-5 x the plain leaf's max
    |value| (another order of the same float32 sums); two runs torch.equal;
    the gradients of agents not ready exactly 0; agent 0 alone torch.equal
    to agent 0 of G.  Returns the largest differences, and whether the
    kernel's results are torch.equal to the card path's."""
    import torch
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.td_grad import ref as gref
    params, args = td_inputs(dev, G, S, ready)
    got = _loss_and_leaves(gops.td_grad(params, *args))
    again = _loss_and_leaves(gops.td_grad(params, *args))
    if not all(torch.equal(a_, b_) for (_, a_), (_, b_) in zip(got, again)):
        raise AssertionError(f"td_grad G={G} S={S}: two runs differ")
    card = _loss_and_leaves(gref.td_grad(params, *args))
    with td_path("plain"):
        plain = _loss_and_leaves(gref.td_grad(params, *args))
    rec = {}
    for label, want in (("card", card), ("plain", plain)):
        errs = {}
        for (k, g_), (_, w_) in zip(got, want):
            errs[k] = (g_ - w_).abs().max().item()
            atol = 1e-5 * w_.abs().max().item()
            if not torch.allclose(g_, w_, rtol=1e-5, atol=atol):
                raise AssertionError(
                    f"td_grad G={G} S={S} {k}: beyond rtol 1e-5, atol "
                    f"{atol:.3g} of the {label} path (max abs err "
                    f"{errs[k]:.3g})")
        rec[label] = errs
    rec["equal_card"] = {k: torch.equal(g_, w_)
                         for (k, g_), (_, w_) in zip(got, card)}
    off = args[4] == 0
    if any(g_[off].any() for _, g_ in got[1:]):
        raise AssertionError(f"td_grad G={G} S={S}: an agent not ready has "
                             f"a non-zero gradient")
    if G > 1:
        alone = _loss_and_leaves(gops.td_grad(
            {k: v[:1] for k, v in params.items()},
            *(t[:1] for t in args[:5]), args[5]))
        if not all(torch.equal(a_[0], g_[0])
                   for (_, a_), (_, g_) in zip(alone, got)):
            raise AssertionError(f"td_grad S={S}: agent 0 alone differs "
                                 f"from agent 0 of {G}")
    return rec


def adamw_case(dev, G: int):
    """(grads, state, params, step) of G agents of the paper's network for
    the agents' AdamW (`adamw(lr, grad_clip=1.0)` with a (G,) step): every
    third agent from the second has zero gradients (not ready)."""
    import torch
    from repro_torch.core import dqn
    params, args = td_inputs(dev, G, 106)
    gen = torch.Generator(device=dev)
    gen.manual_seed(G)
    rnd = lambda t, sc: sc * torch.randn(t.shape, generator=gen, device=dev)
    grads = {k: rnd(v, 0.3) * args[4].reshape((-1,) + (1,) * (v.dim() - 1))
             for k, v in params.items()}
    state = {"m": {k: rnd(v, 1e-3) for k, v in params.items()},
             "v": {k: rnd(v, 1e-3).square() for k, v in params.items()}}
    step = torch.arange(G, device=dev, dtype=torch.int32) * 5 + 3
    return grads, state, params, step, dqn.DQNConfig(state_dim=106)


def hold_adamw_lanes(dev, G: int) -> float:
    """`adamw_lanes` through `update_lanes` (the agents' clipped AdamW) for
    G agents: new params, m and v torch.equal to the card path's (the
    batched_linear norm and the torch ops) for the same gradients, and
    within rtol 1e-5 (atol 1e-5 x the leaf's max) of all plain torch (the
    norm's sums in torch's order).  Returns the largest difference to all
    plain torch."""
    import torch
    from repro_torch.train.optimizer import adamw
    grads, state, params, step, cfg = adamw_case(dev, G)
    opt = adamw(cfg.lr, grad_clip=cfg.grad_clip)
    outs = {}
    for mode in TD_PATHS:
        with td_path(mode):
            p, s = opt.update(grads, state, params, step)
        outs[mode] = [p[k] for k in p] + [s[w][k] for w in ("m", "v")
                                           for k in p]
    if not all(torch.equal(a_, b_) for a_, b_ in zip(outs["kernels"],
                                                     outs["card"])):
        raise AssertionError(f"adamw_lanes G={G}: differs from the card "
                             f"path's update")
    err = max_abs_err(outs["kernels"], outs["plain"])
    for a_, b_ in zip(outs["kernels"], outs["plain"]):
        if not torch.allclose(a_, b_, rtol=1e-5,
                              atol=1e-5 * b_.abs().max().item()):
            raise AssertionError(f"adamw_lanes G={G}: beyond 1e-5 of all "
                                 f"plain torch ({err:.3g})")
    return err


def device_ms(fn, reps: int = 10) -> float:
    """The device's kernel time per call of fn (eager), summed from
    torch.profiler over `reps` warm calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    _, rows = profiled(lambda: [fn() for _ in range(reps)])
    return sum(r[0] for r in rows) / reps / 1e3


def td_grad_cost(G: int, S: int, N: int = 64, H: int = 128,
                 A: int = 8) -> tuple[float, float]:
    """(bytes, FLOP) one td_grad launch must move and do: the weights,
    minibatch, targets, row weights, actions and `ready` read once, the
    loss and the gradients written once; the forward, head and dueling
    combine, and the backward products (dW0, dW1, dh1, the head's)."""
    n_par = S * H + H + H * H + H + H * (A + 1) + A + 1
    nbytes = G * 4 * (2 * n_par + N * S + 3 * N + 1 + 1)
    fwd = N * (S * H + H * H + H * (A + 1))
    bwd = S * H * N + H * H * N + N * H * H + 2 * H * (A + 1) * N
    return nbytes, G * 2 * (fwd + bwd)


def phase_batched_linear(dev, floor: float) -> list[dict]:
    """The TD step's kernels on the card.  `td_grad` (forward, loss and
    backward in one launch) at G 1, 3 and 45 agents and state 106, 24 and
    the 8x8 mesh's 298, and with every agent not ready (`hold_td_grad`);
    `adamw_lanes` (the clipped AdamW step in one launch) at G 1, 3 and 45
    with agents not ready (`hold_adamw_lanes`); each graph-timed at the
    grid's learned group (G = 45, state 106) and alone (G = 1) beside its
    bound, the launch floor and the device time of its plain versions on
    the card (the card path and all plain torch, from torch.profiler).
    Then `batched_linear`'s batch-invariant products and sums (the TD
    step's for network shapes td_grad does not cover) at G = 45: the first
    layer's forward, its input gradient, its weight and bias gradients and
    the gradient norm over 8 leaves, each within rtol 1e-5 of its plain
    version and agent 0's result at G = 45 equal bit for bit to the same
    agent alone, graph-timed beside the plain version and one library call
    where there is one.
    Last, one whole TD step at G = 1 and G = 45 the three TD_PATHS ways in
    turns (kernels, card, plain, plain, card, kernels): wall, host issue
    and device time and launches per step."""
    import torch
    from repro_torch.kernels.adamw_lanes import ops as aops
    from repro_torch.kernels.adamw_lanes import ref as aref
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.batched_linear import ref as lref
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.td_grad import ref as gref
    G, N, S_, H = GRID_AIMM_LANES * len(GRID_SEEDS), 64, 106, 128

    # ---- td_grad ----
    held = {}
    for S in TD_STATES:
        for g_ in (1, 3, G):
            held[(g_, S)] = hold_td_grad(dev, g_, S)
    held["ready 0"] = hold_td_grad(dev, 3, S_, torch.zeros(3, device=dev))
    worst = {lab: max(max(r[lab].values()) for r in held.values())
             for lab in ("card", "plain")}
    unequal = sorted({(k, key) for key, r in held.items()
                      for k, eq in r["equal_card"].items() if not eq},
                     key=str)
    log(f"[batched_linear] td_grad at G 1/3/{G} x S {TD_STATES} and every "
        f"agent not ready: within rtol 1e-5, atol 1e-5 x max|leaf| of the "
        f"card path (max abs err {worst['card']:.3g}) and of plain torch "
        f"({worst['plain']:.3g}); two runs torch.equal; agents not ready "
        f"exactly 0; agent 0 alone == agent 0 of 3 and of {G}")
    if unequal:
        big = {f"{k} {key}": held[key]["card"][k] for k, key in unequal}
        top = sorted(big.items(), key=lambda kv: -kv[1])[:6]
        log(f"[batched_linear] td_grad against the card path: not "
            f"torch.equal in {len(unequal)} (leaf, case) pairs; largest "
            f"differences {top}; at G={G} S={S_}: "
            f"{json.dumps(held[(G, S_)]['card'])}")
    else:
        log("[batched_linear] td_grad against the card path: loss and "
            "every gradient torch.equal in every case")
    td_rec = {}
    for g_ in (G, 1):
        params, args = td_inputs(dev, g_, S_)
        k_ms = graph_ms(lambda: gops.td_grad(params, *args))
        card_ms = device_ms(lambda: gref.td_grad(params, *args))
        with td_path("plain"):
            plain_ms = device_ms(lambda: gref.td_grad(params, *args))
        b_ms, b_by = bound(*td_grad_cost(g_, S_))
        td_rec[g_] = dict(ms=k_ms, plain_ms=plain_ms, card_ms=card_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"[batched_linear] td_grad G={g_} S={S_}: kernel {k_ms:.5f} "
            f"ms/launch (graph); device time of the card path (batched_"
            f"linear + autograd) {card_ms:.5f} ms, of plain torch "
            f"{plain_ms:.5f} ms (profiler); bound {b_ms:.6f} ms ({b_by}), "
            f"launch floor {floor:.5f} ms")

    # ---- adamw_lanes ----
    a_err = {g_: hold_adamw_lanes(dev, g_) for g_ in (1, 3, G)}
    log(f"[batched_linear] adamw_lanes at G 1/3/{G} (every third agent not "
        f"ready): new params, m and v torch.equal to the card path's; max "
        f"abs err to plain torch {max(a_err.values()):.3g}")
    ad_rec = {}
    for g_ in (G, 1):
        grads, state, params, step, cfg = adamw_case(dev, g_)
        t = step.to(torch.float32) + 1.0
        call = (grads, state["m"], state["v"], params, 1 - torch.pow(0.9, t),
                1 - torch.pow(0.999, t), torch.full_like(t, cfg.lr))
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                  grad_clip=cfg.grad_clip)
        k_ms = graph_ms(lambda: aops.adamw_lanes(*call, **kw))
        card_ms = device_ms(lambda: aref.adamw_lanes(*call, **kw))
        with td_path("plain"):
            plain_ms = device_ms(lambda: aref.adamw_lanes(*call, **kw))
        n = sum(v[0].numel() for v in params.values())
        b_ms, b_by = bound(g_ * (28 * n + 12), g_ * 18 * n)
        ad_rec[g_] = dict(ms=k_ms, plain_ms=plain_ms, card_ms=card_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"[batched_linear] adamw_lanes G={g_} ({n} values an agent): "
            f"kernel {k_ms:.5f} ms/launch (graph); device time of the card "
            f"path (sq_norm + torch ops) {card_ms:.5f} ms, of plain torch "
            f"{plain_ms:.5f} ms (profiler); bound {b_ms:.6f} ms ({b_by}), "
            f"launch floor {floor:.5f} ms")

    # ---- batched_linear: the products of shapes td_grad does not cover ----
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
        k_ms = graph_ms(lambda: kern(*args))
        p_ms = graph_ms(lambda: plain(*args))
        b_ms, b_by = bound(G * nbytes, G * flops)
        rec[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=max_abs_err(got, want))
        log(f"[batched_linear] {name} G={G}: within 1e-5 of plain (max abs "
            f"err {rec[name]['max_abs_err']:.3g}), agent 0 alone == agent 0"
            f" of {G}; kernel {k_ms:.5f} ms/launch (graph), plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}), launch floor "
            f"{floor:.5f} ms")
    lib_ms = graph_ms(lambda: torch.baddbmm(bias[:, None, :], x, w))
    # the input and weight gradients' products as one library call each
    # (dW alone: no single call also sums db, nor takes the norm of 8
    # leaves)
    lib_dx = graph_ms(lambda: torch.bmm(dy, w.transpose(1, 2)))
    lib_dw = graph_ms(lambda: torch.bmm(x.transpose(1, 2), dy))
    rec["dx"]["library_ms"] = lib_dx
    rec["dw_db"]["library_dw_ms"] = lib_dw
    log(f"[batched_linear] library calls G={G}: fwd torch.baddbmm "
        f"{lib_ms:.5f} ms, dx torch.bmm {lib_dx:.5f} ms; dW alone: "
        f"torch.bmm {lib_dw:.5f} ms (no single library call computes dW + "
        f"db, or the norm over 8 leaves)")
    # ---- the whole TD step, the three ways in turns ----
    td = {}
    for g_ in (1, G):
        for mode in TD_PATHS + TD_PATHS[::-1]:
            r = td_step_times(dev, g_, mode)
            td.setdefault((g_, mode), []).append(r)
            log(f"[batched_linear] TD step G={g_} {mode}: wall "
                f"{r['wall_ms']:.4f} ms/step, host issue {r['issue_ms']:.4f} "
                f"ms, device {r['device_ms']:.4f} ms in {r['launches']:.0f} "
                f"launches ({json.dumps(r['kernel_launches'])})")
    steps = {f"td_G{g_}_{mode}_{k}": [r[k] for r in rs]
             for (g_, mode), rs in td.items()
             for k in ("wall_ms", "issue_ms", "device_ms", "launches")}
    none_xla = ("none: XLA's {} of the TD step (src/repro/core/dqn.py "
                "td_loss under jax.value_and_grad, src/repro/core/agent.py:"
                "181-200), no pallas_call")
    first = rec["fwd"]
    bl = dict(
        name="batched_linear", route="cuda",
        source="src/repro_torch/csrc/batched_linear.cu",
        replaces=none_xla.format("dot_general and reductions"),
        **first, library_ms=lib_ms, launch_floor_ms=floor,
        path="the TD step of networks td_grad does not cover; no main "
             "path trains one (they train the paper's network through "
             "td_grad), so its launches are 0 and it stays as the card "
             "path before td_grad, the yardstick td_grad and adamw_lanes "
             "are held to",
        **{f"{m}_{k}": v for m, r in rec.items() for k, v in r.items()
           if m != "fwd"})
    tg = dict(
        name="td_grad", route="cuda", source="src/repro_torch/csrc/td_grad.cu",
        replaces=none_xla.format("dot_general, reductions and autodiff"),
        max_abs_err=worst["plain"], **td_rec[G], library_ms=None,
        library_note="no single PyTorch call computes a network's forward, "
                     "loss and backward",
        max_abs_err_card_path=worst["card"],
        torch_equal_card_path=not unequal, launch_floor_ms=floor,
        **{f"G1_{k}": v for k, v in td_rec[1].items()}, **steps)
    ad = dict(
        name="adamw_lanes", route="cuda",
        source="src/repro_torch/csrc/adamw_lanes.cu",
        replaces="none: XLA's clipped AdamW of the TD step "
                 "(src/repro/train/optimizer.py adamw, vmapped by "
                 "src/repro/core/agent.py:196), no pallas_call",
        max_abs_err=max(a_err.values()), **ad_rec[G], library_ms=None,
        library_note="no single PyTorch call clips each agent's gradients "
                     "by its own norm and updates them",
        torch_equal_card_path=True, launch_floor_ms=floor,
        **{f"G1_{k}": v for k, v in ad_rec[1].items()})
    return [bl, tg, ad]


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
    # the hashes' integer work at the INT32 rate on 132 SMs at the card's
    # max SM clock: a hash is 20 rounds of add, rotate and xor (60) and the
    # key schedule's ~10 adds and xors (csrc/threefry.cu), 70 instructions
    # (the source's header rounds it to ~90)
    clock = max_sm_clock_hz()
    int32_per_s = INT32_PER_CLOCK_SM * H100_SMS * clock
    rec = {}
    for mode, (kern, plain, hashes, lay, words) in draws.items():
        for j, args in enumerate(sets[:2]):
            if not torch.equal(kern(*args), plain(*args)):
                raise AssertionError(f"threefry {mode} differs from its "
                                     f"plain version (input set {j})")
        k_ms = cold_graph_ms(kern, sets)
        p_ms = cold_graph_ms(plain, sets, reps=6)
        int_ms = n * hashes * 70 / int32_per_s * 1e3
        f_ms = n * (2 * D if mode == "choice" else 0) / F32_OPS_PER_S * 1e3
        ops_ms = int_ms + f_ms
        w_ms = n * sum(words) / HBM_BYTES_PER_S * 1e3
        l_ms = max(n * sum(lay) / HBM_BYTES_PER_S * 1e3, ops_ms)
        b_ms, b_by = max((w_ms, "bytes"), (ops_ms, "operations"))
        log(f"[prng] threefry {mode} on 2^20 keys: equal; kernel {k_ms:.5f} "
            f"ms/launch (graph, inputs and outputs outside L2), plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}: {n * sum(words)} B "
            f"as 32-bit words {w_ms:.6f} ms; {n * hashes * 70:.4g} integer "
            f"instructions, 70 a hash x {hashes} a key, at "
            f"{INT32_PER_CLOCK_SM} a clock per SM x {H100_SMS} SMs x "
            f"{clock / 1e9:.3f} GHz {int_ms:.6f} ms"
            f"{f', float work {f_ms:.6f} ms' if f_ms else ''}), "
            f"{l_ms:.6f} ms in the int64 key layout ({n * sum(lay)} B), "
            f"launch floor {floor:.5f} ms")
        rec[mode] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_int64_layout_ms=l_ms,
                         bound_int32_ms=int_ms)
    # choice at the grid's learned group: 45 keys, one launch each
    k45 = prng.split(prng.PRNGKey(45, dev), 45)
    p45 = neighbour_weights(dev, 45)
    got, want = tops.choice(k45, p45), tref.choice(k45, p45)
    if not torch.equal(got, want):
        raise AssertionError("threefry choice at B = 45 differs from its "
                             "plain version")
    c45_ms = graph_ms(lambda: tops.choice(k45, p45))
    c45_plain = graph_ms(lambda: tref.choice(k45, p45))
    c45_b, c45_by = max(
        (45 * (8 + 4 * D + 4) / HBM_BYTES_PER_S * 1e3, "bytes"),
        ((45 * 70 / int32_per_s + 45 * 2 * D / F32_OPS_PER_S) * 1e3,
         "operations"))
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


def ssd_inputs(dev, carry: bool, seed: int = 0, batch: int = ZOO_BATCH,
               seq: int = ZOO_SEQ):
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
    x = torch.nn.functional.silu(rnd(batch, seq, H, P))
    b = torch.nn.functional.silu(rnd(batch, seq, N))
    c = torch.nn.functional.silu(rnd(batch, seq, N))
    if carry:
        dt = 0.01 * torch.nn.functional.softplus(rnd(batch, seq, H))
        a = -(0.05 + 0.95 * torch.rand(H, generator=gen, device=dev))
    else:
        dt = torch.nn.functional.softplus(rnd(batch, seq, H) - 2.0)
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


# A band mask over more queries than this goes to SDPA's memory-efficient
# backend: the math backend's f32 scores of S 32768 would not fit
SDPA_BAND_MAX_S = 8192


def flash_plain(q, k, v, window: int = 0, causal: bool = True):
    """attention_ref on (B, S, H, hd) q and (B, S_kv, K, hd) k/v, one KV
    head's query heads at a time (attention_ref itself takes query blocks
    past 4096 x 4096 scores a head)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    H, K = q.shape[2], k.shape[2]
    rep = H // K
    outs = [attention_ref(
        q[:, :, j * rep:(j + 1) * rep].transpose(1, 2),
        k[:, :, j:j + 1].expand(-1, -1, rep, -1).transpose(1, 2),
        v[:, :, j:j + 1].expand(-1, -1, rep, -1).transpose(1, 2),
        window=window, causal=causal).transpose(1, 2)
        for j in range(K)]
    return torch.cat(outs, dim=2)


def zoo_flash_shape(dev, label: str, arch: str, S: int,
                    windowed: bool = False, S_kv: int | None = None,
                    dtype: str = "bf16", hd: int | None = None,
                    tag: str = "[zoo-kernels]", reps: int = 20,
                    eager_reps: int | None = None) -> dict:
    """One later arch's flash shape: the kernel against the plain version
    within BARS, graph-timed, beside its bound (4 H hd x the visible
    query-key pairs at the tensor-core rate of bf16, or the f32 CUDA-core
    rate, or q/k/v/o bytes over HBM) and one SDPA call for the same
    function (the flash backend for bf16 without a mask; a boolean band
    attn_mask for a window; the default backend for f32).  Causal, unless
    `S_kv` is given: then non-causal with keys of that length (the
    encoder's and cross attention).  `reps` calls a graph, `eager_reps`
    timed eager calls (default: 2 of the plain version, 3 or 5 of SDPA
    with a band mask)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import BARS, compare, visible
    t_shape = time.perf_counter()
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
    k_ms = graph_ms(run, reps)
    p_ms = event_ms(lambda: flash_plain(q, k, v, window, causal),
                    eager_reps or 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window and S > SDPA_BAND_MAX_S:
        # the memory-efficient backend with the band as its mask, on K/V
        # expanded to the query heads (the math backend's scores would
        # not fit; no backend takes a band without a mask)
        band = visible(S, S, window, dev)
        ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (kt, vt))
        lib = "SDPA, memory-efficient backend, boolean band attn_mask"
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
                    qt, ke, ve, attn_mask=band), eager_reps or 3)
        except RuntimeError as e:       # a yardstick, not the port
            lib_ms, lib = None, f"{lib}: not timed ({str(e)[:120]})"
        del band, ke, ve
    elif window:
        band = visible(S, S, window, dev)
        lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True), eager_reps or 5)
        lib = "SDPA, boolean band attn_mask"
    elif dtype == "bf16":
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), reps)
        lib = "SDPA, flash backend"
    else:
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps)
        lib = "SDPA, default backend"
    pairs = H * (visible_pairs(S, window) if causal else S * S_kv)
    flops = 4 * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S if dtype == "bf16"
                       else F32_OPS_PER_S)
    log(f"{tag} flash_attention {dtype} ({kernel}) {label}: B=1 "
        f"S={S} S_kv={S_kv} H={H} K={K} hd={hd} "
        f"{'causal' if causal else 'non-causal'} window={window}: max abs err "
        f"{cmp['max_abs_err']:.3g}, relative L2 {cmp['rel_l2']:.3g}, worst "
        f"row {cmp['row_rel_l2']:.3g}; kernel {k_ms:.4f} ms/launch (graph), "
        f"plain {p_ms:.4f} ms, {lib} "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {flops:.4g} FLOP over {pairs} visible pairs; "
        f"{flops / k_ms / 1e9:.1f} TFLOP/s); the shape "
        f"{time.perf_counter() - t_shape:.1f} s")
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(label=label, S=S, S_kv=S_kv, H=H, K=K, hd=hd, dtype=dtype,
                causal=causal, window=window,
                kernel=kernel, max_abs_err=cmp["max_abs_err"], ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=lib)


def phase_zoo_kernels(dev) -> list[dict]:
    """Flash attention (minitron-8b shape, bf16 and f32; the mma.sync kernel
    at hd 16 and 32, timed beside its bound and SDPA) and the SSD scan
    (mamba2-370m shape, f32) against their plain versions on the card."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
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
    # the mma.sync kernel (bf16 at hd 16 and 32, the smoke configs' widths)
    # at the main path's S and heads: off the main path, held to the same
    # bars, graph-timed beside SDPA's flash backend and a bound with one
    # exp2 a visible pair at the SFU's rate at the card's max SM clock
    # (at these widths the exponentials outweigh the products)
    clock = max_sm_clock_hz()
    ex2_per_s = EX2_PER_CLOCK_SM * H100_SMS * clock
    frec_mma = {}
    for w in (16, 32):
        xs = flash_inputs(dev, torch.bfloat16, hd=w)
        before = fops.kernel_launches["mma_sync_bf16"]
        got = fops.gqa_flash_attention(*xs, causal=True)
        cmp = flash_compare(got, plain(*xs))
        if fops.kernel_launches["mma_sync_bf16"] != before + 1 or \
                not cmp["ok"]:
            raise AssertionError(f"flash_attention bf16 hd {w} "
                                 f"(mma_sync_bf16): {cmp}, launches "
                                 f"{fops.kernel_launches}")
        m_ms = graph_ms(lambda: fops.gqa_flash_attention(*xs, causal=True),
                        20)
        p_ms = graph_ms(lambda: plain(*xs), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in xs)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        pairs = ZOO_BATCH * H * S * (S + 1) // 2
        p_bound, by = bound(nb(*xs, got), 4 * w * pairs, BF16_OPS_PER_S)
        exp_ms = pairs / ex2_per_s * 1e3
        b_ms = max(p_bound, exp_ms)
        term = "exp2" if exp_ms >= p_bound else by
        log(f"[zoo-kernels] flash_attention bf16 (mma_sync_bf16) hd={w} "
            f"S={S} H={H} K={K}: max abs err {cmp['max_abs_err']:.3g}, "
            f"relative L2 {cmp['rel_l2']:.3g}, worst row "
            f"{cmp['row_rel_l2']:.3g}; kernel {m_ms:.4f} ms/launch (graph),"
            f" plain {p_ms:.4f} ms, SDPA, flash backend {lib_ms:.4f} ms; "
            f"bound {b_ms:.4f} ms ({term}: one exp2 a visible pair "
            f"{exp_ms:.4f} ms at {EX2_PER_CLOCK_SM} a clock per SM x "
            f"{H100_SMS} SMs x {clock / 1e9:.3f} GHz; products or bytes "
            f"{p_bound:.4f} ms, {by}); {m_ms / b_ms:.2f}x the bound")
        frec_mma[w] = dict(ms=m_ms, plain_ms=p_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=term,
                           max_abs_err=cmp["max_abs_err"])
        del xs, got
    frec["mma_sync_by_hd"] = frec_mma
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
# [zoo-profile]'s depth: a quarter of each arch's (whole super-blocks, an
# encoder cut alike), which keeps every layer kind and the command within
# its time budget; the full depths run in [zoo] and [zoo-model].
ZOO_PROFILE_LAYERS = {"minitron-8b": 8, "mamba2-370m": 12,
                      "whisper-large-v3": 8, "llama-3.2-vision-11b": 10}
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


def zoo_tokens(dev, cfg, seq: int, seed: int = 0, batch: int = ZOO_BATCH):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(1, cfg.vocab, (batch, seq), generator=gen,
                         device=dev)


def zoo_batch(dev, cfg, seq: int, seed: int = 0, batch: int = ZOO_BATCH,
              frames: int = WHISPER_FRAMES) -> dict:
    """The prefill batch of `cfg` on `dev`: tokens (B, seq), plus the
    stubbed frontend's output in bf16 from the seed: whisper's enc_frames
    (B, frames, D), llama-vision's img_embed (B, n_img_tokens, D)."""
    import torch
    out = {"tokens": zoo_tokens(dev, cfg, seq, seed, batch)}
    n_mem = frames if cfg.encoder is not None else cfg.n_img_tokens
    if n_mem:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        key = "enc_frames" if cfg.encoder is not None else "img_embed"
        out[key] = torch.randn((batch, n_mem, cfg.d_model),
                               generator=gen, device=dev).bfloat16()
    return out


def zoo_train_batch(dev, cfg, seq: int, seed: int, batch: int = ZOO_BATCH,
                    frames: int = WHISPER_FRAMES) -> dict:
    """`zoo_batch` of seq + 1 tokens as a training batch: tokens and
    labels (B, seq), the next token's."""
    out = zoo_batch(dev, cfg, seq + 1, seed, batch, frames)
    tokens = out.pop("tokens")
    out.update(tokens=tokens[:, :-1], labels=tokens[:, 1:])
    return out


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


def per_forward(cfg, seq: int | None = None) -> dict[str, int]:
    """Kernel launches one prefill forward of `cfg` makes: flash once per
    attention layer (a leading dense block is one), twice per 'C' layer
    (its self-attention and its cross attention; once where the decoder's
    `seq` queries are at most DECODE_MAX_Q, whose cross attention is dense
    `attend`) and once per encoder layer, the SSD scan once per Mamba
    layer; no backward."""
    from repro_torch.models.attention import DECODE_MAX_Q
    cross = 1 if seq is None or seq > DECODE_MAX_Q else 0
    n_attn = sum(mx in "AGWLB" for mx, _ in cfg.pattern) + (1 + cross) * sum(
        mx == "C" for mx, _ in cfg.pattern)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_ssd = sum(mx == "M" for mx, _ in cfg.pattern)
    return {"flash_attention": (cfg.first_k_dense + cfg.n_super * n_attn
                                + n_enc),
            "ssd_scan": cfg.n_super * n_ssd,
            "flash_attention_bwd": 0, "ssd_scan_bwd": 0}


def phase_zoo_model(dev, fits) -> tuple[dict[str, int], dict, list, float]:
    """The model zoo's main path (ZOO_RUNS), random weights from a seed:
    the prefill forward (`apply` then `logits`, B 1) twice per arch, then
    the serving loop of `launch/serve.py` (4 requests, batch 4, max-seq
    128, max-new 16) on the same weights, then the production serving
    cells at S 32768 on them (`serve_32k_cells`, [serve-32k]; `fits`, the
    dry run's counts from `serve_workers_wait`).  The
    kernels' counts are zeroed just before and read just after; each
    forward must launch flash once per attention layer and the SSD scan
    once per Mamba layer.  Returns the counts, per arch its numbers, the
    [serve-32k] cells' records and their wall seconds."""
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
    by_arch, serve_recs, serve_s = {}, [], 0.0
    for arch, layers, seq in ZOO_RUNS:
        cfg = zoo_config(arch, layers)
        per_fwd = per_forward(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dev)
        t0 = time.perf_counter()
        params, _ = model.init(0)
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
        by_arch[arch] = dict(params=n, active_params=n_act, cfg=cfg,
                             layers=cfg.n_layers, seq=seq,
                             prefill_s=walls[1],
                             tokens_per_s=ZOO_BATCH * seq / walls[1],
                             per_forward=per_fwd, launches=measured,
                             flash_by_kernel=kernels,
                             peak_gib=peak / 2**30,
                             serve_steps_per_s=steps / t_serve,
                             serve_peak_gib=serve_peak / 2**30)
        del batch
        t0 = time.perf_counter()
        with torch.inference_mode():
            serve_recs += serve_32k_cells(dev, arch, model, params, fits)
        serve_s += time.perf_counter() - t0
        del params, model
        torch.cuda.empty_cache()
    launches = zoo_launches()
    log(f"[zoo] launches over the phase: {json.dumps(launches)}, flash by "
        f"kernel {json.dumps(flash_by_kernel())}")
    reduced = {arch: f"n_layers {get_config_layers(arch)} -> {layers}"
               for arch, layers, _ in ZOO_RUNS if layers is not None}
    log(f"[zoo] reduced: {json.dumps(reduced)}")
    serve_reduced(serve_recs, serve_s)
    return launches, by_arch, serve_recs, serve_s


def serve_reduced(recs: list, secs: float) -> None:
    """[serve-32k]'s `reduced` line: every cell's cuts from the published
    shape (batch, depth), and the cells' wall."""
    cuts = {f"{r['arch']} {r['kind']}_32k B {r['batch']}": r["cut"]
            for r in recs if r["cut"]}
    log(f"[serve-32k] reduced: {json.dumps(cuts)}; jamba-1.5-large-398b "
        f"not run (one 8-layer period is 90 GB of bf16); {len(recs)} cells "
        f"in {secs:.1f} s")


# ---------------------------------------------------------------------------
# The production serving cells: prefill_32k and decode_32k at S 32768
# ---------------------------------------------------------------------------

# The reference's serving shapes (configs/base.py SHAPES): prefill_32k (S
# 32768, batch 32) and decode_32k (S 32768, batch 128), each step the dry
# run's own (`launch/dryrun.py` `serve_fn`) on real tensors
# (`dryrun.serve_inputs`, from SERVE_SEED).  Every [zoo] arch runs both on
# the weights [zoo] inits (mixtral-8x22b at its 2 layers): prefill at
# batch 1, and SERVE_WIDE_ARCHS also at the largest batch the dry run fits
# on the card (`dryrun.serve_batch`, up to 32), minitron-8b's cut to
# SERVE_PREFILL_CUT for the command's time limit; decode at each arch's
# largest fitting batch (up to 128) for SERVE_DECODE_STEPS steps at
# position S - 1.
SERVE_SEQ = 32768
SERVE_SEED = 7
SERVE_WIDE_ARCHS = ("minitron-8b", "mamba2-370m")
# At the dry run's 13 sequences minitron-8b's prefill allocates within ~6
# GB of an H100's 85 GB, in blocks of 13 GiB: the default allocator runs
# out of memory on fragmentation, and with expandable segments the cell
# takes about twice its device time in the allocator's retries, which
# the command's time limit cannot hold (PERF.md §5; every card-vs-CPU
# depth is already one super-block)
SERVE_PREFILL_CUT = {"minitron-8b": 4}
SERVE_DECODE_STEPS = 8
# a decode step's peak over the bytes of its params and caches (the
# reference donates its caches; the port writes them in place)
SERVE_DECODE_EXCESS = 0.05
SERVE_DRYRUN_WORKERS = 4


def serve_fit(kind: str, arch: str, layers, mesh) -> dict:
    """One arch's serving cell counted by the dry run on `mesh`: the
    prediction at batch 1 (prefill), at the largest batch that fits the
    card (`dryrun.serve_batch`; decode, and prefill for SERVE_WIDE_ARCHS)
    and at the batch run ("run": SERVE_PREFILL_CUT's where it cuts the
    fit), each (batch, argument bytes, peak bytes)."""
    import dataclasses
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    cfg = zoo_config(arch, layers)
    full = SHAPES[f"{kind}_32k"]

    def at(b):
        arg, stats = dryrun.count_cell(
            cfg, dataclasses.replace(full, global_batch=b), mesh, False, 1)
        return b, arg, stats.peak_bytes

    res = {}
    if kind == "prefill":
        res["one"] = at(1)
    if kind == "decode" or arch in SERVE_WIDE_ARCHS:
        res["fit"] = dryrun.serve_batch(cfg, full, mesh)
        cut = SERVE_PREFILL_CUT.get(arch) if kind == "prefill" else None
        res["run"] = (at(cut) if cut and cut < res["fit"][0]
                      else res["fit"])
    return res


def serve_workers_start():
    """The serving cells' CPU work, started in worker processes while the
    card runs the device-timed [zoo-kernels] and [serve-32k-kernels]: the
    dry run's counts of every [zoo] arch's two cells (`dryrun_job`'s
    "serve" jobs, SERVE_DRYRUN_WORKERS processes) and [serve-32k-cpu]'s
    CPU side (`serve_cpu_job`, one process of SERVE_CPU_THREADS threads).
    Returns ({(kind, arch): future}, {arch: future});
    `serve_workers_wait` collects both."""
    import concurrent.futures as cf
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    ex = cf.ProcessPoolExecutor(SERVE_DRYRUN_WORKERS, mp_context=ctx)
    fits = {(kind, arch): ex.submit(dryrun_job, ("serve", kind, arch,
                                                 layers))
            for arch, layers, _ in ZOO_RUNS
            for kind in ("prefill", "decode")}
    ex.shutdown(wait=False)
    ex = cf.ProcessPoolExecutor(1, mp_context=ctx)
    cpu = {arch: ex.submit(serve_cpu_job, arch) for arch in SERVE_CPU_ARCHS}
    ex.shutdown(wait=False)
    return fits, cpu


def serve_workers_wait(workers):
    """Both sets of `serve_workers_start`'s futures collected, so that no
    worker process competes with the host-timed readings that follow
    ([zoo]'s forwards and serve loops, the serving cells' walls and busy
    shares): ({(kind, arch): fit}, {arch: CPU side})."""
    fits, cpu = workers
    t0 = time.perf_counter()
    fits = {key: f.result()[1] for key, f in fits.items()}
    cpu = {arch: f.result() for arch, f in cpu.items()}
    log(f"[serve-32k] waited {time.perf_counter() - t0:.1f} s for the CPU "
        f"workers: the dry run's counts "
        f"{sum(r['worker_s'] for r in fits.values()):.1f} s of work in "
        f"{SERVE_DRYRUN_WORKERS} processes, the card-vs-CPU side "
        f"{sum(r['cpu_s'] for r in cpu.values()):.1f} s in one process of "
        f"{SERVE_CPU_THREADS} threads; none runs from here on")
    return fits, cpu


def serve_cell(dev, arch, model, params, kind: str, batch_size: int,
               pred: tuple, cut: str) -> dict:
    """One [serve-32k] cell: `dryrun.serve_fn` of the `kind` cell at
    batch_size on inputs from `dryrun.serve_inputs`, the zoo kernels'
    counts read around it.  Prefill: one step under the profiler (wall,
    busy share), launches `==` per_forward(cfg), the last token's logits
    finite.  Decode: SERVE_DECODE_STEPS steps, each token `==` the argmax
    of its logits (read through a wrapped `decode_step`) and the logits
    finite, no zoo kernel launched, the peak at most SERVE_DECODE_EXCESS
    over the params and caches; then one step more under the profiler.
    Beside each: the dry run's prediction `pred` (batch, argument bytes,
    peak bytes) and the card's Roofline bound of the cell."""
    import statistics
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.sharding.policies import local_bytes
    cfg = model.cfg
    S, B = SERVE_SEQ, batch_size
    shape = ShapeCfg(f"{kind}_32k", S, B, kind)
    t_cell = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    batch = dryrun.serve_inputs(model, shape, seed=SERVE_SEED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    p_bytes = local_bytes(params)
    in_bytes = local_bytes(batch)
    torch.cuda.reset_peak_memory_stats()
    before = zoo_launches()
    rec = dict(arch=arch, kind=kind, batch=B, seq=S, cut=cut, cfg=cfg)
    if kind == "prefill":
        step = dryrun.serve_fn(model, shape)
        out = []
        t_prof = time.perf_counter()
        wall, rows = profiled(lambda: out.append(step(params, batch)))
        t_prof = time.perf_counter() - t_prof
        logits = out.pop()
        want = (B, 1, cfg.padded_vocab)
        if tuple(logits.shape) != want or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"[serve-32k] {arch} prefill B {B}: logits "
                                 f"{tuple(logits.shape)} (want {want}) or "
                                 f"not finite")
        got = {k: v - before[k] for k, v in zoo_launches().items()}
        if got != per_forward(cfg):
            raise AssertionError(f"[serve-32k] {arch} prefill launched {got},"
                                 f" expected {per_forward(cfg)}")
        n_tok = B * S
        rec.update(wall_s=wall, tokens_per_s=n_tok / wall, launches=got,
                   logit_std=float(logits.float().std()))
        del out, logits
    else:
        seen = []

        def spy(*a):
            res = model.decode_step(*a)
            seen.append(res[0])
            return res
        step = dryrun.serve_fn(model._replace(decode_step=spy), shape)
        walls, tokens = [], []
        for i in range(SERVE_DECODE_STEPS):
            t0 = time.perf_counter()
            tok, caches = step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logits = seen.pop()[:, -1].float()
            if not bool(torch.isfinite(logits).all()) or not torch.equal(
                    tok[:, 0].long(), logits.argmax(-1)):
                raise AssertionError(f"[serve-32k] {arch} decode B {B} step "
                                     f"{i}: logits not finite or the token "
                                     f"not their argmax")
            tokens.append(tok[:, 0].tolist())
            batch = {"token": tok, "caches": caches}
            del logits
        got = {k: v - before[k] for k, v in zoo_launches().items()}
        if any(got.values()):
            raise AssertionError(f"[serve-32k] {arch} decode launched {got}")
        peak_steps = torch.cuda.max_memory_allocated()
        excess = (peak_steps - held) / (p_bytes + in_bytes)
        if excess > SERVE_DECODE_EXCESS:
            raise AssertionError(
                f"[serve-32k] {arch} decode B {B}: peak {peak_steps / 1e9:.3f}"
                f" GB is {excess:.4f} of the params and caches "
                f"({(p_bytes + in_bytes) / 1e9:.3f} GB) above what was held "
                f"before the steps, over {SERVE_DECODE_EXCESS}")
        warm = statistics.median(walls[1:])
        t_prof = time.perf_counter()
        prof_wall, rows = profiled(lambda: seen.append(step(params, batch)))
        t_prof = time.perf_counter() - t_prof
        seen.clear()
        rec.update(wall_s=warm, first_s=walls[0], steps_per_s=1 / warm,
                   tokens_per_s=B / warm, launches=got, excess=excess,
                   tokens=tokens, profiled_step_s=prof_wall)
        wall = prof_wall
    peak = torch.cuda.max_memory_allocated()
    busy = sum(r[0] for r in rows) / 1e6 / wall
    rf = cell_roofline(cfg, S, B, kind)
    step_s = rec["wall_s"]
    if step_s < rf.step_s:
        raise AssertionError(f"[serve-32k] {arch} {kind} B {B}: {step_s} s "
                             f"below its bound {rf.step_s} s")
    dry = pred[1] + pred[2]
    rec.update(peak_gb=peak / 1e9, held_gb=held / 1e9,
               params_gb=p_bytes / 1e9, inputs_gb=in_bytes / 1e9,
               dryrun_gb=dry / 1e9, dryrun_over_peak=dry / peak,
               bound_s=rf.step_s, bound_by=rf.dominant,
               step_over_bound=step_s / rf.step_s, busy=busy,
               profiler_s=t_prof - wall)
    depth = (f"{cfg.n_layers} layers" + (
        f" + {cfg.encoder.n_layers} encoder layers over {S} frames, "
        f"{cfg.encoder.dec_seq} decoder tokens" if cfg.encoder is not None
        and kind == "prefill" else ""))
    if kind == "prefill":
        speed = (f"wall {step_s:.4f} s (profiler on), {rec['tokens_per_s']:.0f}"
                 f" {'frames' if cfg.encoder is not None else 'tokens'}/s, "
                 f"launches {json.dumps(rec['launches'])} == per_forward, "
                 f"last-token logits {(B, 1, cfg.padded_vocab)} finite (std "
                 f"{rec['logit_std']:.3f})")
    else:
        speed = (f"{SERVE_DECODE_STEPS} steps at position {S - 1}: first "
                 f"{rec['first_s']:.4f} s, warm median {step_s:.4f} s "
                 f"({rec['steps_per_s']:.2f} steps/s, "
                 f"{rec['tokens_per_s']:.1f} tokens/s), no zoo kernel "
                 f"launched, logits finite, tokens == their argmax (last "
                 f"step's first {min(B, 8)}: {tokens[-1][:8]}); peak over "
                 f"params + caches {excess:.4f} (bar {SERVE_DECODE_EXCESS})")
    log(f"[serve-32k] {arch} {kind}_32k B={B} S={S} ({depth}"
        f"{'; ' + cut if cut else ''}): {speed};"
        f" peak {peak / 1e9:.2f} GB (params {p_bytes / 1e9:.2f}, inputs "
        f"{in_bytes / 1e9:.2f}), dry run (1, 1) {dry / 1e9:.2f} GB (batch "
        f"{pred[0]}: arguments {pred[1] / 1e9:.2f} + peak "
        f"{pred[2] / 1e9:.2f}) = {dry / peak:.3f} of the peak; Roofline "
        f"bound {rf.step_s:.4f} s ({rf.dominant}), step / bound "
        f"{step_s / rf.step_s:.2f}; busy share {busy:.4f}; the cell "
        f"{time.perf_counter() - t_cell:.2f} s, the profiler's own "
        f"{t_prof - wall:.2f} s of it")
    del batch
    torch.cuda.empty_cache()
    return rec


def serve_32k_cells(dev, arch, model, params, fits) -> list[dict]:
    """[serve-32k]: `arch`'s prefill_32k and decode_32k cells on `params`
    (its [zoo] weights): prefill at batch 1 and, for SERVE_WIDE_ARCHS, at
    the dry run's fitting batch (or SERVE_PREFILL_CUT); decode at its
    fitting batch (`fits`, from `serve_workers_wait`).  Every cut is in
    the cell's record and printed."""
    from repro_torch.configs import SHAPES
    out = []
    pf, dc = fits[("prefill", arch)], fits[("decode", arch)]
    n_full = get_config_layers(arch)
    depth = ([] if model.cfg.n_layers == n_full else
             [f"n_layers {n_full} -> {model.cfg.n_layers}"])

    def cut(kind, fit, run=None):
        full = SHAPES[f"{kind}_32k"].global_batch
        what = [] if fit == full else [
            f"batch {full} -> {fit}, the dry run's largest that fits 80 GB"]
        if run is not None and run < fit:
            what.append(f"batch {fit} -> {run} for the time limit")
        return "; ".join(depth + what)

    out.append(serve_cell(dev, arch, model, params, "prefill", 1, pf["one"],
                          "; ".join(depth + [
                              f"batch {SHAPES['prefill_32k'].global_batch}"
                              f" -> 1"])))
    if "run" in pf and pf["run"][0] > 1:
        out.append(serve_cell(dev, arch, model, params, "prefill",
                              pf["run"][0], pf["run"],
                              cut("prefill", pf["fit"][0], pf["run"][0])))
    out.append(serve_cell(dev, arch, model, params, "decode", dc["fit"][0],
                          dc["fit"], cut("decode", dc["fit"][0])))
    return out

# [serve-32k-kernels]: flash at every shape the prefill_32k cells give it
# at full width (label, arch, S, windowed, S_kv or None for causal):
# minitron-8b's causal hd 128 (llama-3.2-vision-11b's self-attention is
# the same shape), gemma3-12b's global and local (window 1024) layers at
# hd 256, deepseek-moe-16b's (GQA ratio 1), qwen3-32b's and
# phi3-medium-14b's, mixtral-8x22b's window 4096, whisper-large-v3's
# bidirectional encoder at hd 64 over 32768 frames and its decoder's cross
# attention (448 queries over them; its decoder self-attention, S 448, is
# [zoo-kernels]'s shape), llama-3.2-vision-11b's cross attention (32768
# text tokens over 1601 image tokens)
# a graph of this many calls (8-32 ms each at S 32768) and one timed eager
# call of the plain version and of SDPA with a band mask
SERVE_FLASH_REPS = 3
SERVE_FLASH_SHAPES = (
    ("minitron-8b causal", "minitron-8b", SERVE_SEQ, False, None),
    ("gemma3-12b global", "gemma3-12b", SERVE_SEQ, False, None),
    ("gemma3-12b local", "gemma3-12b", SERVE_SEQ, True, None),
    ("deepseek-moe-16b", "deepseek-moe-16b", SERVE_SEQ, False, None),
    ("qwen3-32b", "qwen3-32b", SERVE_SEQ, False, None),
    ("phi3-medium-14b", "phi3-medium-14b", SERVE_SEQ, False, None),
    ("mixtral-8x22b W", "mixtral-8x22b", SERVE_SEQ, True, None),
    ("whisper-large-v3 encoder", "whisper-large-v3", SERVE_SEQ, False,
     SERVE_SEQ),
    ("whisper-large-v3 cross", "whisper-large-v3", WHISPER_TOKENS, False,
     SERVE_SEQ),
    ("llama-3.2-vision-11b cross", "llama-3.2-vision-11b", SERVE_SEQ, False,
     1601))


def phase_serve_kernels(dev, fits) -> dict:
    """[serve-32k-kernels]: the two kernels of the serving cells at S 32768
    against their plain versions on the card: flash at SERVE_FLASH_SHAPES
    within BARS, graph-timed beside its bound and SDPA (`zoo_flash_shape`);
    the SSD scan at mamba2-370m's shape, L 32768, at its prefill cell's
    batch (the dry run's, from `fits`, the futures of
    `serve_workers_start`), the state carried across its 128 chunks,
    within 1e-4 of `ssd_chunked` (held 8 rows at a time), timed with CUDA
    events beside its bound.  Returns both kernels' records."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    flash = [zoo_flash_shape(dev, label, arch, S, windowed, S_kv=S_kv,
                             tag="[serve-32k-kernels]",
                             reps=SERVE_FLASH_REPS, eager_reps=1)
             for label, arch, S, windowed, S_kv in SERVE_FLASH_SHAPES]
    Q = get_config("mamba2-370m").ssm.chunk
    ssd_batch = fits[("prefill", "mamba2-370m")].result()[1]["fit"][0]
    x, b, c, dt, av = ssd_inputs(dev, True, batch=ssd_batch, seq=SERVE_SEQ)
    before = sops.launches["ssd_scan"]
    got = sops.ssd(x, b, c, dt, av, chunk=Q)
    if sops.launches["ssd_scan"] != before + 1:
        raise AssertionError(f"ssd_scan did not launch: {sops.launches}")
    err, rows = 0.0, 8
    for r in range(0, ssd_batch, rows):
        want = ssd_chunked(*(t[r:r + rows] for t in (x, b, c, dt)), av,
                           chunk=Q)
        part = got[r:r + rows]
        if not torch.allclose(part, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"ssd_scan B={ssd_batch} L={SERVE_SEQ} rows "
                                 f"{r}-{r + rows - 1} differ from the plain "
                                 f"version beyond 1e-4: "
                                 f"{max_abs_err(part, want)}")
        err = max(err, max_abs_err(part, want))
        del want, part
    y_max = float(got.abs().max())
    del got
    torch.cuda.empty_cache()
    k_ms = event_ms(lambda: sops.ssd(x, b, c, dt, av, chunk=Q), 3)
    p_ms = event_ms(lambda: ssd_chunked(x, b, c, dt, av, chunk=Q), 1)
    Bz, L, Hs, P = x.shape
    N, nc = b.shape[-1], L // Q
    flops = Bz * (nc * Q * (Q + 1) * N
                  + Hs * (nc * P * Q * (Q + 1) + (nc - 1) * 4 * Q * N * P))
    moved = sum(t.numel() * t.element_size() for t in (x, b, c, dt, av, x))
    b_ms, b_by = min(bound(moved, flops), bound(moved, 3 * flops,
                                                TF32_OPS_PER_S))
    log(f"[serve-32k-kernels] ssd_scan B={Bz} L={L} H={Hs} P={P} N={N} "
        f"chunk={Q} ({nc} chunks, state carried; x {Bz * L * Hs * P} "
        f"elements): max abs err {err:.3g} (tol 1e-4; max |y| {y_max:.3g}); "
        f"kernel {k_ms:.4f} ms/launch (events), plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {flops:.4g} FLOP)")
    del x, b, c, dt, av
    torch.cuda.empty_cache()
    return {"flash_attention": flash,
            "ssd_scan": [dict(B=Bz, L=L, H=Hs, P=P, N=N, chunk=Q,
                              max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=None)]}


# [serve-32k-cpu]: both cells card vs CPU at S 32768 at the SMOKE widths,
# one arch a family: dense, local/global, MoE (with a window), Mamba,
# encoder-decoder, vision; decode at batch SERVE_CPU_DECODE_BATCH.  The CPU
# side (a minute of plain attention over 32768 keys) runs in a worker
# process of SERVE_CPU_THREADS threads while the card runs the
# device-timed kernel phases (`serve_workers_start`); the phase runs the
# card side and holds it to the worker's results.
SERVE_CPU_ARCHS = ("minitron-8b", "gemma3-12b", "mixtral-8x22b",
                   "mamba2-370m", "whisper-large-v3", "llama-3.2-vision-11b")
SERVE_CPU_DECODE_BATCH = 2
SERVE_CPU_SEED = 4
SERVE_CPU_THREADS = 4


def serve_cpu_model(arch: str, dev):
    """`arch`'s SMOKE model on `dev` and its params from SERVE_CPU_SEED
    (drawn on the CPU, so every process and device gets the same bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.testing import tree_to
    cfg = get_config(arch, smoke=True)
    params, _ = build_model(cfg, "cpu").init(SERVE_CPU_SEED)
    return build_model(cfg, dev), tree_to(params, dev)


def serve_cpu_step(model, params, kind: str, batch, routes, mode: str):
    """`dryrun.serve_fn` of one smoke cell under `routes.<mode>()`:
    (prefill's logits or decode's token, decode's logits)."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    B = SERVE_CPU_DECODE_BATCH if kind == "decode" else 1
    shape = ShapeCfg(f"{kind}_32k", SERVE_SEQ, B, kind)
    seen = []

    def decode_step(*a):
        out = model.decode_step(*a)
        seen.append(out[0])
        return out
    spy = model._replace(decode_step=decode_step)
    with torch.inference_mode(), getattr(routes, mode)():
        out = dryrun.serve_fn(spy, shape)(params, batch)
    return (out, None) if kind == "prefill" else (out[0], seen[0])


def serve_cpu_inputs(cfg, kind: str):
    """The smoke cell's inputs from SERVE_SEED, drawn on the CPU."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    B = SERVE_CPU_DECODE_BATCH if kind == "decode" else 1
    return dryrun.serve_inputs(build_model(cfg, "cpu"), ShapeCfg(
        f"{kind}_32k", SERVE_SEQ, B, kind), seed=SERVE_SEED)


def serve_cpu_job(arch: str) -> dict:
    """The CPU side of one [serve-32k-cpu] arch, in a worker process: both
    cells' outputs, decode's logits and each cell's MoE routes."""
    import time as _time
    import torch
    from repro_torch.testing import RouteReplay
    torch.set_num_threads(SERVE_CPU_THREADS)
    t0 = _time.perf_counter()
    model, params = serve_cpu_model(arch, "cpu")
    out = {}
    for kind in ("prefill", "decode"):
        routes = RouteReplay()
        res, logits = serve_cpu_step(model, params, kind,
                                     serve_cpu_inputs(model.cfg, kind),
                                     routes, "record")
        out[kind] = dict(out=res, logits=logits, routes=list(routes.queue))
    out["cpu_s"] = _time.perf_counter() - t0
    return out


def phase_serve_cpu(dev, cpu_side: dict) -> None:
    """[serve-32k-cpu]: the prefill_32k and decode_32k cells
    (`dryrun.serve_fn` on `dryrun.serve_inputs`) of SERVE_CPU_ARCHS at
    their SMOKE widths and S 32768 on the card (the hd-16 mma.sync flash
    kernel over 32768 keys, the SSD scan over 128 chunks) against the
    port's CPU path (`serve_cpu_job`, in `cpu_side`) on the same weights and
    inputs, MoE layers on the CPU run's routes: prefill's last-token
    logits and decode's logits within the zoo's bf16 bar, decode's greedy
    tokens `==` wherever the CPU's top-2 margin exceeds the bar."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.testing import BF16_RTOL, RouteReplay, hold_bf16, \
        tree_to
    for arch in SERVE_CPU_ARCHS:
        cfg = get_config(arch, smoke=True)
        model, params = serve_cpu_model(arch, dev)
        cpu = cpu_side[arch]
        words = []
        for kind, B in (("prefill", 1), ("decode", SERVE_CPU_DECODE_BATCH)):
            want = cpu[kind]
            routes, kb = RouteReplay(), flash_by_kernel()
            for idx in want["routes"]:
                routes.push(idx)
            got, logits = serve_cpu_step(
                model, params, kind,
                tree_to(serve_cpu_inputs(cfg, kind), dev), routes,
                "replay")
            torch.cuda.synchronize()
            kernels = {k: v - kb[k] for k, v in flash_by_kernel().items()
                       if v - kb[k]}
            what = f"{arch} smoke {kind}_32k B {B}"
            if kind == "prefill":
                verdict = hold_bf16(got, want["out"], what)
            else:
                verdict = hold_bf16(logits, want["logits"], what)
                w = want["logits"][:, -1].float()
                top2 = w.topk(2, dim=-1).values
                atol = BF16_RTOL * float(w.abs().max())
                sure = (top2[:, 0] - top2[:, 1]) > atol + BF16_RTOL * \
                    top2[:, 0].abs()
                tok, ref = got[:, 0].cpu(), want["out"][:, 0]
                if not torch.equal(tok[sure], ref[sure]):
                    raise AssertionError(f"{what}: tokens {tok.tolist()} "
                                         f"against {ref.tolist()}")
                verdict += (f"; tokens {tok.tolist()} == the CPU's on "
                            f"{int(sure.sum())}/{len(tok)} sure rows")
            words.append(f"{kind} B {B}: {verdict}; {routes.check(what)}; "
                         f"flash by kernel {json.dumps(kernels)}")
        log(f"[serve-32k-cpu] {arch} smoke (hd {cfg.attn.head_dim}, "
            f"{cfg.n_layers} layers) at S {SERVE_SEQ}, card vs CPU: "
            + "; ".join(words) + f"; CPU side {cpu['cpu_s']:.1f} s in its "
            f"worker ({SERVE_CPU_THREADS} threads)")
        del params, model
        torch.cuda.empty_cache()


def phase_serve_32k(dev, fits) -> tuple[dict[str, int], list, float]:
    """`--serve-32k` alone: each [zoo] arch inited as [zoo] inits it, then
    its [serve-32k] cells, the zoo kernels' counts zeroed just before and
    read just after."""
    import torch
    from repro_torch.models import build_model
    reset_zoo_launches()
    recs, secs = [], 0.0
    for arch, layers, _ in ZOO_RUNS:
        model = build_model(zoo_config(arch, layers), dev)
        params, _ = model.init(0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            recs += serve_32k_cells(dev, arch, model, params, fits)
        secs += time.perf_counter() - t0
        del params, model
        torch.cuda.empty_cache()
    serve_reduced(recs, secs)
    launches = zoo_launches()
    log(f"[serve-32k] launches over the cells: {json.dumps(launches)}")
    return launches, recs, secs


def get_config_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).n_layers


# card vs CPU: (arch, layers, S) at full width, B 1; the depth cut to one
# super-block (gemma3-12b's is 6 layers; deepseek-moe-16b's 2 are its dense
# first layer and one MoE layer; llama-3.2-vision-11b's 5 are one 'C' and
# four 'A' layers, over its 1601 image tokens), whisper-large-v3 to 1
# encoder and 1 decoder layer at its 1500 frames and 448 tokens.
ZOO_CPU_RUNS = (("minitron-8b", 1, 256), ("mamba2-370m", 1, 256),
                ("gemma3-12b", 6, 256), ("deepseek-moe-16b", 2, 256),
                ("qwen3-32b", 1, 256), ("phi3-medium-14b", 1, 256),
                ("mixtral-8x22b", 1, 256),
                ("whisper-large-v3", 1, WHISPER_TOKENS),
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
        params, _ = card.init(1)
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
        params, _ = card.init(2)
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
    mp, _ = moe.init_moe(gen, cfg.d_model, cfg.moe)
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
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.threefry import ops as tops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode, run_program
    from repro_torch.nmp.stats import summarize
    from repro_torch.nmp.traces import make_trace
    cfg = NMPConfig()
    tr = make_trace("BP", n_ops=BP_OPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_aimm_launches()
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
    launches = {}
    for ops in aimm_kernel_ops():
        launches.update(ops.launches)
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
                          sorted(tops.launches_by_mode.items())},
             "td_grad": {f"launches_{k.replace('=', '').replace(' ', '_')}":
                         c for k, c in sorted(gops.launches_by_shape.items())}}
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
    # the TD step: one td_grad and one adamw_lanes launch a step, no
    # batched_linear product (the paper's network is the kernel's shape)
    assert launches["td_grad"] == launches["adamw_lanes"] > 0, launches
    assert launches["batched_linear"] == 0, launches
    rates = {"bnmp/aimm": 2 * 128 / t_prog, "pei/tom": 128 / t_tom}
    # the TOM scorer's count on the main path: its scorings in any form
    launches["tom_scores"] += launches.pop("tom_scores_folded")
    return launches, split, rates


def figure_grid(aimm_episodes: int = GRID_AIMM_EPISODES,
                eval_episode: bool = True,
                mappers: tuple[str, ...] = ("none", "tom", "aimm"),
                n_ops: int = BP_OPS):
    """benchmarks/common.py figure_grid at `n_ops` ops with three seeds."""
    from repro_torch.nmp import scenarios
    return scenarios.build("single", apps=GRID_APPS, techniques=GRID_TECHS,
                           mappers=mappers, n_ops=n_ops, seeds=GRID_SEEDS,
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
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.sweep import run_grid, run_grid_serial
    cfg = NMPConfig()
    grid = figure_grid()
    assert len(grid) == 135, len(grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_aimm_launches()
    t0 = time.perf_counter()
    res = run_grid(grid, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = {}, {}
    for ops in aimm_kernel_ops():
        launches.update(ops.launches)
        name = next(iter(ops.launches))
        if name != "batched_linear":
            shapes[name] = dict(ops.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()
    for k in AIMM_PATH_KERNELS + ("tom_scores_folded",):
        if not launches[k] > 0:
            raise AssertionError(f"run_grid launched no {k}: {launches}")
    assert launches["tom_scores"] == 0 == launches["batched_linear"], \
        launches
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
    from repro_torch.kernels.adamw_lanes import ops as aops
    from repro_torch.kernels.batched_linear import ops as lops
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.td_grad import ops as gops
    from repro_torch.kernels.threefry import ops as tops
    return eops, qops, tops, lops, gops, aops


# the kernels every learned AIMM path launches (the TD step's products
# `batched_linear` only for network shapes `td_grad` does not cover)
AIMM_PATH_KERNELS = ("fused_epoch", "dueling_qnet", "threefry", "td_grad",
                     "adamw_lanes")


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
        for k in AIMM_PATH_KERNELS:
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
    for k in AIMM_PATH_KERNELS:
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


# ---------------------------------------------------------------------------
# The partition layer: the sweep, the stream and the server over ranks
# ---------------------------------------------------------------------------

# [mesh]: the figure grid (its 135 cells, seeds 0-2, so S = 3 pads on seed
# dims 2 and 4) at MESH_OPS ops, cut from BP_OPS to keep the phase near 90 s,
# on 4 ranks sharing the one card, under each REPRO_SWEEP_MESH; then on 2
# ranks the switch stream (cut to MESH_STREAM_OPS ops per app and
# MESH_STREAM_EPISODES episodes), a fleet through the MappingServer, and the
# shrink drill 2 -> 1
MESH_OPS = 4096
MESH_SHAPES = ("4x1", "2x2", "1x4", "auto")
MESH_RANKS = 4
MESH_STREAM_OPS = 2048
MESH_STREAM_EPISODES = 2
MESH_FLEET = 8                 # tenants, 2 phases, 1024 ops per app
MESH_SLOTS = 4
MESH_SPOT = ("t000", "t003", "t004", "t007")
MESH_TIMEOUT_S = 420           # a job's limit: past it, or once one rank
                               # fails, every rank is killed


def mesh_stream():
    from repro_torch.nmp.scenarios import continual_stream
    return continual_stream(n_ops_per_app=MESH_STREAM_OPS,
                            episodes=MESH_STREAM_EPISODES, technique="bnmp")


def mesh_fleet():
    from repro_torch.nmp.scenarios import tenant_fleet
    return tenant_fleet(n_tenants=MESH_FLEET, n_phases=2,
                        n_ops_per_app=FLEET_N_OPS)


def mesh_drill_fleet():
    from repro_torch.nmp.scenarios import tenant_fleet
    return tenant_fleet(n_tenants=2, apps=("KM", "SC"), n_phases=3,
                        n_ops_per_app=DRILL_N_OPS)


class Served:
    """A served fleet as the hold functions read it: `tenant(tid).results`
    of (result with `.metrics`/`.actions` of one lane, 0)."""

    def __init__(self, tenants: dict):
        import types
        self._t = {tid: types.SimpleNamespace(results=[
            (types.SimpleNamespace(metrics=m, actions=a), 0)
            for m, a in phases]) for tid, phases in tenants.items()}

    def tenant(self, tid):
        return self._t[tid]


def served_record(srv) -> dict:
    """Every tenant's served phases, one lane each (metrics, actions), and
    the server's stats."""
    tenants = {}
    for tid, t in srv._tenants.items():
        tenants[tid] = [({k: v[lane:lane + 1] for k, v in res.metrics.items()},
                         res.actions[lane:lane + 1]) for res, lane in t.results]
    return {"tenants": tenants, "stats": srv.stats()}


def serve_fleet(dev, fleet, n_slots: int, faults=None) -> dict:
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.serving import MappingServer
    srv = MappingServer(NMPConfig(), n_slots=n_slots, faults=faults,
                        backoff_base_s=0.001, device=dev)
    for tid, stream in fleet.items():
        srv.submit(tid, stream)
    srv.run()
    return served_record(srv)


def shrink_plan():
    from repro_torch.nmp.faults import FaultEvent, FaultPlan
    return FaultPlan([FaultEvent("shrink_devices", at=1, keep_devices=1)])


def measured(fn, *args) -> tuple:
    """fn(*args) with this process's kernel counts set to 0 just before and
    read just after: (result, wall s, launches, peak device bytes)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_aimm_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, aimm_launches(),
            torch.cuda.max_memory_allocated())


def mesh_grid_job(dev) -> dict:
    """A rank's part of the grid job: the figure grid under each mesh
    shape (a small grid first, so no shape pays the first launches)."""
    import os
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.sweep import run_grid
    cfg = NMPConfig()
    grid = figure_grid(n_ops=MESH_OPS)
    run_grid(figure_grid(aimm_episodes=1, eval_episode=False, n_ops=256)[:12],
             cfg, device=dev)
    recs = {}
    for shape in MESH_SHAPES:
        os.environ["REPRO_SWEEP_MESH"] = shape
        res, wall, launches, peak = measured(lambda: run_grid(grid, cfg, device=dev))
        recs[shape] = {"metrics": res.metrics, "actions": res.actions,
                       "n_devices": res.n_devices,
                       "mesh_shape": res.mesh_shape, "wall": wall,
                       "launches": launches, "peak": peak}
    return recs


def mesh_serve_job(dev, ck: str) -> dict:
    """A rank's part of the serving job: the switch stream through
    `run_stream` (rank 0 writes its checkpoints, every rank restores the
    last), the fleet through the MappingServer, and the shrink drill."""
    import numpy as np
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import PolicyStore, run_stream
    from repro_torch.nmp.engine import default_agent_cfg
    cfg = NMPConfig()
    full, wall_s, launch_s, peak_s = measured(
        lambda: run_stream(mesh_stream(), cfg, checkpoint_dir=ck,
                           device=dev))
    restored = PolicyStore.restore(ck, default_agent_cfg(cfg))
    snap = lambda st: agent_mod.map_snapshot(np.asarray, st.get("stream"))
    fleet, wall_f, launch_f, peak_f = measured(
        serve_fleet, dev, mesh_fleet(), MESH_SLOTS)
    drill = serve_fleet(dev, mesh_drill_fleet(), 2, shrink_plan())
    return {"stream": [(r.metrics, r.actions) for r in full.phases],
            "store": snap(full.store), "restored": snap(restored),
            "fleet": fleet, "drill": drill,
            "wall": {"stream": wall_s, "fleet": wall_f},
            "launches": {"stream": launch_s, "fleet": launch_f},
            "peak": max(peak_s, peak_f)}


def mesh_rank(job: str, out: str) -> int:
    """The body of one rank process of `[mesh]` (started by `run_ranks`
    with the REPRO_DIST_* knobs): join the group, run the job on this
    rank's card, write its record."""
    import pickle
    import torch
    from repro_torch.nmp import partition
    assert partition.maybe_init_distributed()
    _, rank = partition.world()
    dev = partition.rank_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = (mesh_grid_job(dev) if job == "grid"
           else mesh_serve_job(dev, str(Path(out) / "ck")))
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    partition.barrier()
    return 0


def run_ranks(job: str, world: int) -> list[dict]:
    """Start `world` rank processes of `job` on this machine's card(s) in a
    gloo group on localhost, wait for all, and read their records.  Any
    rank failing (or the limit passing) stops every rank and fails."""
    import os
    import pickle
    import shutil
    out = ROOT / "build" / f"mesh_{job}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, REPRO_DIST_COORD=f"127.0.0.1:{_free_port()}",
               REPRO_DIST_NPROCS=str(world),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    for k in ("REPRO_SWEEP_MESH", "REPRO_SWEEP_DEVICES", "LOCAL_RANK"):
        env.pop(k, None)
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--mesh-rank", job, str(out)],
                              env=dict(env, REPRO_DIST_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"rank {r} (rc {rc}): ..."
                          + (out / f"rank{r}.log").read_text()[-1500:]
                          for r, rc in enumerate(rcs) if rc)
        raise AssertionError(f"[mesh] {job} on {world} ranks failed, rcs "
                             f"{rcs}:\n{tails}")
    recs = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs


def same_arrays(a: dict, b: dict, lane=slice(None)) -> bool:
    import numpy as np
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k][lane], b[k][lane])
        for k in a)


def phase_mesh(dev) -> dict[str, dict]:
    """The sweep, the stream and the server over a mesh of rank processes
    on the card (several ranks share it here), each held to one rank on
    the same card: the figure grid on 4 ranks under every mesh shape
    (deterministic lanes `==`, learned lanes `==` or by 5b's near-tie rule),
    then on 2 ranks the switch stream, a fleet (every tenant `==` to one
    rank, 4 tenants held to `solo_stream`) and the shrink drill 2 -> 1
    (every tenant `==` to the fault-free run).  Returns each kernel's
    launches by rank."""
    import types
    import numpy as np
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import run_stream
    from repro_torch.nmp.sweep import run_grid
    cfg = NMPConfig()
    card = card_line()
    grid = figure_grid(n_ops=MESH_OPS)
    one, wall1, launch1, peak1 = measured(lambda: run_grid(grid, cfg, device=dev))
    t0 = time.perf_counter()
    ranks = run_ranks("grid", MESH_RANKS)
    t_ranks = time.perf_counter() - t0
    learned = [i for i, sc in enumerate(grid) if sc.mapper == "aimm"]
    log(f"[mesh] figure grid at {MESH_OPS} ops ({len(grid)} cells, seeds "
        f"{GRID_SEEDS}) on one rank: {wall1:.3f} s, peak "
        f"{peak1 / 2**20:.1f} MiB; on {MESH_RANKS} ranks sharing this one "
        f"card ({card}), {t_ranks:.1f} s for the ranks' processes in all "
        "(start, warm-up, four shapes); the ranks share the card and the "
        "host's cores, so these walls say nothing of scaling over cards")
    by_rank = {f"rank{r}": {} for r in range(MESH_RANKS)}
    for shape in MESH_SHAPES:
        recs = [r[shape] for r in ranks]
        rec = recs[0]
        for r, other in enumerate(recs[1:], 1):
            if not (same_arrays(other["metrics"], rec["metrics"])
                    and np.array_equal(other["actions"], rec["actions"])):
                raise AssertionError(f"[mesh] {shape}: rank {r}'s whole "
                                     "result differs from rank 0's")
        want = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}.get(shape)
        if rec["n_devices"] != MESH_RANKS or (
                want and tuple(rec["mesh_shape"]) != want):
            raise AssertionError(f"[mesh] {shape}: n_devices "
                                 f"{rec['n_devices']}, shape "
                                 f"{rec['mesh_shape']}")
        eq, held = 0, []
        for i, sc in enumerate(grid):
            same = (same_arrays(rec["metrics"], one.metrics, i)
                    and np.array_equal(rec["actions"][i], one.actions[i]))
            if i not in learned:
                if not same:
                    raise AssertionError(f"[mesh] {shape} {sc.name}: a "
                                         "deterministic lane differs from "
                                         "one rank")
                continue
            if same:
                eq += 1
                continue
            res = types.SimpleNamespace(metrics=rec["metrics"],
                                        actions=rec["actions"])
            held.append(f"{sc.name}: {hold_learned_lane(dev, res, i, sc, cfg)}")
        for r, rr in enumerate(recs):
            for k, n in rr["launches"].items():
                by_rank[f"rank{r}"][k] = by_rank[f"rank{r}"].get(k, 0) + n
        log(f"[mesh] {shape} -> mesh {tuple(rec['mesh_shape'])}: "
            f"{len(grid) - len(learned)} deterministic cells ==, learned "
            f"cells == to one rank {eq}/{len(learned)}"
            + (f", the rest held to their serial runs by 5b's rule: "
               f"{'; '.join(held)}" if held else "")
            + f"; walls by rank {[round(x['wall'], 3) for x in recs]} s, "
            f"peak MiB by rank {[round(x['peak'] / 2**20, 1) for x in recs]}"
            f", launches by rank {json.dumps([x['launches'] for x in recs])}")

    stream = mesh_stream()
    full1 = run_stream(stream, cfg, device=dev)
    fleet = mesh_fleet()
    fleet1, wall_f1, _, _ = measured(serve_fleet, dev, fleet, MESH_SLOTS)
    clean = serve_fleet(dev, mesh_drill_fleet(), 2)
    t0 = time.perf_counter()
    pair = run_ranks("serve", 2)
    t_pair = time.perf_counter() - t0
    for r, rec in enumerate(pair):
        for pi, (m, a) in enumerate(rec["stream"]):
            want = full1.phases[pi]
            if not (same_arrays(m, want.metrics)
                    and np.array_equal(a, want.actions)):
                raise AssertionError(f"[mesh] rank {r}: run_stream phase "
                                     f"{pi} differs from one rank")
        want_snap = agent_mod.map_snapshot(np.asarray,
                                           full1.store.get("stream"))
        if not (same_snapshot(rec["store"], want_snap)
                and same_snapshot(rec["restored"], want_snap)):
            raise AssertionError(f"[mesh] rank {r}: the stream's store (or "
                                 "the one restored from rank 0's "
                                 "checkpoint) differs from one rank's")
        for name, got, want in (("fleet", rec["fleet"], fleet1),
                                ("shrink drill", rec["drill"], clean)):
            for tid, phases in want["tenants"].items():
                g = got["tenants"][tid]
                if len(g) != len(phases) or not all(
                        same_arrays(gm, wm) and np.array_equal(ga, wa)
                        for (gm, ga), (wm, wa) in zip(g, phases)):
                    raise AssertionError(f"[mesh] rank {r} {name}: tenant "
                                         f"{tid} differs from one rank")
        st = rec["drill"]["stats"]
        if (st["faults"]["device_shrinks"], st["n_devices"]) != (1, 1):
            raise AssertionError(f"[mesh] rank {r}: shrink drill {st}")
        if rec["fleet"]["stats"]["n_devices"] != 2:
            raise AssertionError(f"[mesh] rank {r}: fleet on "
                                 f"{rec['fleet']['stats']['n_devices']}")
        for part in ("stream", "fleet"):
            for k, n in rec["launches"][part].items():
                by_rank[f"rank{r}"][k] = by_rank[f"rank{r}"].get(k, 0) + n
    served = Served(pair[0]["fleet"]["tenants"])
    holds = [f"{tid} {hold_tenant(dev, cfg, served, tid, fleet[tid])}"
             for tid in MESH_SPOT]
    st = pair[0]["fleet"]["stats"]
    log(f"[mesh] 2 ranks ({t_pair:.1f} s for the ranks' processes): the "
        f"switch stream ({MESH_STREAM_OPS} ops per app, "
        f"{MESH_STREAM_EPISODES} episodes) through run_stream, every phase "
        f"and the store == one rank, rank 0's checkpoints restored on both "
        f"==; walls by rank {[round(p['wall']['stream'], 3) for p in pair]} "
        f"s")
    log(f"[mesh] 2 ranks: {MESH_FLEET} tenants x 2 phases on "
        f"{st['n_slots']} slots (mesh {st['n_devices']} ranks), every "
        f"tenant == one rank ({wall_f1:.3f} s there); walls by rank "
        f"{[round(p['wall']['fleet'], 3) for p in pair]} s, ticks "
        f"{st['ticks']}, p50 {st['phase_latency_p50_s']!r} s; against "
        f"solo_stream: {'; '.join(holds)}")
    log(f"[mesh] 2 ranks: shrink drill 2 -> 1 at attempt 1 (2 tenants x 3 "
        f"phases, 2 slots): device_shrinks 1, n_devices 1 after, every "
        f"tenant == the fault-free run; peak MiB by rank "
        f"{[round(p['peak'] / 2**20, 1) for p in pair]}")
    log(f"[mesh] launches by rank (grid shapes, stream and fleet): "
        f"{json.dumps(by_rank)} ({card})")
    for r, counts in by_rank.items():
        for k in AIMM_PATH_KERNELS:
            if not counts.get(k):
                raise AssertionError(f"[mesh] {r} launched no {k}")
    return by_rank


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
    ZOO_ARCHS at its ZOO_PROFILE_LAYERS depth, after their timed runs:
    device busy share, launches, and the top kernels by device time."""
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    for arch in ZOO_ARCHS:
        cfg = zoo_config(arch, ZOO_PROFILE_LAYERS[arch])
        model = build_model(cfg, dev)
        params, _ = model.init(0)
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
            log(f"[zoo-profile] {arch} ({cfg.n_layers} of "
                f"{get_config_layers(arch)} layers) {what}: wall "
                f"{wall * 1e3:.1f} ms "
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
# The first cell once more with remat "none" (the configs' default is
# "block"), 3 steps without checkpoints: comparable with runs made before
# the training step honoured the configs' remat.
TRAIN_NO_REMAT = ("minitron-8b", 4)
# The rest of the single-card zoo's training cells: 3 steps each, no
# checkpoint and no restart drill, S 4096 (whisper-large-v3: 448 tokens over
# 1500 frames; llama-3.2-vision-11b over its 1601 image tokens), global batch
# 2 in 2 microbatches, AdamW with f32 moments.  At 16 B a parameter
# (bf16 params 2, a microbatch's bf16 gradients 2 and their f32 sum 4, f32
# moments 8) the full depth of
# gemma3-12b (~188 GB), llama-3.2-vision-11b (~162 GB) and deepseek-moe-16b
# (~262 GB) exceeds the card, so each keeps one period: gemma3 6 of 48
# layers (5 local : 1 global), llama-vision 5 of 40 (one 'C', four 'A'),
# deepseek 4 of 28 (the dense first layer and 3 MoE layers); whisper trains
# at full depth (32 + 32 layers).  qwen3-32b (~524 GB at full depth) and
# phi3-medium-14b (~235 GB) are causal with no window at hd 128, GQA 64 / 8
# and 40 / 10: each keeps the deepest cut whose state fits at the ~19 B a
# parameter the cells above peaked at, 4 of 64 layers (3.506 B
# parameters, ~62 GiB) and 8 of 40 (3.754 B, ~67 GiB).
# (arch, layers or None, entry):
# "train" is launch/train.py's `train` (tokens and labels), "step"
# `make_train_step` on batches with the stubbed frontend's output (the
# reference's data pipeline yields none).
TRAIN_FAMILY_RUNS = (("gemma3-12b", 6, "train"),
                     ("whisper-large-v3", None, "step"),
                     ("llama-3.2-vision-11b", 5, "step"),
                     ("deepseek-moe-16b", 4, "train"),
                     ("qwen3-32b", 4, "train"),
                     ("phi3-medium-14b", 8, "train"))
TRAIN_FAMILY_STEPS = 3
# card vs CPU, one step's loss and gradients (no optimizer step), B 1:
# (arch, layers, S); at full width, the depth of [zoo-cpu] (gemma3-12b's 6
# layers hold its global hd-256 layer; whisper-large-v3 1 + 1 at 1500 frames
# and 448 tokens; llama-3.2-vision-11b's 5 one 'C' and four 'A' over 1601
# image tokens; deepseek-moe-16b's 2 the dense first layer and one MoE
# layer, on the card's routes)
TRAIN_CPU_RUNS = (("minitron-8b", 1, 256), ("mamba2-370m", 1, 256),
                  ("gemma3-12b", 6, 256),
                  ("whisper-large-v3", 1, WHISPER_TOKENS),
                  ("llama-3.2-vision-11b", 5, 256),
                  ("deepseek-moe-16b", 2, 256))


# The flash backward's other variants at the zoo's full shapes, bf16, B 1:
# (label, arch, S, S_kv or None for causal, windowed).  gemma3-12b's global
# and local layers (hd 256, window 1024), whisper-large-v3's encoder (non-
# causal, S 1500) and cross attention (448 x 1500), llama-3.2-vision-11b's
# cross attention (4096 x 1601, GQA 32 / 8), mixtral-8x22b's 'W' layer
# (S 8192, window 4096, GQA 48 / 8), and the causal layers of qwen3-32b (H
# 64, K 8) and phi3-medium-14b (H 40, K 10) at S 4096, whisper-large-v3's
# decoder (S 448, H = K = 20, hd 64) and deepseek-moe-16b (H = K = 16).
TRAIN_FLASH_SHAPES = (
    ("gemma3-12b global", "gemma3-12b", ZOO_SEQ, None, False),
    ("gemma3-12b local", "gemma3-12b", ZOO_SEQ, None, True),
    ("whisper-large-v3 encoder", "whisper-large-v3", WHISPER_FRAMES,
     WHISPER_FRAMES, False),
    ("whisper-large-v3 cross", "whisper-large-v3", WHISPER_TOKENS,
     WHISPER_FRAMES, False),
    ("llama-3.2-vision-11b cross", "llama-3.2-vision-11b", ZOO_SEQ, 1601,
     False),
    ("mixtral-8x22b W", "mixtral-8x22b", MIXTRAL_SEQ, None, True),
    ("qwen3-32b", "qwen3-32b", ZOO_SEQ, None, False),
    ("phi3-medium-14b", "phi3-medium-14b", ZOO_SEQ, None, False),
    ("whisper-large-v3 decoder", "whisper-large-v3", WHISPER_TOKENS, None,
     False),
    ("deepseek-moe-16b", "deepseek-moe-16b", ZOO_SEQ, None, False))
# each variant in f32 at one small shape: (label, B, S, S_kv, H, K, hd,
# causal, window)
TRAIN_FLASH_F32 = (("window", 1, 700, 700, 4, 2, 128, True, 100),
                   ("non-causal", 1, 500, 500, 4, 4, 64, False, 0),
                   ("S_kv != S", 2, 200, 700, 4, 2, 64, False, 0),
                   ("hd 256", 1, 500, 500, 4, 2, 256, True, 0),
                   ("hd 256 window", 1, 500, 500, 4, 2, 256, True, 128))


# The flash backward at the smoke configs' head dims, 16 and 32 (bf16 on
# mma.sync, f32 on CUDA cores), each mask at the shapes of
# tests/test_torch_backward.py's cases: (label, B, S, S_kv, H, K, causal,
# window); then bf16 timed at minitron-8b's attention shape cut to each
# width.
TRAIN_FLASH_SMOKE = (("causal", 1, 1024, 1024, 4, 2, True, 0),
                     ("window 32", 1, 1024, 1024, 4, 2, True, 32),
                     ("S_kv < S", 1, 1000, 300, 4, 2, False, 0),
                     ("S_kv > S", 1, 300, 1000, 4, 2, False, 0),
                     ("ragged S", 2, 1000, 1000, 4, 2, True, 0))
TRAIN_FLASH_SMOKE_HDS = (16, 32)
def flash_grads_plain(q, k, v, do, causal: bool = True, window: int = 0):
    """`attention_grads_ref` one KV head's query heads at a time, so the f32
    scores and their gradients of S 8192 stay a few GB: dq, dk, dv."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_grads_ref
    H, K = q.shape[2], k.shape[2]
    rep = H // K
    parts = [attention_grads_ref(
        q[:, :, j * rep:(j + 1) * rep], k[:, :, j:j + 1], v[:, :, j:j + 1],
        do[:, :, j * rep:(j + 1) * rep], causal=causal, window=window)[1:]
        for j in range(K)]
    return [torch.cat([p[i] for p in parts], dim=2) for i in range(3)]


def sdpa_backward_ms(q, k, v, do, causal: bool, window: int):
    """Device ms of SDPA's backward (its forward plus backward, less its
    forward, CUDA events over 10 calls each) on the same inputs: the flash
    backend where it takes the variant, else the default backend with a
    boolean band mask on K / V expanded to the query heads (as row 4 times
    a windowed forward).  Returns (ms, which)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention.ref import visible
    H, K = q.shape[2], k.shape[2]
    qt = q.detach().transpose(1, 2).requires_grad_()
    dot = do.transpose(1, 2)
    if window:
        kt, vt = (t.detach().repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .requires_grad_() for t in (k, v))
        band = visible(q.shape[1], k.shape[1], window, q.device)
        kw = dict(attn_mask=band)
        backend, which = None, "SDPA backward, default backend, band mask"
    else:
        kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (k, v))
        kw = dict(is_causal=causal, enable_gqa=True)
        backend, which = SDPBackend.FLASH_ATTENTION, (
            "SDPA backward, flash backend")
    ctx = (lambda: sdpa_kernel(backend)) if backend else contextlib.nullcontext

    def fb():
        with ctx():
            out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
            torch.autograd.grad(out, (qt, kt, vt), dot)

    def f():
        with ctx(), torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, **kw)
    try:
        ms = event_ms(fb, 10) - event_ms(f, 10)
    except RuntimeError:
        if backend is None:
            raise
        # the flash backend refuses the variant: the default backend
        ctx, which = contextlib.nullcontext, "SDPA backward, default backend"
        ms = event_ms(fb, 10) - event_ms(f, 10)
    return ms, which


def train_flash_shape(dev, label: str, arch: str, S: int, S_kv, windowed):
    """One of TRAIN_FLASH_SHAPES: the backward kernels' gradients against
    `flash_grads_plain` within GRAD_BARS, two runs torch.equal, a launch
    timed from a CUDA graph beside its bound (2.5 x the forward's FLOP over
    the visible pairs at the bf16 tensor-core rate, or the bytes) and SDPA's
    backward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (GRAD_BARS,
                                                         compare_grad)
    a = get_config(arch).attn
    H, K, hd = a.n_heads, a.n_kv, a.head_dim
    window = a.window if windowed else 0
    causal = S_kv is None
    S_kv = S if causal else S_kv
    scale = hd ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(S + S_kv + hd + window)
    q, k, v, do = (torch.randn((1, n_s, n, hd), generator=gen,
                               device=dev).bfloat16()
                   for n_s, n in ((S, H), (S_kv, K), (S_kv, K), (S, H)))
    flash = lambda q, k, v: fops.gqa_flash_attention_kv(
        q, k, v, causal=causal, window=window)
    before = fops.launches["flash_attention_bwd"]
    runs = [_kernel_grads(flash, (q, k, v), do) for _ in range(2)]
    torch.cuda.synchronize()
    if fops.launches["flash_attention_bwd"] != before + 2:
        raise AssertionError(f"flash backward {label}: launches "
                             f"{fops.launches}")
    if not all_equal(runs[0], runs[1]):
        raise AssertionError(f"flash backward {label}: two card runs differ")
    want = flash_grads_plain(q, k, v, do, causal, window)
    cmps = {n: compare_grad(g, w) for n, g, w in
            zip(("dq", "dk", "dv"), runs[0], want)}
    if not all(c["ok"] for c in cmps.values()):
        raise AssertionError(f"flash backward {label} beyond "
                             f"{GRAD_BARS[torch.bfloat16]}: {cmps}")
    del runs, want
    lse = torch.empty((1, H, S), dtype=torch.float32, device=dev)
    o = fops._forward(q, k, v, scale, causal, window, lse)
    k_ms = graph_ms(lambda: fops.flash_backward(q, k, v, o, lse, do, scale,
                                                causal, window), 5)
    lib_ms, lib = sdpa_backward_ms(q, k, v, do, causal, window)
    pairs = H * (visible_pairs(S, window) if causal else S * S_kv)
    flops = 2.5 * 4 * hd * pairs
    nbytes = sum(t.numel() * t.element_size()
                 for t in (q, k, v, o, do, lse, q, k, v))   # + dq, dk, dv
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
    mask = (f"causal, window {window}" if window else
            "causal" if causal else "non-causal")
    log(f"[train-kernels] flash_attention_bwd bf16 {label}: B=1 S={S} "
        f"S_kv={S_kv} H={H} K={K} hd={hd} {mask}: "
        + ", ".join(f"{n} max abs err {c['max_abs_err']:.3g} rel L2 "
                    f"{c['rel_l2']:.3g}" for n, c in cmps.items())
        + f"; two runs torch.equal; kernel {k_ms:.4f} ms/launch (graph), "
        f"{lib} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {flops:.4g} "
        f"FLOP over {pairs} visible pairs; {flops / k_ms / 1e9:.1f} "
        f"TFLOP/s, {k_ms / b_ms:.2f}x the bound)")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return dict(label=label, S=S, S_kv=S_kv, H=H, K=K, hd=hd, causal=causal,
                window=window,
                max_abs_err=max(c["max_abs_err"] for c in cmps.values()),
                rel_l2={n: c["rel_l2"] for n, c in cmps.items()}, ms=k_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=lib)


def train_flash_f32(dev) -> float:
    """TRAIN_FLASH_F32: each variant's f32 backward (CUDA cores) against
    the plain autograd within GRAD_BARS, two runs torch.equal; returns the
    largest max abs error."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, compare_grad)
    worst = 0.0
    for label, B, S, S_kv, H, K, hd, causal, window in TRAIN_FLASH_F32:
        gen = torch.Generator(device=dev)
        gen.manual_seed(S + S_kv + hd)
        q, k, v, do = (torch.randn((B, n_s, n, hd), generator=gen,
                                   device=dev)
                       for n_s, n in ((S, H), (S_kv, K), (S_kv, K), (S, H)))
        flash = lambda q, k, v: fops.gqa_flash_attention_kv(
            q, k, v, causal=causal, window=window)
        runs = [_kernel_grads(flash, (q, k, v), do) for _ in range(2)]
        if not all_equal(runs[0], runs[1]):
            raise AssertionError(f"flash backward f32 {label}: two card "
                                 f"runs differ")
        _, *want = attention_grads_ref(q, k, v, do, causal=causal,
                                       window=window)
        cmps = {n: compare_grad(g, w) for n, g, w in
                zip(("dq", "dk", "dv"), runs[0], want)}
        if not all(c["ok"] for c in cmps.values()):
            raise AssertionError(f"flash backward f32 {label} beyond "
                                 f"{GRAD_BARS[torch.float32]}: {cmps}")
        err = max(c["max_abs_err"] for c in cmps.values())
        worst = max(worst, err)
        log(f"[train-kernels] flash_attention_bwd f32 {label}: B={B} S={S} "
            f"S_kv={S_kv} H={H} K={K} hd={hd} causal={causal} "
            f"window={window}: max abs err {err:.3g}, rel L2 "
            + ", ".join(f"{n} {c['rel_l2']:.3g}" for n, c in cmps.items())
            + "; two runs torch.equal")
    return worst


def train_flash_smoke_widths(dev) -> dict:
    """The flash backward at hd 16 and 32 (TRAIN_FLASH_SMOKE_HDS): bf16
    (mma.sync) and f32 (CUDA cores) at each of TRAIN_FLASH_SMOKE's masks
    against the plain autograd within GRAD_BARS, one launch a backward, two
    runs torch.equal; then bf16 graph-timed at minitron-8b's attention
    shape (B 1, S 4096, H 32, K 8, causal) cut to each width, beside its
    bound (the larger of the bytes, the five products at the bf16
    tensor-core rate and one exp2 a visible pair at the SFU's rate at the
    card's maximum SM clock), the launch floor, the plain autograd and
    SDPA's backward.  Returns {"max_abs_err": {dtype hd: x}, "timed": {hd:
    record}}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        GRAD_BARS, attention_grads_ref, attention_ref, compare_grad)
    worst = {}
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for hd in TRAIN_FLASH_SMOKE_HDS:
            for label, B, S, S_kv, H, K, causal, window in TRAIN_FLASH_SMOKE:
                gen = torch.Generator(device=dev)
                gen.manual_seed(S + S_kv + hd + window)
                q, k, v, do = (torch.randn((B, n_s, n, hd), generator=gen,
                                           device=dev).to(dtype)
                               for n_s, n in ((S, H), (S_kv, K), (S_kv, K),
                                              (S, H)))
                flash = lambda q, k, v: fops.gqa_flash_attention_kv(
                    q, k, v, causal=causal, window=window)
                what = f"flash backward {dname} hd {hd} {label}"
                before = fops.launches["flash_attention_bwd"]
                runs = [_kernel_grads(flash, (q, k, v), do)
                        for _ in range(2)]
                torch.cuda.synchronize()
                if fops.launches["flash_attention_bwd"] != before + 2:
                    raise AssertionError(f"{what}: launches {fops.launches}")
                if not all_equal(runs[0], runs[1]):
                    raise AssertionError(f"{what}: two card runs differ")
                _, *want = attention_grads_ref(q, k, v, do, causal=causal,
                                               window=window)
                cmps = {n: compare_grad(g, w) for n, g, w in
                        zip(("dq", "dk", "dv"), runs[0], want)}
                if not all(c["ok"] for c in cmps.values()):
                    raise AssertionError(f"{what} beyond {GRAD_BARS[dtype]}"
                                         f": {cmps}")
                err = max(c["max_abs_err"] for c in cmps.values())
                key = f"{dname} hd {hd}"
                worst[key] = max(worst.get(key, 0.0), err)
                log(f"[train-kernels] flash_attention_bwd {dname} hd {hd} "
                    f"{label}: B={B} S={S} S_kv={S_kv} H={H} K={K} "
                    f"causal={causal} window={window}: "
                    + ", ".join(f"{n} max abs err {c['max_abs_err']:.3g} "
                                f"rel L2 {c['rel_l2']:.3g}"
                                for n, c in cmps.items())
                    + "; one launch a backward, two runs torch.equal")
    a = get_config("minitron-8b").attn
    H, K, S = a.n_heads, a.n_kv, ZOO_SEQ
    floor = launch_floor_ms(dev)
    clock = max_sm_clock_hz()
    ex2_per_s = EX2_PER_CLOCK_SM * H100_SMS * clock
    timed = {}
    for hd in TRAIN_FLASH_SMOKE_HDS:
        scale = hd ** -0.5
        gen = torch.Generator(device=dev)
        gen.manual_seed(hd)
        q, k, v, do = (torch.randn((1, S, n, hd), generator=gen,
                                   device=dev).bfloat16()
                       for n in (H, K, K, H))
        lse = torch.empty((1, H, S), dtype=torch.float32, device=dev)
        o = fops._forward(q, k, v, scale, True, 0, lse)
        k_ms = graph_ms(lambda: fops.flash_backward(q, k, v, o, lse, do,
                                                    scale), 20)

        def plain_fb():
            attention_grads_ref(q, k, v, do)

        def plain_f():
            kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
            attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                          vv.transpose(1, 2))
        p_ms = event_ms(plain_fb, 2) - event_ms(plain_f, 2)
        lib_ms, lib = sdpa_backward_ms(q, k, v, do, True, 0)
        pairs = H * visible_pairs(S, 0)
        flops = 2.5 * 4 * hd * pairs        # five products, 10 hd a pair
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, o, do, lse, q, k, v))  # + dq, dk, dv
        p_bound, by = bound(nbytes, flops, BF16_OPS_PER_S)
        exp_ms = pairs / ex2_per_s * 1e3
        b_ms = max(p_bound, exp_ms)
        term = "exp2" if exp_ms >= p_bound else (
            "products" if by == "operations" else "bytes")
        b_by = "bytes" if term == "bytes" else "operations"
        log(f"[train-kernels] flash_attention_bwd bf16 hd {hd}: B=1 S={S} "
            f"H={H} K={K} causal, {pairs} visible pairs: kernel "
            f"{k_ms:.4f} ms/launch (graph), launch floor {floor:.5f} ms, "
            f"plain {p_ms:.4f} ms, {lib} {lib_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({term}: one exp2 a pair {exp_ms:.4f} ms at "
            f"{EX2_PER_CLOCK_SM} a clock per SM x {H100_SMS} SMs x "
            f"{clock / 1e9:.3f} GHz, the card's max SM clock; products "
            f"{flops / BF16_OPS_PER_S * 1e3:.4f} ms, {flops:.4g} FLOP at "
            f"989 TFLOP/s; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
            f"{k_ms / b_ms:.2f}x the bound")
        timed[hd] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_term=term, exp_ms=exp_ms,
                         products_ms=flops / BF16_OPS_PER_S * 1e3,
                         sm_clock_ghz=clock / 1e9, launch_floor_ms=floor,
                         library_ms=lib_ms, library=lib)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "timed": timed}


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
    (flash backend, timed alike); then the flash backward's other
    variants at the zoo's full shapes (TRAIN_FLASH_SHAPES: a window, non-
    causal, S_kv != S, hd 256) within GRAD_BARS of the plain autograd one
    KV-head group at a time, two runs torch.equal, timed beside the bound
    and SDPA's backward, and each in f32 at a small shape; and at the
    smoke configs' hd 16 and 32 (`train_flash_smoke_widths`)."""
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
        # SDPA's flash backend for bf16; torch's own choice for f32, which
        # the flash backend does not take
        lib_ms, lib = sdpa_backward_ms(q, k, v, do, True, 0)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)
        backend = lambda: (sdpa_kernel(SDPBackend.FLASH_ATTENTION)
                           if dtype == torch.bfloat16 else nullcontext())
        # the library's own gradients against the same bars: a yardstick of
        # the precision a design with P and dS in bf16 reaches
        with backend():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
            lib_grads = [t.transpose(1, 2) for t in
                         torch.autograd.grad(out, (qt, kt, vt), dot)]
        _, *want = attention_grads_ref(q, k, v, do)
        lib_cmps = {n: compare_grad(g, w) for n, g, w in
                    zip(("dq", "dk", "dv"), lib_grads, want)}
        del out, lib_grads, want
        log(f"[train-kernels] {lib} {label} gradients against the same "
            f"plain autograd: "
            + ", ".join(f"{n} max abs err {c['max_abs_err']:.3g} rel L2 "
                        f"{c['rel_l2']:.3g} ({'within' if c['ok'] else 'beyond'}"
                        f" the bars)" for n, c in lib_cmps.items()))
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
    # the other variants at the zoo's full shapes, then each in f32
    variants = [train_flash_shape(dev, *shape) for shape in
                TRAIN_FLASH_SHAPES]
    f32_err = train_flash_f32(dev)
    smoke = train_flash_smoke_widths(dev)
    results.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: XLA's autodiff of src/repro/models/attention.py:83 "
                 "attend / :92 attend_chunked (jax.value_and_grad, "
                 "src/repro/train/train_step.py:541)",
        **frec["bf16"], f32={k: v for k, v in frec["f32"].items()},
        variants=variants, f32_variants_max_abs_err=f32_err,
        smoke_widths=smoke))

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


# [train-smoke]: the reference's documented command, `python -m
# repro.launch.train --arch minitron-8b --smoke --steps 50`, on the card
# through `launch/train.py`'s `train` for every arch whose reference command
# runs (whisper's and llama-vision's data pipeline yields no frontend input,
# so their reference command fails; they take the card-vs-CPU step below):
# (arch, steps), each smoke config at its own width and depth, uncut, at the
# reference's defaults (--seq 128, --global-batch 4, one microbatch).
TRAIN_SMOKE_RUNS = (("minitron-8b", 50), ("mamba2-370m", 3),
                    ("gemma3-12b", 3), ("deepseek-moe-16b", 3),
                    ("qwen3-32b", 3), ("phi3-medium-14b", 3),
                    ("mixtral-8x22b", 3), ("jamba-1.5-large-398b", 3))
TRAIN_SMOKE_SEQ = 128
TRAIN_SMOKE_BATCH = 4
# card vs CPU: every arch's smoke config, B 4, S 128 (whisper: its dec_seq
# tokens over 128 frames; llama-vision over its n_img_tokens)
TRAIN_SMOKE_CPU = ("minitron-8b", "mamba2-370m", "gemma3-12b",
                   "deepseek-moe-16b", "qwen3-32b", "phi3-medium-14b",
                   "mixtral-8x22b", "jamba-1.5-large-398b",
                   "whisper-large-v3", "llama-3.2-vision-11b")
# jamba's smoke leaves are held to 5e-2 relative L2, the bar its CPU test
# against the reference and mamba2-370m's take (tests/test_torch_train_
# smoke.py, test_torch_train.py): its Mamba leaves' sums over every
# position (d_skip, dt_bias, conv) move by a few percent where bf16 rounds
# at other places, and cross the elementwise bar there too
TRAIN_SMOKE_REL_L2 = {"jamba-1.5-large-398b": 5e-2}
# and in float32 within the CPU tests' float32 bar against the reference
TRAIN_SMOKE_F32_REL_L2 = 1e-4


def phase_train_smoke(dev) -> dict[str, int]:
    """[train-smoke]: TRAIN_SMOKE_RUNS through `launch/train.py`'s `train`
    on the card at the reference's defaults, the kernels' counts set to 0
    just before each run and read just after: finite losses, no restart,
    and each run's launches `step_launches(cfg, steps, 1)` (the flash
    backward once per attention layer, microbatch and step); then
    TRAIN_SMOKE_CPU's card step against the CPU's (`card_vs_cpu_step`:
    the MoE archs' card step twice torch.equal).  Returns the runs'
    launches, summed."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    total = {}
    for arch, steps in TRAIN_SMOKE_RUNS:
        ck = ROOT / "build" / "train_smoke_ckpt" / arch
        shutil.rmtree(ck, ignore_errors=True)
        reset_zoo_launches()
        t0 = time.perf_counter()
        res = train(arch, smoke=True, steps=steps, seq=TRAIN_SMOKE_SEQ,
                    global_batch=TRAIN_SMOKE_BATCH, ckpt_dir=str(ck),
                    device="cuda", log=lambda m: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = zoo_launches()
        shutil.rmtree(ck, ignore_errors=True)
        cfg, losses = res["cfg"], res["losses"]
        want = step_launches(cfg, steps, 1)
        if counts != want:
            raise AssertionError(f"[train-smoke] {arch} launched {counts}, "
                                 f"expected {want}")
        if res["restarts"] or len(losses) != steps or not all(
                x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"[train-smoke] {arch}: restarts "
                                 f"{res['restarts']}, losses {losses}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        log(f"[train-smoke] {arch} (launch/train.py train, smoke, "
            f"{cfg.n_layers} layers, d_model {cfg.d_model}, hd "
            f"{cfg.attn.head_dim}, remat {cfg.remat}): {steps} steps at S "
            f"{TRAIN_SMOKE_SEQ}, global batch {TRAIN_SMOKE_BATCH}; losses "
            f"first {losses[0]:.4f} last {losses[-1]:.4f}, all finite; wall "
            f"{wall:.2f} s ({wall / steps * 1e3:.1f} ms a step, checkpoints "
            f"included); launches {json.dumps(counts)} = "
            f"{launch_words(want, steps)}")
    for arch in TRAIN_SMOKE_CPU:
        cfg = dataclasses.replace(get_config(arch, smoke=True), remat="none")
        seq = (cfg.encoder.dec_seq if cfg.encoder is not None
               else TRAIN_SMOKE_SEQ)
        batch = zoo_train_batch(dev, cfg, seq, seed=1,
                                batch=TRAIN_SMOKE_BATCH,
                                frames=TRAIN_SMOKE_SEQ)
        card_vs_cpu_step(dev, cfg, batch, "[train-smoke]",
                         f"{arch} smoke card vs CPU",
                         TRAIN_SMOKE_REL_L2.get(arch))
        if arch in TRAIN_SMOKE_REL_L2:
            # the same step in float32: the bf16 spread is rounding
            with float32_models():
                card_vs_cpu_step(dev, cfg, batch, "[train-smoke]",
                                 f"{arch} smoke card vs CPU in float32",
                                 TRAIN_SMOKE_F32_REL_L2, f32=True)
    return total


@contextlib.contextmanager
def restore_spy():
    """Within the block, `train_loop`'s first checkpoint also keeps a host
    copy of the params and optimizer state it saves, in the port's layout,
    and each restore, once it has copied the checkpoint into the state's
    tensors, appends whether they are `torch.equal` to that copy to the
    list yielded (the check runs through both layout conversions, the disk
    and the copy back onto the device)."""
    import torch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.sharding.context import is_dtensor
    from repro_torch.train import loop
    to_disk, load_into = loop._to_disk, loop._load_into
    saved, results = [], []

    def whole(params, opt_state):
        """The state's leaves, whole (a DTensor's full tensor)."""
        return [t.full_tensor() if is_dtensor(t) else t
                for t in tree_leaves([params, opt_state])]

    def spy_to_disk(model_cfg, params, opt_state, *rest):
        if not saved:
            saved.append([t.detach().to("cpu", copy=True)
                          for t in whole(params, opt_state)])
        return to_disk(model_cfg, params, opt_state, *rest)

    def spy_load_into(params, opt_state, tree):
        load_into(params, opt_state, tree)
        got = whole(params, opt_state)
        results.append(bool(saved) and len(got) == len(saved[0]) and all(
            torch.equal(g, w.to(g.device)) for g, w in zip(got, saved[0])))

    loop._to_disk, loop._load_into = spy_to_disk, spy_load_into
    try:
        yield results
    finally:
        loop._to_disk, loop._load_into = to_disk, load_into


def step_launches(cfg, steps: int, microbatches: int = TRAIN_MICROBATCHES,
                  seq: int | None = None) -> dict[str, int]:
    """Kernel launches of `steps` training steps of `cfg`: each microbatch
    runs `per_forward(cfg)` forward launches, each with its backward, and
    with remat (`cfg.remat` not "none") each super-block's forward
    launches (the encoder's too) once more in the backward's re-forward
    (the leading dense blocks are outside the super-blocks)."""
    per = per_forward(cfg, seq)
    out = {}
    for name in ("flash_attention", "ssd_scan"):
        n = per[name] * microbatches * steps
        again = 0
        if cfg.remat != "none":
            lead = cfg.first_k_dense if name == "flash_attention" else 0
            again = (per[name] - lead) * microbatches * steps
        out[name], out[f"{name}_bwd"] = n + again, n
    return out


def launch_words(want: dict, steps: int) -> str:
    """'F forward (R of them the remat's re-forward) and B backward a
    step' of `step_launches`' counts."""
    fwd = (want["flash_attention"] + want["ssd_scan"]) // steps
    bwd = (want["flash_attention_bwd"] + want["ssd_scan_bwd"]) // steps
    again = f" ({fwd - bwd} of them the remat's re-forward)" \
        if fwd != bwd else ""
    return f"{fwd} forward{again} and {bwd} backward a step"


def family_train_cell(dev, arch: str, layers, entry: str) -> dict:
    """One of TRAIN_FAMILY_RUNS: TRAIN_FAMILY_STEPS steps through `entry`,
    the kernels' counts set to 0 just before and read just after (each
    step `step_launches`), finite losses, then one more step under
    torch.profiler.  Returns the cell's numbers."""
    import shutil
    import torch
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model, count_params
    from repro_torch.train.data import DataConfig, SyntheticDataset
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import make_train_step
    seq = WHISPER_TOKENS if arch == "whisper-large-v3" else TRAIN_SEQ
    steps = TRAIN_FAMILY_STEPS
    cfg = zoo_config(arch, layers)
    opt = adamw(1e-3, weight_decay=0.01, grad_clip=1.0)
    reset_zoo_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if entry == "train":
        shutil.rmtree(ROOT / "build" / "train_ckpt" / arch,
                      ignore_errors=True)
        res = train(arch, steps=steps, seq=seq, global_batch=TRAIN_BATCH,
                    microbatches=TRAIN_MICROBATCHES, device=str(dev),
                    layers=layers, checkpoint_every=0,
                    ckpt_dir=str(ROOT / "build" / "train_ckpt" / arch),
                    log=lambda m, a=arch: log(f"[train] {a}: {m}"))
        losses, times = res["losses"], res["step_times"]
        params, opt_state = res["params"], res["opt_state"]
        model = build_model(cfg, dev)
        step_fn = make_train_step(model, opt,
                                  microbatches=TRAIN_MICROBATCHES)
        batch = next(SyntheticDataset(DataConfig(
            vocab=cfg.vocab, seq=seq, global_batch=TRAIN_BATCH),
            start_step=steps, device=dev))
        del res
    else:
        model = build_model(cfg, dev)
        params, _ = model.init(0)
        opt_state = opt.init(params)
        step_fn = make_train_step(model, opt,
                                  microbatches=TRAIN_MICROBATCHES)
        losses, times = [], []
        for i in range(steps):
            batch = zoo_train_batch(dev, cfg, seq, i, TRAIN_BATCH)
            t = time.perf_counter()
            params, opt_state, met = step_fn(
                params, opt_state, batch, torch.tensor(i, device=dev))
            losses.append(float(met["loss"]))      # waits for the device
            times.append(time.perf_counter() - t)
            log(f"[train] {arch}: step {i} loss {losses[-1]:.4f} "
                f"({times[-1] * 1e3:.0f} ms)")
        batch = zoo_train_batch(dev, cfg, seq, steps, TRAIN_BATCH)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = zoo_launches()
    want = step_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"{arch} training launched {counts}, expected "
                             f"{want}")
    if len(losses) != steps or not all(
            x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{arch}: losses {losses}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]     # median, warm
    tokens = TRAIN_BATCH * seq
    rf = cell_roofline(cfg, seq, TRAIN_BATCH, "train", TRAIN_MICROBATCHES)
    mflops, mfu = rf.model_flops, rf.fraction_at(step_s)
    prof_wall, rows = profiled(lambda: step_fn(
        params, opt_state, batch, torch.tensor(steps, device=dev)))
    dev_us = sum(r[0] for r in rows)
    busy = dev_us / 1e6 / prof_wall
    n = count_params(cfg)
    depth = ("" if layers is None else
             f", depth cut from {get_config_layers(arch)} to {layers}")
    if cfg.encoder is not None:
        depth += (f" + {cfg.encoder.n_layers} encoder layers over "
                  f"{WHISPER_FRAMES} frames")
    elif cfg.n_img_tokens:
        depth += f", over {cfg.n_img_tokens} image tokens"
    log(f"[train] {arch} via {'launch/train.py train' if entry == 'train' else 'make_train_step'}: "
        f"{n / 1e9:.3f} B params ({cfg.n_layers} layers{depth}, d_model "
        f"{cfg.d_model}; f32 moments; remat {cfg.remat}); S {seq}, losses "
        f"{[round(x, 4) for x in losses]}; step {step_s:.3f} s warm (steps "
        f"{[round(t, 3) for t in times]}), {tokens / step_s:.0f} tokens/s, "
        f"model_flops {mflops:.4g} = {mfu:.4f} "
        f"of the bf16 peak; peak device memory {peak / 2**30:.2f} GiB; wall "
        f"{wall:.1f} s; launches {json.dumps(counts)} "
        f"({launch_words(want, steps)})")
    log(f"[train] {arch} profile of one step: wall {prof_wall:.3f} s "
        f"(profiler on), device kernels {dev_us / 1e3:.1f} ms in "
        f"{sum(r[1] for r in rows)} launches, busy share {busy:.4f}")
    for us, cnt, key in rows[:6]:
        log(f"[train]   {us / 1e3:8.3f} ms {cnt:6d}x "
            f"({100 * us / dev_us:4.1f}%)  {key[:80]}")
    del params, opt_state, model, step_fn, batch
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, seq=seq, step_s=step_s,
                quantized_opt=False, tokens_per_s=tokens / step_s, cfg=cfg,
                mfu=mfu, peak_gib=peak / 2**30,
                busy_share=busy, losses=losses, launches=counts)


def no_remat_cell(dev) -> dict:
    """TRAIN_NO_REMAT: the first TRAIN_RUNS cell (int8 moments) once more
    with remat "none", TRAIN_FAMILY_STEPS steps through `train`, no
    checkpoint: its warm step and peak beside the remat'd cell's (and
    runs made before the training step honoured remat)."""
    import torch
    from repro_torch.launch.train import train
    arch, layers = TRAIN_NO_REMAT
    reset_zoo_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = train(arch, steps=TRAIN_FAMILY_STEPS, seq=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, microbatches=TRAIN_MICROBATCHES,
                device=str(dev), layers=layers, checkpoint_every=0,
                quantized_opt=True, remat="none",
                ckpt_dir=str(ROOT / "build" / "train_ckpt" / "no_remat"),
                log=lambda m: log(f"[train] {arch} remat none: {m}"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cfg, L, times = res["cfg"], res["losses"], res["step_times"]
    counts = zoo_launches()
    want = step_launches(cfg, TRAIN_FAMILY_STEPS)
    if counts != want:
        raise AssertionError(f"{arch} remat none launched {counts}, "
                             f"expected {want}")
    if not all(x == x and abs(x) < float("inf") for x in L):
        raise AssertionError(f"{arch} remat none: losses {L}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    rf = cell_roofline(cfg, TRAIN_SEQ, TRAIN_BATCH, "train",
                       TRAIN_MICROBATCHES, True)
    log(f"[train] {arch} ({cfg.n_layers} layers, int8 moments) remat none: "
        f"losses {[round(x, 4) for x in L]}; step {step_s:.4f} s warm "
        f"(steps {[round(t, 3) for t in times]}), "
        f"{res['tokens_per_step'] / step_s:.0f} tokens/s, model_flops "
        f"share {rf.fraction_at(step_s):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(counts)} "
        f"({launch_words(want, TRAIN_FAMILY_STEPS)})")
    del res
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, step_s=step_s, quantized_opt=True,
                cfg=cfg, seq=TRAIN_SEQ, mfu=rf.fraction_at(step_s),
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                peak_gib=peak / 2**30, losses=L, launches=counts,
                busy_share=None)


def phase_train(dev) -> tuple[dict[str, int], dict]:
    """The training main path (TRAIN_RUNS) through launch/train.py's
    `train`: 4 steps with the restart drill, the kernels' counts set to 0
    just before each arch and read just after.  Each step must launch each
    kernel `per_forward(cfg)` x microbatches times forward and as often
    backward (`step_launches`), the losses must be finite, the params and optimizer
    state read back at the restart `torch.equal` to those saved at step 2
    (`restore_spy`) and the replayed step's loss the first run's.  Then one more step under torch.profiler (busy share,
    top kernels).  Then TRAIN_FAMILY_RUNS (`family_train_cell`: 3 steps
    each, no checkpoint, no drill).  Returns the counts over the phase and
    the per-arch numbers."""
    import shutil
    import torch
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model, count_params
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
        want = step_launches(cfg, n_runs)
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
        rf = cell_roofline(cfg, TRAIN_SEQ, TRAIN_BATCH, "train",
                           TRAIN_MICROBATCHES, quantized)
        mflops, mfu = rf.model_flops, rf.fraction_at(step_s)
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
            f"{'int8' if quantized else 'f32'} moments; remat "
            f"{cfg.remat}); losses "
            f"{[round(x, 4) for x in L]} (step 2 replayed after the restart:"
            f" {L[2]} == {L[3]}; the restored params and optimizer state "
            f"torch.equal to those saved at step 2); step {step_s:.3f} s warm (steps "
            f"{[round(t, 3) for t in times]}), {tokens / step_s:.0f} "
            f"tokens/s, model_flops {mflops:.4g} = "
            f"{mfu:.4f} of the bf16 peak; "
            f"peak device memory {peak / 2**30:.2f} GiB; wall {wall:.1f} s "
            f"with the checkpoints; launches {json.dumps(counts)} "
            f"({launch_words(want, n_runs)})")
        log(f"[train] {arch} profile of one step: wall {prof_wall:.3f} s "
            f"(profiler on), device kernels {dev_us / 1e3:.1f} ms in "
            f"{sum(r[1] for r in rows)} launches, busy share {busy:.4f}")
        for us, cnt, key in rows[:6]:
            log(f"[train]   {us / 1e3:8.3f} ms {cnt:6d}x "
                f"({100 * us / dev_us:4.1f}%)  {key[:80]}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        by_arch[arch] = dict(params=n, layers=cfg.n_layers, step_s=step_s,
                             quantized_opt=quantized, cfg=cfg, seq=TRAIN_SEQ,
                             tokens_per_s=tokens / step_s, mfu=mfu,
                             peak_gib=peak / 2**30, busy_share=busy,
                             losses=L, launches=counts)
        del res, p, s, model, step_fn, batch
        shutil.rmtree(ckpt_root / arch, ignore_errors=True)
        torch.cuda.empty_cache()
    by_arch[TRAIN_NO_REMAT[0] + " remat none"] = no_remat_cell(dev)
    for k, v in by_arch[TRAIN_NO_REMAT[0] + " remat none"][
            "launches"].items():
        total[k] = total.get(k, 0) + v
    log(f"[train] cells without the drill: {TRAIN_FAMILY_STEPS} steps, "
        f"no checkpoint; AdamW (lr 1e-3, weight decay 0.01, clip 1.0), f32 "
        f"moments")
    for arch, layers, entry in TRAIN_FAMILY_RUNS:
        by_arch[arch] = family_train_cell(dev, arch, layers, entry)
        for k, v in by_arch[arch]["launches"].items():
            total[k] = total.get(k, 0) + v
    reduced = {arch: f"n_layers {get_config_layers(arch)} -> {layers} (the "
                     f"full depth's training state exceeds the card's 80 GB)"
               for arch, layers, _ in TRAIN_RUNS + TRAIN_FAMILY_RUNS
               if layers is not None}
    log(f"[train] reduced: {json.dumps(reduced)}")
    return total, by_arch


# ---------------------------------------------------------------------------
# The sharding layer: sharded steps on a one-card mesh, the dry run
# ---------------------------------------------------------------------------

# [shard]: one training step of each (arch, layers, int8 moments) through
# the sharded path on a (1, 1) mesh against the unsharded path.
SHARD_TRAIN = (("minitron-8b", 4, True), ("deepseek-moe-16b", 4, False),
               ("mamba2-370m", None, False))
SHARD_PREFILL = "minitron-8b"          # full depth, B 1, S 4096
SHARD_DECODE_STEPS = 8


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def placed(tree, shardings, mesh):
    """tree's tensors as DTensors of their shardings' placements on a
    one-card mesh: each local shard is the whole tensor (no copy)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.policies import _walk
    return _walk(lambda _, t, sh: DTensor.from_local(
        t, mesh, sh.placements, run_check=False), tree, shardings)


def local_tree(tree):
    from repro_torch.sharding.context import is_dtensor
    from repro_torch.sharding.policies import _walk
    return _walk(lambda _, t: t.to_local() if is_dtensor(t) else t, tree)


def held_equal(got, want, what: str) -> str:
    """Leaf by leaf: torch.equal, or within the bf16 bar and named."""
    from repro_torch.core.tree import leaf_paths
    off = []
    n = 0
    for (k, g), (_, w) in zip(leaf_paths(local_tree(got)),
                              leaf_paths(local_tree(want))):
        n += 1
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {k}: {g.shape} {g.dtype} against "
                                 f"{w.shape} {w.dtype}")
        if not torch_equal(g, w):
            off.append((k, hold_bf16_on_card(g, w, f"{what} {k}")))
    if not off:
        return f"all {n} torch.equal"
    return (f"{n - len(off)} of {n} torch.equal, within the bf16 bar: "
            + ", ".join(f"{k} ({e:.3g})" for k, e in off))


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def phase_shard(dev) -> dict[str, int]:
    """[shard]: the sharded steps (DTensor params, optimizer state, batch
    and caches placed by `sharding.policies` on a (1, 1) mesh over the
    card, a world-1 nccl group) against the unsharded path on the same
    inputs: SHARD_TRAIN's loss and every gradient of the batch, then one
    training step (2 microbatches, ZeRO placements for the accumulator)
    and its updated params; SHARD_PREFILL's prefill (B 1, S TRAIN_SEQ)
    and SHARD_DECODE_STEPS greedy decode steps on placed caches.  Each
    result torch.equal (or, where an op decomposes differently under a
    DTensor, within the bf16 bar, the leaves named), and the flash and
    SSD kernels' launches of each sharded call `==` the unsharded call's.
    Returns the sharded calls' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.sharding import policies as P
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_loss_fn, make_train_step
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    total = {}

    def launched(fn):
        """fn()'s result and the kernels' launches in it."""
        reset_zoo_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, zoo_launches()

    def same_launches(a, b, what):
        if a != b or not any(a.values()):
            raise AssertionError(f"[shard] {what}: sharded launches {a} "
                                 f"against unsharded {b}")
        for k, v in a.items():
            total[k] = total.get(k, 0) + v

    try:
        mesh = make_host_mesh(1, 1)
        for arch, layers, quant in SHARD_TRAIN:
            cfg = zoo_config(arch, layers)
            model = build_model(cfg, dev)
            shape = ShapeCfg("shard", TRAIN_SEQ, TRAIN_BATCH, "train")
            one = ShapeCfg("shard_mb", TRAIN_SEQ,
                           TRAIN_BATCH // TRAIN_MICROBATCHES, "train")
            shapes, roles = abstract_init(model)
            pspecs = P.param_specs(roles, shapes, cfg, mesh)
            gspecs = P.zero_shard_specs(pspecs, shapes, mesh, cfg)
            ospecs = P.opt_state_specs(pspecs, shapes, mesh, cfg,
                                       quantized=quant)
            batch = zoo_train_batch(dev, cfg, TRAIN_SEQ, 0, TRAIN_BATCH)
            bspecs = P.batch_specs(cfg, shape, mesh, model.input_specs(shape))
            mbspecs = P.batch_specs(cfg, one, mesh, model.input_specs(one))
            bspecs = {k: bspecs[k] for k in batch}
            loss_fn = make_loss_fn(model)

            def value_and_grad(p, b):
                leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
                loss, _ = loss_fn(tree_unflatten(p, leaves), b)
                return loss.detach(), tree_unflatten(p, list(
                    torch.autograd.grad(loss, leaves)))

            params, _ = model.init(0)
            (l0, g0), c0 = launched(lambda: value_and_grad(params, batch))
            (l1, g1), c1 = launched(lambda: value_and_grad(
                placed(params, pspecs, mesh), placed(batch, bspecs, mesh)))
            same_launches(c1, c0, f"{arch} loss and gradients")
            v_loss = held_equal({"loss": l1}, {"loss": l0}, f"{arch} loss")
            v_grad = held_equal(g1, g0, f"{arch} gradient")
            del g0, g1
            opt = (quantized_adamw if quant else adamw)(
                1e-3, weight_decay=0.01, grad_clip=1.0)
            step = torch.tensor(0, device=dev)
            plain = make_train_step(model, opt,
                                    microbatches=TRAIN_MICROBATCHES)
            (p0, s0, m0), c2 = launched(lambda: plain(
                params, opt.init(params), batch, step))
            del s0
            params1, _ = model.init(0)
            sharded = make_train_step(
                model, opt, microbatches=TRAIN_MICROBATCHES,
                grad_shardings=gspecs,
                batch_shardings={k: mbspecs[k] for k in batch})
            (p1, s1, m1), c3 = launched(lambda: sharded(
                placed(params1, pspecs, mesh),
                placed(opt.init(params1), ospecs, mesh),
                placed(batch, bspecs, mesh), step))
            same_launches(c3, c2, f"{arch} training step")
            v_step = held_equal({"loss": m1["loss"]}, {"loss": m0["loss"]},
                                f"{arch} step loss")
            v_par = held_equal(p1, p0, f"{arch} updated param")
            log(f"[shard] {arch} ({cfg.n_layers} layers, "
                f"{'int8' if quant else 'f32'} moments, remat {cfg.remat}, "
                f"MoE {'EP' if P.resolve_policy(cfg, mesh).moe_ep else 'TP'}"
                f" where MoE), B {TRAIN_BATCH}, S {TRAIN_SEQ}, (1, 1) mesh: "
                f"loss {float(l0):.5f}: {v_loss}; gradients: {v_grad}; "
                f"launches {json.dumps(c1)} == unsharded; one step of "
                f"{TRAIN_MICROBATCHES} microbatches, ZeRO accumulator: loss "
                f"{v_step}; updated params: {v_par}; launches "
                f"{json.dumps(c3)} == unsharded")
            del params, params1, p0, p1, s1, model, batch
            torch.cuda.empty_cache()
        cfg = zoo_config(SHARD_PREFILL, None)
        model = build_model(cfg, dev)
        params, roles = model.init(0)
        shapes, _ = abstract_init(model)
        pspecs = P.param_specs(roles, shapes, cfg, mesh)
        dparams = placed(params, pspecs, mesh)
        tokens = zoo_tokens(dev, cfg, TRAIN_SEQ, seed=3)
        pshape = ShapeCfg("shard_prefill", TRAIN_SEQ, 1, "prefill")
        tspec = P.batch_specs(cfg, pshape, mesh,
                              model.input_specs(pshape))["tokens"]
        with torch.no_grad():
            (h0, c0) = launched(lambda: model.apply(params,
                                                    {"tokens": tokens})[0])
            (h1, c1) = launched(lambda: model.apply(dparams, {
                "tokens": placed({"t": tokens}, {"t": tspec}, mesh)["t"]})[0])
            same_launches(c1, c0, f"{SHARD_PREFILL} prefill")
            v_pre = held_equal({"hidden": h1, "logits": model.logits(
                dparams, h1[:, -1:])}, {"hidden": h0, "logits": model.logits(
                    params, h0[:, -1:])}, f"{SHARD_PREFILL} prefill")
            del h0, h1
            dshape = ShapeCfg("shard_decode", TRAIN_SEQ, 1, "decode")
            cspecs = P.batch_specs(cfg, dshape, mesh,
                                   model.input_specs(dshape))
            c_plain = model.init_caches(1, TRAIN_SEQ)
            c_shard = placed(model.init_caches(1, TRAIN_SEQ),
                             cspecs["caches"], mesh)
            tok, worst = tokens[:, :1], []
            for t in range(SHARD_DECODE_STEPS):
                l0, c_plain = model.decode_step(params, tok, c_plain, t)
                l1, c_shard = model.decode_step(
                    dparams, placed({"t": tok}, {"t": cspecs["token"]},
                                    mesh)["t"], c_shard, t)
                worst.append(held_equal({"logits": l1}, {"logits": l0},
                                        f"decode step {t}"))
                nxt0 = l0[:, -1].float().argmax(-1)[:, None]
                nxt1 = local_tree({"l": l1})["l"][:, -1].float().argmax(
                    -1)[:, None]
                if not torch.equal(nxt0, nxt1):
                    raise AssertionError(f"[shard] decode step {t}: token "
                                         f"{nxt1.tolist()} against "
                                         f"{nxt0.tolist()}")
                tok = nxt0.to(torch.long)
            v_cache = held_equal(c_shard, c_plain, "decode caches")
        log(f"[shard] {SHARD_PREFILL} full depth ({cfg.n_layers} layers), "
            f"prefill B 1 S {TRAIN_SEQ} on the (1, 1) mesh: {v_pre}; "
            f"launches {json.dumps(c1)} == unsharded; "
            f"{SHARD_DECODE_STEPS} greedy decode steps on placed caches: "
            f"logits {sorted(set(worst))}, tokens ==, caches {v_cache}")
        del params, dparams, c_plain, c_shard, model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


# [train-mesh]: launch/train.py's `train` on a (1, 1) mesh of a world-1 nccl
# group (DTensor params, optimizer state, batch and gradients), each cell
# beside [train]'s run of the same arch: (arch, layers, int8 moments,
# steps, the restart drill with checkpoints)
TRAIN_MESH_RUNS = (("mamba2-370m", None, False, TRAIN_STEPS, True),
                   ("minitron-8b", 4, True, 3, False))


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_train_mesh(dev, train_archs: dict) -> dict[str, int]:
    """[train-mesh]: TRAIN_MESH_RUNS through `launch/train.py`'s `train` in
    a world-1 nccl group, so on a (1, 1) mesh: the params placed by
    `param_specs`, the optimizer state by `opt_state_specs`, the batch a
    DTensor of `batch_specs`' placements, the gradients held to
    `param_specs`, the checkpoints gathered whole by rank 0 and read back
    into the local shards.  The kernels' counts set to 0 just before each
    cell and read just after: `step_launches` of the steps run.  Each
    step's loss torch.equal to `[train]`'s for the same arch and step in
    this run (or, where an op decomposes differently under a DTensor,
    within the bf16 bar, the steps named); the drill's restored state
    torch.equal to the one saved at step 2 (`restore_spy`).  Returns the
    launches over the phase."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.launch.train import train
    ckpt_root = ROOT / "build" / "train_mesh_ckpt"
    card = card_line()
    total = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        for arch, layers, quantized, steps, drill in TRAIN_MESH_RUNS:
            shutil.rmtree(ckpt_root, ignore_errors=True)
            reset_zoo_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with restore_spy() as restored:
                res = train(arch, steps=steps, seq=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH,
                            microbatches=TRAIN_MICROBATCHES,
                            device=str(dev), layers=layers,
                            fail_at=(TRAIN_FAIL_AT,) if drill else (),
                            checkpoint_every=2 if drill else 0, keep=1,
                            quantized_opt=quantized, ckpt_dir=str(ckpt_root),
                            log=lambda m, a=arch: log(f"[train-mesh] {a}: "
                                                      f"{m}"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = zoo_launches()
            ckpt_gb = dir_bytes(ckpt_root) / 1e9
            shutil.rmtree(ckpt_root, ignore_errors=True)
            cfg, L = res["cfg"], res["losses"]
            mesh = axis_sizes(res["mesh"]) if res["mesh"] is not None else {}
            if mesh != {"data": 1, "model": 1}:
                raise AssertionError(f"[train-mesh] {arch}: mesh {mesh}")
            want = step_launches(cfg, len(L))
            if counts != want:
                raise AssertionError(f"[train-mesh] {arch} launched "
                                     f"{counts}, expected {want}")
            if restored != ([True] if drill else []):
                raise AssertionError(f"[train-mesh] {arch}: the restart "
                                     f"read back a state that differs from "
                                     f"the one saved at step 2: {restored}")
            if drill and (res["restarts"] != 1 or L[2] != L[3]):
                raise AssertionError(f"[train-mesh] {arch}: restarts "
                                     f"{res['restarts']}, losses {L}")
            ref = train_archs[arch]["losses"][:len(L)]
            if len(ref) != len(L):
                raise AssertionError(f"[train-mesh] {arch}: {len(L)} steps "
                                     f"against [train]'s {len(ref)}")
            v_loss = held_equal(
                {f"step {i}": torch.tensor(x) for i, x in enumerate(L)},
                {f"step {i}": torch.tensor(x) for i, x in enumerate(ref)},
                f"[train-mesh] {arch} loss")
            times = res["step_times"]
            step_s = sorted(times[1:])[len(times[1:]) // 2]
            log(f"[train-mesh] {arch} ({cfg.n_layers} layers, "
                f"{'int8' if quantized else 'f32'} moments, remat "
                f"{cfg.remat}), (1, 1) mesh, S {TRAIN_SEQ}, batch "
                f"{TRAIN_BATCH} in {TRAIN_MICROBATCHES} microbatches, "
                f"{steps} steps{', a failure before step 3' if drill else ''}"
                f": losses {[round(x, 4) for x in L]} against [train]'s: "
                f"{v_loss}"
                f"{'; the restored state torch.equal to the saved' if drill else ''}"
                f"; warm step {step_s:.4f} s (steps "
                f"{[round(t, 4) for t in times]}; [train]'s "
                f"{train_archs[arch]['step_s']:.4f}), peak "
                f"{peak / 2**30:.2f} GiB, checkpoint {ckpt_gb:.3f} GB, wall "
                f"{wall:.1f} s; launches {json.dumps(counts)} == "
                f"step_launches ({launch_words(want, len(L))}) [{card}]")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            del res
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


# [dryrun]: the production cells, and the [train] cells' own cuts on (1, 1)
DRYRUN_CELLS = tuple(("train_4k", arch, False) for arch in (
    "jamba-1.5-large-398b", "mixtral-8x22b", "deepseek-moe-16b",
    "qwen3-32b", "llama-3.2-vision-11b", "whisper-large-v3", "gemma3-12b",
    "phi3-medium-14b", "minitron-8b", "mamba2-370m")) + (
    ("train_4k", "jamba-1.5-large-398b", True),
    ("train_4k", "mixtral-8x22b", True))
DRYRUN_WORKERS = 8


def dryrun_job(job):
    """One dry-run count in a worker process (a `fake` group of its own):
    ("cell", shape, arch, multi_pod) a [dryrun] cell through
    `dryrun.lower_cell`; on a (1, 1) mesh, ("cut", arch, layers, remat,
    int8, seq) a [train] cell's own cut through `dryrun.count_cell`, or
    ("serve", kind, arch, layers) a [serve-32k] cell's fit (`serve_fit`)."""
    import dataclasses
    import time as _time
    t0 = _time.perf_counter()
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                         make_production_mesh)
    if job[0] == "cell":
        _, shape_name, arch, multi = job
        fake_world(dryrun.WORLD)
        res = dryrun.lower_cell(arch, shape_name, make_production_mesh(
            multi_pod=multi), multi)
    elif job[0] == "serve":
        fake_world(1)
        res = serve_fit(*job[1:], make_host_mesh(1, 1, device_type="cpu"))
    else:
        from repro_torch.configs.base import ShapeCfg
        _, arch, layers, remat, quant, seq = job
        fake_world(1)
        mesh = make_host_mesh(1, 1, device_type="cpu")
        cfg = dataclasses.replace(zoo_config(arch, layers), remat=remat)
        shape = ShapeCfg("train_cell", seq, TRAIN_BATCH, "train")
        arg, stats = dryrun.count_cell(cfg, shape, mesh, quant,
                                       TRAIN_MICROBATCHES)
        res = {"argument_bytes": arg, "temp_bytes": stats.peak_bytes,
               "flops": stats.flops}
    res["worker_s"] = _time.perf_counter() - t0
    return job, res


def phase_dryrun(train_archs: dict) -> None:
    """[dryrun]: `dryrun.lower_cell` for DRYRUN_CELLS (the ten archs at
    train_4k on (16, 16), mixtral-8x22b and jamba also on (2, 16, 16)):
    per-card argument, temp and total GB and fits_hbm at the card's
    80 GB, counted FLOPs / model_flops, collective bytes by kind and the
    Roofline terms at the H100's peaks; then each [train] cell's own cut
    counted on a (1, 1) mesh beside the peak [train] measured.  Cells run
    in DRYRUN_WORKERS processes (CPU only: meta shards, no card)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    jobs = [("cell",) + c for c in DRYRUN_CELLS]
    for name, r in train_archs.items():
        cfg = r["cfg"]
        arch = name.split(" ")[0]
        # an encoder's cell: its frames are the shape's S
        jobs.append(("cut", arch, cfg.n_layers if cfg.encoder is None
                     else None, cfg.remat, r["quantized_opt"],
                     WHISPER_FRAMES if cfg.encoder is not None
                     else r["seq"]))
    errors = []
    with cf.ProcessPoolExecutor(DRYRUN_WORKERS,
                                mp_context=mp.get_context("spawn")) as ex:
        for job, res in ex.map(dryrun_job, jobs):
            if job[0] == "cell":
                _, shape_name, arch, multi = job
                key = f"{arch}|{shape_name}|{'multi' if multi else 'single'}"
                if res["status"] != "ok":
                    errors.append((key, res))
                    continue
                m, r = res["memory"], res["roofline"]
                log(f"[dryrun] {key}: {res['chips']} cards, per card "
                    f"arguments {m['argument_bytes_per_device'] / 1e9:.2f} "
                    f"GB, temp {m['temp_bytes_per_device'] / 1e9:.2f} GB, "
                    f"total {m['total_bytes_per_device'] / 1e9:.2f} GB, "
                    f"fits_hbm (80 GB) {m['fits_hbm']}; counted FLOPs / "
                    f"model_flops {res['counted_over_model_flops']:.4f}; "
                    f"collective bytes per card "
                    + json.dumps({k: f"{v / 1e9:.3f} GB" for k, v in
                                  res['collective_ops_bytes_raw'].items()})
                    + f"; roofline at the H100's peaks: compute "
                    f"{r['compute_s'] * 1e3:.1f} ms, memory "
                    f"{r['memory_s'] * 1e3:.1f} ms, collective "
                    f"{r['collective_s'] * 1e3:.1f} ms at NVLink "
                    f"({r['collective_net_s'] * 1e3:.1f} ms at 50 GB/s a "
                    f"card between hosts), dominant {r['dominant']}, "
                    f"roofline_fraction {r['roofline_fraction']:.4f}; "
                    f"traced in {res['lower_s']} s ({res['worker_s']:.1f} s "
                    f"in its worker)")
            else:
                _, arch, layers, remat, quant, seq = job
                name = next(n for n, r in train_archs.items()
                            if n.split(" ")[0] == arch
                            and r["cfg"].remat == remat)
                r = train_archs[name]
                est = res["argument_bytes"] + res["temp_bytes"]
                log(f"[dryrun] [train] cut {name} ({r['cfg'].n_layers} "
                    f"layers, S {seq}, batch {TRAIN_BATCH} in "
                    f"{TRAIN_MICROBATCHES}, {'int8' if quant else 'f32'} "
                    f"moments, remat {remat}) on (1, 1): arguments "
                    f"{res['argument_bytes'] / 1e9:.2f} GB + temp "
                    f"{res['temp_bytes'] / 1e9:.2f} GB = {est / 1e9:.2f} GB "
                    f"against the measured peak {r['peak_gib'] * 2**30 / 1e9:.2f}"
                    f" GB ({est / (r['peak_gib'] * 2**30):.3f}); counted "
                    f"{res['flops']:.4g} FLOP a step = "
                    f"{res['flops'] / r['step_s'] / 989e12:.4f} of the bf16 "
                    f"peak at the measured step {r['step_s']:.4f} s "
                    f"({res['worker_s']:.1f} s in its worker)")
    if errors:
        raise AssertionError(f"[dryrun] cells failed: {errors}")


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


def leaf_errors(got, want) -> tuple[float, float]:
    """A card gradient leaf against the CPU's, on the card: the worst
    |got - want| / (atol + rtol |want|) at the zoo's bf16 bar (at most 1
    where the bar holds) and the relative L2."""
    import torch
    from repro_torch.testing import BF16_RTOL
    g, w = got.double(), want.to(got.device).double()
    d = (g - w).abs()
    top = float(w.abs().max())
    ratio = float((d / (BF16_RTOL * top + BF16_RTOL * w.abs()
                        ).clamp_min(1e-300)).max())
    return ratio, float((g - w).norm() / w.norm().clamp_min(1e-300))


@contextlib.contextmanager
def float32_models():
    """Within the block the models compute in float32 (the port's
    `models.model.DTYPE`, as the CPU tests patch it; the weights are cast
    by the caller)."""
    import torch
    from repro_torch.models import model as model_mod
    old = model_mod.DTYPE
    model_mod.DTYPE = torch.float32
    try:
        yield
    finally:
        model_mod.DTYPE = old


def card_vs_cpu_step(dev, cfg, batch, tag: str, what: str,
                     rel_l2: float | None = None, f32: bool = False) -> None:
    """One step's loss and every gradient leaf (no optimizer step) of `cfg`
    on the card (kernels forward and backward) against the port's CPU path
    (plain versions, autograd) on the same weights (seed 1) and `batch`,
    within the zoo's bf16 bar (the leaves compared on the card), the card
    step's launches those of one step, forward and backward
    (`step_launches`); MoE layers on the card's routes (`RouteReplay`, at
    least 95% of the CPU's own top-k the same), and an MoE model's card
    step twice, torch.equal.  With `rel_l2`, each leaf within that
    relative L2 instead of the elementwise bar (the elementwise ratio is
    logged); with `f32`, weights and activations in float32
    (`float32_models`).  Logs one line under `tag`."""
    import torch
    from repro_torch.core.tree import leaf_paths, tree_leaves, tree_unflatten
    from repro_torch.models import build_model
    from repro_torch.testing import RouteReplay, hold_bf16, tree_to
    from repro_torch.train.train_step import make_loss_fn

    def value_and_grad(model, params, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = make_loss_fn(model)(tree_unflatten(params, leaves), batch)
        return loss, tree_unflatten(params, list(torch.autograd.grad(
            loss, leaves)))

    card, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params, _ = card.init(1)
    if f32:
        params = tree_unflatten(params, [t.float()
                                         for t in tree_leaves(params)])
    routes = RouteReplay()
    reset_zoo_launches()
    with routes.record():
        loss_card, g_card = value_and_grad(card, params, batch)
    torch.cuda.synchronize()
    counts = zoo_launches()
    want = step_launches(cfg, 1, 1, batch["tokens"].shape[1])
    if counts != want:
        raise AssertionError(f"{tag} {what}: the card step launched "
                             f"{counts}, expected {want}")
    twice = ""
    if cfg.moe is not None and not f32:     # (the bf16 step's run is held)
        again = value_and_grad(card, params, batch)
        if not all_equal((loss_card, *tree_leaves(g_card)),
                         (again[0], *tree_leaves(again[1]))):
            raise AssertionError(f"{tag} {what}: two card steps differ")
        twice = "; the card step twice torch.equal"
        del again
    t0 = time.perf_counter()
    with routes.replay():
        loss_cpu, g_cpu = value_and_grad(cpu, tree_to(params, "cpu"),
                                         tree_to(batch, "cpu"))
    t_cpu = time.perf_counter() - t0
    agree = routes.check(what)
    verdict = hold_bf16(loss_card.detach(), loss_cpu.detach(),
                        f"{what} loss")
    pairs = list(zip(leaf_paths(g_card), leaf_paths(g_cpu)))
    if rel_l2 is None:
        worst = max((hold_bf16_on_card(gc, gp, f"{what} gradient {k}"), k)
                    for (k, gc), (_, gp) in pairs)
        held = (f"within the bar (worst max abs / max |CPU| "
                f"{worst[0]:.3g} at {worst[1]})")
    else:
        errs = {k: leaf_errors(gc, gp) for (k, gc), (_, gp) in pairs}
        over = {k: e for k, e in errs.items() if e[1] > rel_l2}
        if over:
            raise AssertionError(f"{what}: gradient leaves beyond "
                                 f"{rel_l2} relative L2: {over}")
        r_ratio = max((e[0], k) for k, e in errs.items())
        r_l2 = max((e[1], k) for k, e in errs.items())
        n_over = sum(e[0] > 1 for e in errs.values())
        held = (f"within {rel_l2} relative L2 (worst {r_l2[0]:.3g} at "
                f"{r_l2[1]}; elementwise bar ratio worst {r_ratio[0]:.3g} at "
                f"{r_ratio[1]}, {n_over} leaves over 1)")
    mem = {k: tuple(v.shape) for k, v in batch.items()
           if k not in ("tokens", "labels")}
    log(f"{tag} {what}"
        f"{' (encoder too)' if cfg.encoder is not None else ''}, B "
        f"{batch['tokens'].shape[0]}, S {batch['tokens'].shape[1]}"
        f"{f', memory {mem}' if mem else ''}: loss card "
        f"{float(loss_card.detach()):.5f} vs CPU "
        f"{float(loss_cpu.detach()):.5f} "
        f"({verdict}); every one of {len(tree_leaves(g_cpu))} gradient "
        f"leaves {held}; {agree}{twice}; card launches "
        f"{json.dumps(counts)}; CPU step {t_cpu:.1f} s")
    del params, g_card, g_cpu, card, cpu
    torch.cuda.empty_cache()


def phase_train_card_vs_cpu(dev) -> None:
    """TRAIN_CPU_RUNS at full width, B 1 (`card_vs_cpu_step`), on the
    stubbed frontend's output where the arch has one.  Without remat (the
    `[train]` cells run the configs' "block")."""
    import dataclasses
    for arch, layers, seq in TRAIN_CPU_RUNS:
        # remat "none": remat changes no value (tests/test_torch_distributed
        # holds the modes ==), and the CPU side's re-forward would cost
        # ~30% more of this phase's wall
        cfg = dataclasses.replace(zoo_config(arch, layers), remat="none")
        batch = zoo_train_batch(dev, cfg, seq, seed=1)
        card_vs_cpu_step(dev, cfg, batch, "[train-cpu]",
                         f"{arch} depth {layers}, full width")


# ---------------------------------------------------------------------------
# The planning layer: the AIMM sharding mapper and its cost models
# ---------------------------------------------------------------------------

PLAN_STEPS = 300
PLAN_MESH = (16, 16)
# At 80 GB a card jamba-1.5-large-398b's starting mapping fits on (16, 16),
# so the OOM escape of the reference's test is held on (8, 8), 64 cards,
# where it needs ~179 GB a card.
PLAN_OOM_MESH = (8, 8)
PLAN_CPU_ARCHS = ("jamba-1.5-large-398b", "qwen3-32b")
PLAN_PROFILE_STEPS = 60


@contextlib.contextmanager
def recording_acts():
    """Within the block, every `agent.act` the mapper's search makes also
    appends (action, explored, q) to the list yielded: the action taken,
    whether the epsilon draw explored, and the online network's Q values
    (float64) its greedy choice is made from.  The extra draws and the Q
    forward are kernel launches of their own."""
    from repro_torch.core import agent as agent_mod
    from repro_torch.core import dqn, prng
    act, rec = agent_mod.act, []

    def spy(agent, cfg, state_vec, explore=True):
        keys = prng.split(agent.rng, 3)
        u = prng.uniform(keys[:, 1], ())
        eps = agent_mod.epsilon(cfg, agent.global_step)
        q = dqn.q_values_infer(agent.params, state_vec, cfg.dqn)[0]
        a, out = act(agent, cfg, state_vec, explore)
        rec.append((int(a[0]), bool(explore and u[0] < eps[0]),
                    q.double().cpu().numpy()))
        return a, out

    agent_mod.act = spy
    try:
        yield rec
    finally:
        agent_mod.act = act


def hold_search(arch: str, card, card_rec, cpu, cpu_rec) -> str:
    """The card's search against the CPU's: every action, knob setting and
    step time `==`.  At the first step where the actions part, the rule of
    a float-order near-tie applies: both must be greedy there and the
    card's top-two Q gap below 1e-4 relative; anything else fails.  After
    such a flip the two searches walk other mappings, and are not
    compared further."""
    for t, ((a, ex, q), (b, ex_b, _)) in enumerate(zip(card_rec, cpu_rec)):
        if card.trajectory[t] != cpu.trajectory[t]:
            raise AssertionError(f"{arch}: card and CPU searches part at "
                                 f"step {t} with equal actions before it")
        if a == b:
            continue
        top = sorted(q)[-2:]
        gap = (top[1] - top[0]) / max(abs(top[1]), 1e-12)
        if ex or ex_b or not gap < 1e-4:
            raise AssertionError(
                f"{arch}: card and CPU searches take actions {a} / {b} at "
                f"step {t} (explored {ex} / {ex_b}, top-two Q gap {gap!r} "
                f"relative, bar 1e-4)")
        return (f"== up to step {t}; the actions part there at a near-tie "
                f"(top-two Q gap {gap:.3g} relative, below 1e-4)")
    if card.trajectory != cpu.trajectory or card.best != cpu.best or \
            card.best_step_s != cpu.best_step_s:
        raise AssertionError(f"{arch}: card and CPU searches differ with "
                             f"equal actions")
    return (f"every step's action, knobs and step time ==, best "
            f"{card.best_step_s!r} s ==")


def plan_kernels(dev) -> None:
    """The mapper's kernels at its own widths: the dueling_qnet at state
    24 (G 1, N 1 and 64) within 1e-4 of its plain version, and its TD
    step's td_grad at state 24 (G 1, 64 replay rows, hidden 128) held as
    `hold_td_grad` holds it."""
    import torch
    from repro_torch.core import dqn, prng
    from repro_torch.core.sharding_mapper import STATE_DIM, search_agent_cfg
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    acfg = search_agent_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    params = dqn.init_params(prng.PRNGKey(0, dev), acfg.dqn, 1, dev)
    for k in params:
        if k.startswith("b"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen,
                                          device=dev)
    keys = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")
    errs = {}
    for n in (1, 64):
        xs = torch.rand((1, n, STATE_DIM), generator=gen, device=dev) * 2
        got = qops.qnet_forward(params, xs)
        want = dueling_qnet_ref(xs, *[params[k] for k in keys])
        errs[n] = max_abs_err(got, want)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"dueling_qnet S={STATE_DIM} N={n} beyond "
                                 f"1e-4 of its plain version: {errs[n]}")
    td = hold_td_grad(dev, 1, STATE_DIM)
    log(f"[plan] the mapper's widths: dueling_qnet S={STATE_DIM} hidden "
        f"{acfg.dqn.hidden} A={acfg.dqn.n_actions} within 1e-4 of plain "
        f"(max abs err N=1 {errs[1]:.3g}, N=64 {errs[64]:.3g}); td_grad at "
        f"S {STATE_DIM} within rtol 1e-5 of the card path (max abs err "
        f"{max(td['card'].values()):.3g}) and of plain torch "
        f"({max(td['plain'].values()):.3g})")


def phase_plan(dev) -> dict[str, int]:
    """The planning layer on the card: the cost models over every arch x
    shape, then the sharding mapper's main path, `search` for every arch
    at train_4k on (16, 16) with the H100 record (PLAN_STEPS steps, seed
    0) beside `exhaustive_best`, and jamba-1.5-large-398b's OOM escape on
    (8, 8), with the AIMM kernels' counts set to 0 just before and read
    just after; the reference tests' bars (qwen3-32b within 1.3x of its
    optimum; jamba leaves the OOM plateau with FSDP and int8 moments).
    Then a profile of one search, and PLAN_CPU_ARCHS searched again on the
    CPU: `==` to the card's, or parting at a near-tie (`hold_search`).
    Returns the counted launches."""
    import torch
    from repro_torch.configs import ARCHS, SHAPES, get_config, \
        shape_applicable
    from repro_torch.core.sharding_mapper import (CostModel, Knobs,
                                                  exhaustive_best, search)
    from repro_torch.launch.memory_model import memory_bytes
    from repro_torch.launch.roofline import H100, Roofline
    from repro_torch.models.model import model_flops
    log(f"[plan] chip record: {H100}")
    for arch in ARCHS:
        cfg = get_config(arch)
        cells = []
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            mf = model_flops(cfg, shape)
            mb = memory_bytes(cfg, shape)
            r = Roofline(flops=mf, bytes_hbm=mb, bytes_collective=0.0,
                         chips=1, model_flops=mf)
            cells.append(f"{shape.name} {'runs' if ok else 'skipped: ' + why}"
                         f", model_flops {mf:.4g}, memory_bytes {mb:.4g}, "
                         f"one card's bound {r.step_s:.4g} s ({r.dominant})")
        log(f"[plan] {arch}: " + "; ".join(cells))
    plan_kernels(dev)
    shape = SHAPES["train_4k"]
    reset_aimm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, steps = {}, 0
    for arch in ARCHS:
        cfg = get_config(arch)
        res = search(cfg, shape, PLAN_MESH, PLAN_STEPS, 0, device=dev)
        gt, gt_t = exhaustive_best(cfg, shape, PLAN_MESH)
        results[arch] = (res, gt, gt_t)
        steps += PLAN_STEPS
    jamba = get_config("jamba-1.5-large-398b")
    oom = search(jamba, shape, PLAN_OOM_MESH, PLAN_STEPS, 0, device=dev)
    steps += PLAN_STEPS
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = aimm_launches()
    for arch, (res, gt, gt_t) in results.items():
        gap = res.best_step_s / gt_t - 1
        visited = len({k for k, _ in res.trajectory})
        log(f"[plan] search {arch} train_4k mesh {PLAN_MESH}: start "
            f"{res.baseline_step_s:.6g} s, RL best {res.best} "
            f"{res.best_step_s:.6g} s, exhaustive {gt} {gt_t:.6g} s, RL vs "
            f"optimum {100 * gap:+.2f}% ({visited} mappings visited of 144)")
    res, gt, gt_t = results["qwen3-32b"]
    if not res.best_step_s <= gt_t * 1.3:
        raise AssertionError(f"qwen3-32b: search best {res.best_step_s} "
                             f"beyond 1.3 x the optimum {gt_t}")
    oom_gt, oom_t = exhaustive_best(jamba, shape, PLAN_OOM_MESH)
    start_gb = CostModel(jamba, shape, PLAN_OOM_MESH).hbm_per_chip(Knobs())
    if not (oom.baseline_step_s == float("inf")
            and oom.best_step_s < float("inf") and oom.best.fsdp
            and oom.best.quant_opt):
        raise AssertionError(f"jamba on {PLAN_OOM_MESH}: start "
                             f"{oom.baseline_step_s}, best {oom.best} "
                             f"{oom.best_step_s}")
    log(f"[plan] jamba-1.5-large-398b on {PLAN_OOM_MESH}: the start needs "
        f"{start_gb / 1e9:.1f} GB a card (OOM at {H100.hbm_bytes / 1e9:.0f} "
        f"GB); RL best {oom.best} {oom.best_step_s:.6g} s (left the OOM "
        f"plateau with FSDP and int8 moments), exhaustive {oom_gt} "
        f"{oom_t:.6g} s")
    n_launch = sum(counts.values())
    log(f"[plan] {len(results) + 1} searches, {steps} steps on the card in "
        f"{wall:.2f} s: {wall / steps * 1e3:.3f} ms a step, launches "
        f"{json.dumps(counts)} ({n_launch / steps:.1f} counted a step)")
    cfg = get_config("qwen3-32b")
    pwall, rows = profiled(lambda: search(cfg, shape, PLAN_MESH,
                                          PLAN_PROFILE_STEPS, 0, device=dev))
    dev_us = sum(r[0] for r in rows)
    n_kern = sum(r[1] for r in rows)
    log(f"[plan] profile of a {PLAN_PROFILE_STEPS}-step search (qwen3-32b): "
        f"wall {pwall * 1e3:.1f} ms (profiler on), device kernels "
        f"{dev_us / 1e3:.2f} ms in {n_kern} launches, "
        f"{n_kern / PLAN_PROFILE_STEPS:.1f} launches a step, busy share "
        f"{dev_us / 1e6 / pwall:.4f}")
    for us, cnt, key in rows[:8]:
        log(f"[plan]   {us / 1e3:8.3f} ms {cnt:6d}x "
            f"({cnt / PLAN_PROFILE_STEPS:5.1f} a step)  {key[:80]}")
    for arch in PLAN_CPU_ARCHS:
        cfg = get_config(arch)
        card = results[arch][0]
        t = time.perf_counter()
        cpu = search(cfg, shape, PLAN_MESH, PLAN_STEPS, 0, device="cpu")
        cpu_s = time.perf_counter() - t
        if cpu == card:
            verdict = (f"every step's knobs and step time ==, best "
                       f"{card.best_step_s!r} s ==")
        else:       # again with every act's Q recorded, to find the tie
            runs = {}
            for d in (dev, "cpu"):
                with recording_acts() as rec:
                    runs[d] = (search(cfg, shape, PLAN_MESH, PLAN_STEPS, 0,
                                      device=d), rec)
            verdict = hold_search(arch, *runs[dev], *runs["cpu"])
        log(f"[plan] {arch} card vs CPU, {PLAN_STEPS} steps (the CPU's "
            f"{cpu_s:.2f} s against the counted card run): {verdict}")
    return counts


def cell_roofline(cfg, seq: int, batch: int, kind: str, mb: int = 8,
                  quantized: bool = False):
    """The card's Roofline of one cell: model_flops and memory_bytes of
    the cell's own config and shape, one card, no collectives."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.memory_model import memory_bytes
    from repro_torch.launch.roofline import Roofline
    from repro_torch.models.model import model_flops
    shape = ShapeCfg(f"{kind}_cell", seq, batch, kind)
    mf = model_flops(cfg, shape)
    return Roofline(flops=mf, bytes_hbm=memory_bytes(
        cfg, shape, mb=mb, quantized_opt=quantized), bytes_collective=0.0,
        chips=1, model_flops=mf)


def phase_roofline(train_archs: dict, zoo_archs: dict) -> None:
    """Every training cell's and every prefill's measured warm step against
    the card's Roofline bound (`cell_roofline`): a step shorter than the
    bound means a count is wrong, and fails.  For the training cells the
    measured step's model_flops share (`Roofline.fraction_at`) must be the
    one [train] printed, and the cost model's `hbm_per_chip` on one card
    (its knobs: no remat, the cell's microbatches and moments) stands
    beside the measured peak (reported only).  Then the full-depth
    minitron-8b with int8 moments by the same arithmetic, beside the
    deepest cut that ran."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.sharding_mapper import CostModel, Knobs
    from repro_torch.launch.roofline import H100
    for arch, r in train_archs.items():
        cfg = r["cfg"]
        rf = cell_roofline(cfg, r["seq"], TRAIN_BATCH, "train",
                           TRAIN_MICROBATCHES, r["quantized_opt"])
        if r["step_s"] < rf.step_s:
            raise AssertionError(f"[roofline] {arch}: measured step "
                                 f"{r['step_s']} s below its bound "
                                 f"{rf.step_s} s")
        share = rf.fraction_at(r["step_s"])
        if share != r["mfu"]:
            raise AssertionError(f"[roofline] {arch}: share {share!r} != "
                                 f"[train]'s {r['mfu']!r}")
        knobs = Knobs(microbatches=TRAIN_MICROBATCHES, remat="none",
                      quant_opt=r["quantized_opt"])
        est = CostModel(cfg, ShapeCfg("train_cell", r["seq"], TRAIN_BATCH,
                                      "train"), (1, 1)).hbm_per_chip(knobs)
        peak = r["peak_gib"] * 2**30
        log(f"[roofline] train {arch} ({cfg.n_layers} layers, S "
            f"{r['seq']}, batch {TRAIN_BATCH} in {TRAIN_MICROBATCHES}): "
            f"model_flops {rf.model_flops:.4g}, memory_bytes "
            f"{rf.bytes_hbm:.4g}; bound {rf.step_s:.4f} s ({rf.dominant}; "
            f"compute {rf.compute_s:.4f}, memory {rf.memory_s:.4f}), "
            f"measured {r['step_s']:.4f} s = {r['step_s'] / rf.step_s:.2f}x "
            f"the bound; model_flops share of the bf16 peak {share:.4f} "
            f"(== [train]'s); bound's roofline_fraction "
            f"{rf.roofline_fraction:.4f}; CostModel.hbm_per_chip (1, 1) "
            f"{est / 1e9:.2f} GB against the measured peak "
            f"{peak / 1e9:.2f} GB: {est / peak:.3f}")
    for arch, r in zoo_archs.items():
        rf = cell_roofline(r["cfg"], r["seq"], ZOO_BATCH, "prefill")
        if r["prefill_s"] < rf.step_s:
            raise AssertionError(f"[roofline] prefill {arch}: measured "
                                 f"{r['prefill_s']} s below its bound "
                                 f"{rf.step_s} s")
        log(f"[roofline] prefill {arch} (S {r['seq']}, batch {ZOO_BATCH}): "
            f"model_flops {rf.model_flops:.4g}, memory_bytes "
            f"{rf.bytes_hbm:.4g}; bound {rf.step_s:.4f} s ({rf.dominant}), "
            f"measured {r['prefill_s']:.4f} s = "
            f"{r['prefill_s'] / rf.step_s:.2f}x the bound, model_flops share "
            f"{rf.fraction_at(r['prefill_s']):.4f}")
    # full-depth minitron-8b with int8 moments, by the cost model
    full = zoo_config("minitron-8b", None)
    shape = ShapeCfg("train_cell", TRAIN_SEQ, TRAIN_BATCH, "train")
    knobs = Knobs(microbatches=TRAIN_MICROBATCHES, remat="none",
                  quant_opt=True)
    need = CostModel(full, shape, (1, 1)).hbm_per_chip(knobs)
    fits = max(n for n in range(1, full.n_layers + 1) if CostModel(
        zoo_config("minitron-8b", n), shape, (1, 1)).hbm_per_chip(knobs)
        <= H100.hbm_bytes)
    ran = train_archs["minitron-8b"]
    est = CostModel(ran["cfg"], shape, (1, 1)).hbm_per_chip(knobs)
    log(f"[roofline] minitron-8b full depth ({full.n_layers} layers), int8 "
        f"moments, S {TRAIN_SEQ} batch {TRAIN_BATCH} in "
        f"{TRAIN_MICROBATCHES}: CostModel.hbm_per_chip (1, 1) "
        f"{need / 1e9:.2f} GB against the card's {H100.hbm_bytes / 1e9:.0f} "
        f"GB; the deepest cut within it by the same model {fits} layers; "
        f"the cut that ran, {ran['cfg'].n_layers} layers: {est / 1e9:.2f} GB "
        f"by the model, {ran['peak_gib'] * 2**30 / 1e9:.2f} GB measured")


def phase_examples(dev) -> None:
    """The four examples of the port (`examples/torch_*.py`) on the card,
    each through its `main` at reduced arguments and published widths:
    quickstart (PR at 16384 ops, 2 AIMM episodes), the Fig. 6 demo (PR,
    9 lanes at 16384 ops, 2 AIMM episodes), the sharding search (qwen3-32b,
    300 steps), LM training (the small preset, 40 steps with a failure
    injected at step 20).  Each one's output is printed under its name,
    then the kernels' launches over the phase; the training run's loss
    must fall and it must restart once."""
    import importlib.util
    import io
    import shutil
    ckpt = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = (("torch_quickstart", ["--episodes", "2"]),
            ("torch_nmp_aimm_demo", ["--episodes", "2"]),
            ("torch_sharding_search", ["--arch", "qwen3-32b"]),
            ("torch_train_lm", ["--steps", "40", "--inject-failure",
                                "--ckpt-dir", str(ckpt)]))
    reset_aimm_launches()
    reset_zoo_launches()
    for name, argv in runs:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = mod.main(argv + ["--device", str(dev)])
        wall = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"[examples] {name}: {line}")
        if name == "torch_train_lm":
            L = res["losses"]
            if not (L[-1] < L[0] and res["restarts"] == 1):
                raise AssertionError(f"{name}: losses {L[0]} -> {L[-1]}, "
                                     f"restarts {res['restarts']}")
        log(f"[examples] {name} {' '.join(argv)}: done in {wall:.1f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[examples] launches over the phase: "
        f"{json.dumps({**aimm_launches(), **zoo_launches()})}")


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

    if "--serve-32k" in sys.argv[1:]:
        # the production serving cells and their phases alone
        workers = serve_workers_start()
        timed(phase_serve_kernels, dev, workers[0])
        fits, cpu_side = timed(serve_workers_wait, workers)
        timed(phase_serve_32k, dev, fits)
        timed(phase_serve_cpu, dev, cpu_side)
        log(f"[time] wall seconds by phase: {json.dumps(walls)}")
        log(f"[card] {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kernels = timed(phase_kernels, dev)
    floor = kernels[0]["launch_floor_ms"]
    kernels.append(timed(phase_prng, dev, floor))
    kernels += timed(phase_batched_linear, dev, floor)
    widths = timed(phase_sweep_widths, dev, floor)
    timed(phase_cells, dev)
    launches, split, rates = timed(phase_main_path, dev)
    timed(phase_profile, dev)
    grid_launches, grid_shapes = timed(phase_grid, dev, rates)
    lifecycle = {"continual": timed(phase_continual, dev),
                 "serving": timed(phase_serving, dev),
                 "faults": timed(phase_faults, dev)}
    mesh_counts = timed(phase_mesh, dev)
    plan_counts = timed(phase_plan, dev)
    # the serving cells' CPU work, in worker processes while the card runs
    # the device-timed kernel phases and [zoo-cpu]; collected before [zoo]
    workers = serve_workers_start()
    kernels += timed(phase_zoo_kernels, dev)
    serve_kernels = timed(phase_serve_kernels, dev, workers[0])
    timed(phase_zoo_card_vs_cpu, dev)
    fits, cpu_side = timed(serve_workers_wait, workers)
    zoo_counts, zoo_archs, serve_recs, serve_s = timed(phase_zoo_model, dev,
                                                       fits)
    launches.update(zoo_counts)
    timed(phase_serve_cpu, dev, cpu_side)
    # the serving cells' wall inside phase_zoo_model, and the new work's
    # together (the wait for its CPU workers included)
    walls["serve_32k_in_zoo_model"] = round(serve_s, 1)
    walls["serve_32k_all"] = round(
        serve_s + walls["phase_serve_kernels"] + walls["serve_workers_wait"]
        + walls["phase_serve_cpu"], 1)
    serve_counts = {}
    for r in serve_recs:
        for name, n in r["launches"].items():
            serve_counts[name] = serve_counts.get(name, 0) + n
    timed(phase_zoo_profile, dev)
    kernels += timed(phase_train_kernels, dev)
    smoke_counts = timed(phase_train_smoke, dev)
    for name, n in smoke_counts.items():
        launches[name] = launches.get(name, 0) + n
    timed(phase_train_card_vs_cpu, dev)
    train_counts, train_archs = timed(phase_train, dev)
    for name, n in train_counts.items():
        launches[name] = launches.get(name, 0) + n
    shard_counts = timed(phase_shard, dev)
    for name, n in shard_counts.items():
        launches[name] = launches.get(name, 0) + n
    mesh_train_counts = timed(phase_train_mesh, dev, train_archs)
    for name, n in mesh_train_counts.items():
        launches[name] = launches.get(name, 0) + n
    timed(phase_dryrun, train_archs)
    timed(phase_roofline, train_archs, zoo_archs)
    timed(phase_examples, dev)
    log(f"[time] wall seconds by phase: {json.dumps(walls)}")
    for k in kernels:
        name = k["name"]
        # each main path's own run: the episodes, the grid, the zoo
        k["launches"] = (launches[name] + grid_launches.get(name, 0)
                         + sum(ph.get(name, 0) for ph in lifecycle.values())
                         + plan_counts.get(name, 0))
        k.update(split.get(name, {}))
        k.update(widths.get(name, {}))
        if name in grid_launches:
            k["launches_episodes"] = launches[name]
            k["launches_grid"] = grid_launches[name]
            k["launches_grid_by_shape"] = grid_shapes.get(name, {})
        for phase, counts in lifecycle.items():
            if name in counts:
                k[f"launches_{phase}"] = counts[name]
        by_rank = {r: c[name] for r, c in mesh_counts.items() if c.get(name)}
        if by_rank:
            # [mesh]: each rank process's own launches (grid shapes, stream
            # and fleet), besides the main path's in this process
            k["launches_mesh_by_rank"] = by_rank
        if plan_counts.get(name):
            # the sharding mapper's searches
            k["launches_plan"] = plan_counts[name]
        if name in serve_kernels:
            # [serve-32k-kernels]: at S 32768
            k["serve_32k_shapes"] = serve_kernels[name]
        if serve_counts.get(name):
            # [serve-32k]: the production serving cells (inside [zoo])
            k["launches_serve_32k"] = serve_counts[name]
        if name == "flash_attention":
            k["launches_by_arch"] = {a: r["launches"][name]
                                     for a, r in zoo_archs.items()
                                     if r["launches"][name]}
        if shard_counts.get(name):
            # the sharded steps on the (1, 1) mesh
            k["launches_shard"] = shard_counts[name]
        if mesh_train_counts.get(name):
            # launch/train.py on the (1, 1) mesh
            k["launches_train_mesh"] = mesh_train_counts[name]
        if smoke_counts.get(name):
            # launch/train.py --smoke for every arch with attention
            k["launches_train_smoke"] = smoke_counts[name]
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:4]))
    sys.exit(main())
