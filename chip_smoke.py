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
 3. deterministic cells on the card against the port's own CPU path:
    SPMV/2048 pei/tom and KM/384 pei/aimm with forced action 5, seed 2.
 4. the main path at full size: `run_program(BP/16384, "bnmp", "aimm",
    episodes=2)` (learned AIMM, the paper's Table-1 system) and
    `run_episode(BP/16384, "pei", "tom")`, with the kernels' launch counts
    set to 0 just before and read just after.  The TOM scores ride in the
    fused epoch launch: every PEI + TOM epoch counts one folded scoring
    and no standalone tom_scores launch; the kernels line gives
    tom_scores the sum of both counts, and each beside it.
 5. profile: torch.profiler over one warm episode of each main-path
    program (device busy share, launches per epoch, top kernels by time,
    and the AIMM kernels' rows wherever they rank).
 6. model-zoo kernels vs their plain-torch versions on the card, at the
    main-path shapes (B 1, S 4096): flash attention at minitron-8b's
    (H 32, K 8, hd 128) in bf16 (the wgmma kernel) and f32 within the bars
    of `flash_attention/ref.py` BARS (elementwise, relative L2 overall and
    per row), and in bf16 at hd 32 (the mma.sync kernel); the SSD scan at
    mamba2-370m's (H 32, P 64, N 128, chunk 256) within 1e-4, once with
    fast decay and once with the state carried across chunks; graph-timed,
    with SDPA timed beside flash as the library yardstick, and the SSD's
    bound both on f32 CUDA cores and as a 3xTF32 split on the tensor cores.
 7. card vs CPU: both archs at full width and depth 2, B 1, S 256, final
    hidden state, the card (kernels) against the port's CPU path.
 8. the model zoo's main path at full width and depth, random weights from
    a seed: prefill forward (`apply` + `logits`, B 1, S 4096) of
    minitron-8b and mamba2-370m, 32 flash and 48 SSD launches per forward,
    then the serving loop of `launch/serve.py` for each (4 requests,
    batch 4), with the zoo kernels' counts set to 0 just before and read
    just after.
 9. profile: torch.profiler over one warm prefill forward and one serving
    loop of each arch (busy share, top kernels by device time).
10. a JSON line with every kernel's numbers, then the result line
    {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA card it
exits non-zero before printing any result.
"""
from __future__ import annotations

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
    from repro_torch.core import dqn
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import default_agent_cfg
    acfg = default_agent_cfg(NMPConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = dqn.init_params(gen, acfg.dqn, 1, device)
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


ZOO_ARCHS = ("minitron-8b", "mamba2-370m")


def zoo_launches() -> dict[str, int]:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    return {**fops.launches, **sops.launches}


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


def phase_zoo_model(dev) -> dict[str, int]:
    """The model zoo's main path at full width and depth, random weights from
    a seed: the prefill forward (`apply` then `logits`, B 1, S 4096) twice
    per arch, then the serving loop of `launch/serve.py` (4 requests,
    batch 4, max-seq 128, max-new 16) on the same weights.  The kernels'
    counts are zeroed just before and read just after; each forward must
    launch flash once per attention layer and the SSD scan once per Mamba
    layer."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models.model import count_params
    full = SHAPES["prefill_32k"]
    log(f"[zoo] prefill shape: {full.name} (S {full.seq}, batch "
        f"{full.global_batch}) cut to S {ZOO_SEQ}, batch {ZOO_BATCH}")
    reset_zoo_launches()
    for arch in ZOO_ARCHS:
        cfg = get_config(arch)
        per_fwd = {"flash_attention": cfg.n_layers * sum(
                       mx == "A" for mx, _ in cfg.pattern) // len(cfg.pattern),
                   "ssd_scan": cfg.n_layers * sum(
                       mx == "M" for mx, _ in cfg.pattern) // len(cfg.pattern)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, dev)
        t0 = time.perf_counter()
        params = model.init(0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        toks = zoo_tokens(dev, cfg, ZOO_SEQ)
        walls = []
        with torch.inference_mode():
            for _ in range(2):
                before = zoo_launches()
                t0 = time.perf_counter()
                hidden, _ = model.apply(params, {"tokens": toks})
                logits = model.logits(params, hidden)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got = {k: v - before[k] for k, v in zoo_launches().items()}
                if got != per_fwd:
                    raise AssertionError(f"{arch} prefill launched {got}, "
                                         f"expected {per_fwd}")
            shape = (ZOO_BATCH, ZOO_SEQ, cfg.padded_vocab)
            if tuple(logits.shape) != shape or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} logits {tuple(logits.shape)} "
                                     f"(want {shape}) or not finite")
            peak = torch.cuda.max_memory_allocated()
            lg_std = float(logits.float().std())
            del logits, hidden
            torch.cuda.reset_peak_memory_stats()
            reqs, steps, t_serve = serve(arch, params=params, device=dev)
            serve_peak = torch.cuda.max_memory_allocated()
        if not all(r.done and len(r.generated) == 16 for r in reqs):
            raise AssertionError(f"{arch} serve: not every request completed")
        n = count_params(cfg)
        log(f"[zoo] {arch}: {n / 1e9:.3f} B params ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}), init {t_init:.2f} s; prefill B="
            f"{ZOO_BATCH} S={ZOO_SEQ}: first {walls[0]:.3f} s, warm "
            f"{walls[1]:.3f} s ({ZOO_BATCH * ZOO_SEQ / walls[1]:.0f} "
            f"tokens/s), launches per forward {json.dumps(per_fwd)}, logits "
            f"{shape} finite (std {lg_std:.3f}), peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"[zoo] {arch} serve: {len(reqs)}/{len(reqs)} requests done in "
            f"{steps} decode steps, {t_serve:.3f} s ({steps / t_serve:.1f} "
            f"steps/s, batch 4), peak device memory "
            f"{serve_peak / 2**30:.2f} GiB")
        del params, model
        torch.cuda.empty_cache()
    launches = zoo_launches()
    log(f"[zoo] launches over the phase: {json.dumps(launches)}")
    return launches


def phase_zoo_card_vs_cpu(dev) -> None:
    """Both archs at full width and depth 2 (one super-block pair), B 1,
    S 256: the final hidden state on the card (kernels) against the port's
    CPU path (plain versions) on the same weights, without the LM head.
    Bar: rtol 2e-2, atol 2e-2 x max |CPU value| -- bf16 matmuls and
    reductions round at other places on the two devices, and the flash
    kernel rounds P to bf16 for its second product."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    for arch in ZOO_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=2 * len(full.pattern))
        card, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
        params = card.init(1)
        on_cpu = _tree_to(params, "cpu")
        toks = zoo_tokens(dev, cfg, 256, seed=1)
        with torch.inference_mode():
            h_card = card.apply(params, {"tokens": toks})[0].float().cpu()
            t0 = time.perf_counter()
            h_cpu = cpu.apply(on_cpu, {"tokens": toks.cpu()})[0].float()
            t_cpu = time.perf_counter() - t0
        atol = 2e-2 * float(h_cpu.abs().max())
        err = float((h_card - h_cpu).abs().max())
        rel = float((h_card - h_cpu).norm() / h_cpu.norm())
        if not torch.allclose(h_card, h_cpu, rtol=2e-2, atol=atol):
            raise AssertionError(f"{arch} depth 2: card and CPU differ beyond"
                                 f" rtol 2e-2, atol {atol:.3g}: max abs "
                                 f"{err:.3g}")
        log(f"[zoo-cpu] {arch} depth 2, B 1, S 256, full width: card vs CPU "
            f"max abs err {err:.4g} (atol {atol:.3g}, rtol 2e-2), relative "
            f"L2 {rel:.3g}; CPU forward {t_cpu:.2f} s")
        del params, on_cpu
        torch.cuda.empty_cache()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_cells(dev) -> None:
    import torch
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.stats import summarize
    from repro_torch.nmp.traces import make_trace
    for app, n, tech, mapper, forced in (("SPMV", 2048, "pei", "tom", -1),
                                         ("KM", 384, "pei", "aimm", 5)):
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
    t0 = time.perf_counter()
    results = run_program(tr, cfg, "bnmp", "aimm", episodes=2, seed=0,
                          device=dev)
    torch.cuda.synchronize()
    t_prog = time.perf_counter() - t0
    fused_prog = eops.launches["fused_epoch"]
    t0 = time.perf_counter()
    tom = run_episode(tr, cfg, "pei", "tom", seed=0, device=dev)
    torch.cuda.synchronize()
    t_tom = time.perf_counter() - t0
    launches = {**eops.launches, **qops.launches}
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
                 launches_folded=launches["tom_scores_folded"])}
    log(f"[main] launches: {json.dumps(launches)}; by shape "
        f"{json.dumps(split)}")
    tom_epochs = int(tom.metrics["valid"].shape[0])
    assert launches["fused_epoch"] == epochs, (launches, epochs)
    assert launches["dueling_qnet"] > 0, launches
    assert launches["tom_scores"] == 0, launches
    assert launches["tom_scores_folded"] == tom_epochs, (launches,
                                                         tom_epochs)
    # the TOM scorer's count on the main path: its scorings in any form
    launches["tom_scores"] += launches.pop("tom_scores_folded")
    return launches, split


def profiled(fn):
    """Run fn() under torch.profiler; returns (wall s with the profiler on,
    [(device us, launches, kernel name)] by kernel).  Fails if the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    """torch.profiler over one warm prefill forward (B 1, S 4096) and one
    serving loop of each arch, after their timed runs: device busy share,
    launches, and the top kernels by device time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    for arch in ZOO_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg, dev)
        params = model.init(0)
        toks = zoo_tokens(dev, cfg, ZOO_SEQ)
        prefill = lambda: model.logits(params, model.apply(
            params, {"tokens": toks})[0])
        with torch.inference_mode():
            prefill()
            runs = (("prefill", profiled(prefill)),
                    ("serve", profiled(lambda: serve(arch, params=params,
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
        del params, model
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

    kernels = phase_kernels(dev)
    phase_cells(dev)
    launches, split = phase_main_path(dev)
    phase_profile(dev)
    kernels += phase_zoo_kernels(dev)
    phase_zoo_card_vs_cpu(dev)
    launches.update(phase_zoo_model(dev))
    phase_zoo_profile(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k.update(split.get(k["name"], {}))
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
