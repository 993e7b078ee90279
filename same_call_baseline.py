#!/usr/bin/env python3
"""Time earlier CUDA versions of the port's kernels beside the current ones,
in turns on one card, at the main-path shapes of chip_smoke.py: the first
flash-attention and SSD-scan kernels (commit 7317b40: mma.sync flash, f32
CUDA-core SSD), the first dueling-qnet and fused-epoch kernels (commit
191cdc3, before their Hopper redesign), and the epoch source of commit
f3c081c (the fused epoch redesigned, the TOM scorer of one warp per
candidate, before the scorer's redesign and its fold into the fused
launch) for the TOM scorer and the fused epoch's flag sets without TOM.

    mkdir -p build/baseline
    for n in flash_attention ssd_scan; do
        git show 7317b40:src/repro_torch/csrc/$n.cu > build/baseline/$n.cu
    done
    for n in dueling_qnet epoch_fused; do
        git show 191cdc3:src/repro_torch/csrc/$n.cu > build/baseline/$n.cu
    done
    git show f3c081c:src/repro_torch/csrc/epoch_fused.cu \
        > build/baseline/epoch_fused_f3c081c.cu
    python3 same_call_baseline.py build/baseline

The zoo sources have a C interface of their own, written out here (flash's
last int picks bf16; the SSD launcher takes nine buffers); the AIMM sources
have the current launchers' interface, so the current wrappers call them.
The script builds only files whose sha256 is that of those commits and
refuses any other.  They are built with the flags they were measured with
(-fmad=false).  Each kernel, earlier and current, is held against the plain
version first (the fused epoch in both main-path flag sets and the TOM
scorer, equal; the qnet at 64 and 1 rows, within 1e-4); then each pair is
timed with
chip_smoke.py's `graph_ms` in the order earlier, current, current, earlier.
The last line is a JSON object with the times.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import (ROOT, all_equal, card_line, epoch_inputs,
                        flash_inputs, graph_ms, log, max_abs_err, qnet_inputs,
                        ssd_inputs)

SHA256 = {   # file stem: (commit, sha256 of the csrc/ source there)
    "flash_attention": ("7317b40", "fb7d5216653cb9ee143bd4cfe2fb906b"
                        "748c303a906bc1902a795f55c4a83ceb"),
    "ssd_scan": ("7317b40", "8073ea2bb0d37a08e520b5ccce65fe41"
                 "1a47ee7934c4f8297b6d4d6e0a23a448"),
    "dueling_qnet": ("191cdc3", "152632dd4d17b6fa72daa2f2b3799"
                     "67d53c333651c2f8be87273998f7c163d70"),
    "epoch_fused": ("191cdc3", "3a91eed7b6bddf733f5c721c5846d"
                    "2546fca038542f95dafbbc271237ae4fdcd"),
    "epoch_fused_f3c081c": ("f3c081c", "5d9671986f7f7acdf9911132fc10bb"
                            "dc1e6a8ca51587cedc05302de14959399a"),
}


def build_earlier(src_dir: Path) -> dict[str, ctypes.CDLL]:
    """Check, build (one nvcc per source, in parallel) and load the
    earlier sources in `src_dir`."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "baseline_lib"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (commit, want) in SHA256.items():
        src = src_dir / f"{name}.cu"
        got = hashlib.sha256(src.read_bytes()).hexdigest()
        if got != want:
            raise SystemExit(f"{src}: sha256 {got} is not that of the "
                             f"{commit} source this script expects there, "
                             f"whose C interface it calls")
        out = out_dir / f"{name}.so"
        cmd = [build._nvcc(), *build.BASE_FLAGS, *build.EXACT_FLAGS, "-o",
               str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"earlier {name}.cu failed to build:\n{text}")
        libs[name] = ctypes.CDLL(str(out))
        libs[name].repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].repro_cuda_error_string.restype = ctypes.c_char_p
    fn = libs["flash_attention"].flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = libs["ssd_scan"].ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return libs


def through(lib: ctypes.CDLL, name: str, fn):
    """fn with the port's wrapper of `csrc/<name>.cu` launching from `lib`
    (an earlier build with the same C interface) instead of the current
    library."""
    from repro_torch.kernels import build

    def run():
        current = build.load(name)
        build._LIBS[name] = lib
        try:
            return fn()
        finally:
            build._LIBS[name] = current
    return run


def in_turns(earlier, current, reps: int) -> tuple[list, list]:
    """graph_ms in the order earlier, current, current, earlier."""
    e1, c1, c2, e2 = (graph_ms(f, reps)
                      for f in (earlier, current, current, earlier))
    return [e1, e2], [c1, c2]


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("same_call_baseline: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref, compare
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    libs = build_earlier(Path(sys.argv[1]))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    result = {"card": card}

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(dev, dtype)
        B, S, H, hd = q.shape
        K = k.shape[2]
        out = torch.empty_like(q)

        def earlier():
            code = libs["flash_attention"].flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, K, hd, hd ** -0.5, 1, int(dtype == torch.bfloat16),
                stream())
            if code:
                raise RuntimeError(f"earlier flash_attention: CUDA error "
                                   f"{code}")

        current = lambda: fops.gqa_flash_attention(q, k, v, causal=True)
        want = attention_ref(q.transpose(1, 2), *(
            t.repeat_interleave(H // K, dim=2).transpose(1, 2)
            for t in (k, v))).transpose(1, 2)
        earlier()
        cmps = [compare(out, want), compare(current(), want)]
        torch.cuda.synchronize()
        if not all(c["ok"] for c in cmps):
            raise AssertionError(f"flash_attention {dtype}: {cmps}")
        e_ms, c_ms = in_turns(earlier, current, 20)
        name = f"flash_attention_{str(dtype)[6:]}"
        result[name] = dict(earlier_ms=e_ms, current_ms=c_ms,
                            earlier_max_abs_err=cmps[0]["max_abs_err"],
                            current_max_abs_err=cmps[1]["max_abs_err"])
        log(f"[same-call] {name} B={B} S={S} H={H} K={K} hd={hd}: earlier "
            f"{e_ms[0]:.4f} / {e_ms[1]:.4f} ms, current {c_ms[0]:.4f} / "
            f"{c_ms[1]:.4f} ms (graph); max abs err earlier "
            f"{cmps[0]['max_abs_err']:.3g}, current "
            f"{cmps[1]['max_abs_err']:.3g}, both within BARS")
        del q, k, v, out, want

    Q = get_config("mamba2-370m").ssm.chunk
    x, b, c, dt, a = ssd_inputs(dev, carry=True)
    Bz, L, H, P = x.shape
    N, nc = b.shape[-1], L // Q
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = [torch.empty(s, **f32) for s in (
        (Bz, L, H, P), (Bz, nc, H, N, P), (Bz, nc, H), (Bz, nc, Q, Q))]

    def earlier():
        code = libs["ssd_scan"].ssd_scan_launch(
            *[t.data_ptr() for t in (x, b, c, dt, a, *scratch)], Bz, L, H,
            P, N, Q, stream())
        if code:
            raise RuntimeError(f"earlier ssd_scan: CUDA error {code}")

    current = lambda: sops.ssd(x, b, c, dt, a, chunk=Q)
    want = ssd_chunked(x, b, c, dt, a, chunk=Q)
    earlier()
    outs = [scratch[0], current()]
    errs = [max_abs_err(y, want) for y in outs]
    if not all(torch.allclose(y, want, rtol=1e-4, atol=1e-4) for y in outs):
        raise AssertionError(f"ssd_scan beyond 1e-4: {errs}")
    e_ms, c_ms = in_turns(earlier, current, 10)
    result["ssd_scan"] = dict(earlier_ms=e_ms, current_ms=c_ms,
                              earlier_max_abs_err=errs[0],
                              current_max_abs_err=errs[1])
    log(f"[same-call] ssd_scan B={Bz} L={L} H={H} P={P} N={N} chunk={Q} "
        f"(state carried): earlier {e_ms[0]:.4f} / {e_ms[1]:.4f} ms, current"
        f" {c_ms[0]:.4f} / {c_ms[1]:.4f} ms (graph); max abs err earlier "
        f"{errs[0]:.3g}, current {errs[1]:.3g} (tol 1e-4)")

    # ---- the AIMM kernels: fused epoch (both flag sets, against both
    # earlier sources), TOM scorer, dueling qnet ----
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.kernels.epoch_fused import ref as eref
    from repro_torch.nmp.baselines import tom_candidates
    from repro_torch.nmp.config import NMPConfig
    cfg = NMPConfig()
    x, topo, pei_k, tr = epoch_inputs(dev)
    epoch_libs = {SHA256[k][0]: libs[k]
                  for k in ("epoch_fused", "epoch_fused_f3c081c")}
    win = [x[k] for k in ("dest", "src1", "src2", "valid")]
    rt = dict(n_mcs=cfg.n_mcs, packet_flits=cfg.packet_flits)
    for label, pei, aimm, tech_id in (("bnmp+aimm", False, True, 0),
                                      ("pei", True, False, 2)):
        tech = torch.tensor([tech_id], dtype=torch.int32, device=dev)
        k = pei_k if pei else 0
        current = lambda: eops.fused_parts(
            *win, x["epochs"], x["rb_stamp"], x["page_ema"], x["n_pages"],
            x["pei_idx"], x["eff_table"], x["compute_remap"], tech,
            x["is_aimm"], x["pending"], topo, pei_k=k, aimm=aimm, **rt)
        sp = eref.shared_stage(*win, x["epochs"], x["rb_stamp"],
                               x["page_ema"] if pei else None, x["n_pages"],
                               x["pei_idx"], pei_k=k, aimm=aimm)
        rp = eref.route_stage(*win, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                              x["eff_table"], x["compute_remap"], tech,
                              x["is_aimm"], x["pending"], topo.routes_flat,
                              topo.hops_flat, topo.nearest_mc, pei=pei,
                              aimm=aimm, **rt)
        if not all_equal(current(), (sp, rp)):
            raise AssertionError(f"fused_epoch {label}: not equal to plain")
        for commit, lib in epoch_libs.items():
            earlier = through(lib, "epoch_fused", current)
            if not all_equal(earlier(), (sp, rp)):
                raise AssertionError(f"fused_epoch {label} of {commit}: not "
                                     f"equal to plain")
            e_ms, c_ms = in_turns(earlier, current, 100)
            result[f"fused_epoch_{label}_vs_{commit}"] = dict(
                earlier_ms=e_ms, current_ms=c_ms)
            log(f"[same-call] fused_epoch {label}: {commit} {e_ms[0]:.5f} / "
                f"{e_ms[1]:.5f} ms, current {c_ms[0]:.5f} / {c_ms[1]:.5f} ms "
                f"(graph); both equal to the plain version")
    cands = tom_candidates(tr.n_pages, cfg, dev)
    C = cfg.n_cubes
    current = lambda: eops.tom_scores(*win, cands, C)
    earlier = through(epoch_libs["f3c081c"], "epoch_fused", current)
    want = eref.tom_stage(*win, cands, C)
    if not (torch.equal(earlier(), want) and torch.equal(current(), want)):
        raise AssertionError("tom_scores: not equal to plain")
    e_ms, c_ms = in_turns(earlier, current, 100)
    result["tom_scores_vs_f3c081c"] = dict(earlier_ms=e_ms, current_ms=c_ms)
    log(f"[same-call] tom_scores K={cands.shape[0]}: f3c081c {e_ms[0]:.5f} / "
        f"{e_ms[1]:.5f} ms, current {c_ms[0]:.5f} / {c_ms[1]:.5f} ms (graph);"
        f" both equal to the plain version")
    params, rows = qnet_inputs(dev)
    keys = ("w0", "b0", "w1", "b1", "w_v", "b_v", "w_a", "b_a")
    for n, xs in rows.items():
        current = lambda: qops.qnet_forward(params, xs)
        earlier = through(libs["dueling_qnet"], "dueling_qnet", current)
        want = dueling_qnet_ref(xs, *[params[k] for k in keys])
        outs = [earlier(), current()]
        errs = [max_abs_err(q, want) for q in outs]
        if not all(torch.allclose(q, want, rtol=1e-4, atol=1e-4)
                   for q in outs):
            raise AssertionError(f"dueling_qnet N={n} beyond 1e-4: {errs}")
        e_ms, c_ms = in_turns(earlier, current, 100)
        result[f"dueling_qnet_n{n}"] = dict(
            earlier_ms=e_ms, current_ms=c_ms, earlier_max_abs_err=errs[0],
            current_max_abs_err=errs[1])
        log(f"[same-call] dueling_qnet N={n}: earlier {e_ms[0]:.5f} / "
            f"{e_ms[1]:.5f} ms, current {c_ms[0]:.5f} / {c_ms[1]:.5f} ms "
            f"(graph); max abs err earlier {errs[0]:.3g}, current "
            f"{errs[1]:.3g} (tol 1e-4)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
