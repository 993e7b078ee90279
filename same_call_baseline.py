#!/usr/bin/env python3
"""Time the first CUDA versions of the flash-attention and SSD-scan kernels
(commit 7317b40: mma.sync flash, f32 CUDA-core SSD) beside the current ones,
in turns on one card, at the main-path shapes of chip_smoke.py.

    mkdir -p build/baseline
    for n in flash_attention ssd_scan; do
        git show 7317b40:src/repro_torch/csrc/$n.cu > build/baseline/$n.cu
    done
    python3 same_call_baseline.py build/baseline

Those two sources have a C interface of their own, written out here
(flash's last int picks bf16; the SSD launcher takes nine buffers), so the
script builds only files whose sha256 is theirs and refuses any other.
They are built with the flags they were measured with (-fmad=false).  Each
kernel, earlier and current, is held against the plain version first;
then each pair is timed with chip_smoke.py's `graph_ms` in the order
earlier, current, current, earlier.  The last line is a JSON object with
the times.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import (ROOT, card_line, flash_inputs, graph_ms, log,
                        max_abs_err, ssd_inputs)

SHA256 = {
    "flash_attention":
        "fb7d5216653cb9ee143bd4cfe2fb906b748c303a906bc1902a795f55c4a83ceb",
    "ssd_scan":
        "8073ea2bb0d37a08e520b5ccce65fe411a47ee7934c4f8297b6d4d6e0a23a448",
}


def build_earlier(src_dir: Path) -> dict[str, ctypes.CDLL]:
    """Check, build (one nvcc per source, in parallel) and load the two
    earlier sources in `src_dir`."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "baseline_lib"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, want in SHA256.items():
        src = src_dir / f"{name}.cu"
        got = hashlib.sha256(src.read_bytes()).hexdigest()
        if got != want:
            raise SystemExit(f"{src}: sha256 {got} is not that of 7317b40's "
                             f"{name}.cu, whose C interface this script "
                             f"calls")
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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
