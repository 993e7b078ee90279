#!/usr/bin/env python3
"""Time the flash-attention kernels of another checkout beside this one's,
in turns (other, this, this, other), each in a process of its own on the
same card.

    git archive <commit> | tar -x -C build/other
    python3 flash_in_turns.py build/other

Each process builds its checkout's `csrc/flash_attention.cu` into that
checkout's own `build/repro_torch/`, and, at minitron-8b's prefill shape
(B 1, S 4096, H 32, K 8: the shape every checkout since the wgmma kernel
takes), checks each kernel against the plain version within `BARS` and
times `gqa_flash_attention` as chip_smoke.py does (device time per launch
from a CUDA graph of 20 launches, best of 5 replays, three times): the
wgmma kernel (bf16, hd 128), the CUDA-core kernel (f32, hd 128) and the
mma.sync kernel (bf16, hd 32).  It prints one line per process and kernel
and the medians; the card's name and power limit come first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (name, dtype, head dim) of the kernels timed
KERNELS = (("wgmma_bf16", "bfloat16", None), ("cuda_core_f32", "float32", None),
           ("mma_sync_bf16", "bfloat16", 32))

CHILD = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
from chip_smoke import flash_inputs, graph_ms
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref, compare
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {{}}
for name, dtype, hd in {kernels!r}:
    q, k, v = flash_inputs(dev, getattr(torch, dtype), hd=hd)
    run = lambda: ops.gqa_flash_attention(q, k, v, causal=True)
    kk, vv = (t.repeat_interleave(4, dim=2).transpose(1, 2) for t in (k, v))
    cmp = compare(run(), attention_ref(q.transpose(1, 2), kk, vv
                                       ).transpose(1, 2))
    assert cmp["ok"], (name, cmp)
    out[name] = {{"ms": [graph_ms(run, 20) for _ in range(3)],
                  "max_abs_err": cmp["max_abs_err"]}}
    del q, k, v, kk, vv
print(json.dumps(out))
"""


def time_checkout(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD.format(
        root=str(root), kernels=KERNELS)], capture_output=True, text=True,
        cwd=root)
    if out.returncode:
        raise RuntimeError(f"{root}: rc {out.returncode}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_in_turns: needs a CUDA card", file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    runs = {name: {"other": [], "this": []} for name, _, _ in KERNELS}
    for side in ("other", "this", "this", "other"):
        res = time_checkout(other if side == "other" else ROOT)
        for name, r in res.items():
            runs[name][side] += r["ms"]
            print(f"[flash-in-turns] {side} {name}: "
                  f"{', '.join(f'{m:.5f}' for m in r['ms'])} ms/launch "
                  f"(max abs err {r['max_abs_err']:.3g})", flush=True)
    med = {name: {side: statistics.median(ms) for side, ms in r.items()}
           for name, r in runs.items()}
    for name, m in med.items():
        print(f"[flash-in-turns] {name} median ms/launch: other "
              f"{m['other']:.5f}, this {m['this']:.5f} ({other})")
    print(json.dumps({"card": card, "median_ms": med, "ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
