#!/usr/bin/env python3
"""Time one main-path AIMM episode of another checkout of this repository
beside this one's, in turns on one card: other, this, this, other.  Episode
wall times are host-bound and spread between machines, so two versions are
compared only inside one call.

    git archive <commit> | tar -x -C build/parent
    python3 episode_in_turns.py build/parent [--mapper tom] [--reps 3]

Each turn is a process of its own that imports `repro_torch` from its
checkout's `src/` (building that checkout's kernels there), runs one warm
episode of BP/16384 (`pei`/`tom` or `bnmp`/`aimm`, seed 0) and then times
`--reps` more, ending each in `torch.cuda.synchronize()`.  It prints one
line per turn and a JSON object of the seconds per episode as its last
line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TURN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.engine import run_episode
from repro_torch.nmp.traces import make_trace
tech, mapper, reps = sys.argv[2], sys.argv[3], int(sys.argv[4])
tr = make_trace("BP", n_ops=16384)
run = lambda: run_episode(tr, NMPConfig(), tech, mapper, seed=0,
                          device="cuda")
run()
torch.cuda.synchronize()
secs = []
for _ in range(reps):
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
print(json.dumps(secs))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--mapper", choices=("tom", "aimm"), default="tom")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    tech = "pei" if args.mapper == "tom" else "bnmp"
    roots = {"other": args.other.resolve(), "this": ROOT}
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, "-c", TURN, str(roots[who] / "src"), tech,
             args.mapper, str(args.reps)],
            capture_output=True, text=True, check=True, timeout=900,
            cwd=roots[who]).stdout
        secs = json.loads(out.strip().splitlines()[-1])
        times[who] += secs
        print(f"[turn] {who} ({roots[who]}): BP/16384 {tech}/{args.mapper} "
              f"{', '.join(f'{s:.3f}' for s in secs)} s/episode",
              flush=True)
    print(json.dumps({"episode": f"BP/16384 {tech}/{args.mapper}",
                      "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
