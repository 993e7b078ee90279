#!/usr/bin/env python3
"""Run a training cell's restart drill on the card with f32 Adam moments,
and time its checkpoint I/O and the device memory of its restore.

    python3 train_restart_probe.py                      # minitron-8b, 4 layers
    python3 train_restart_probe.py --arch mamba2-370m --layers 0

`launch/train.py`'s `train` at chip_smoke.py's training cell (S 4096,
global batch 2 in 2 microbatches, 4 steps, a checkpoint every 2, a node
failure injected before step 3, so step 2 runs twice), with the plain
AdamW whose moments are f32.  chip_smoke.py trains minitron-8b with int8
moments instead, since the f32-moment checkpoint's I/O would not fit its
time budget; this script is that configuration's proof and timing.  It
prints the card's name and power limit, then one JSON object: each
checkpoint write's and read's seconds and bytes, the device memory
allocated before and after the restore's copy, the peak before it,
during it and from it to the end, the step times and the losses.  It
exits 1 unless the losses are finite, the loop restarted once and the
replayed step gave the first run's loss.

Only the step-2 checkpoint, the one the restart reads, is written: the
final commit at step 4 is skipped (its entry has seconds null), which
keeps the run's disk writes at one 29 GB checkpoint, not 58 GB.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--layers", type=int, default=4,
                    help="cut the depth to this many layers (0: full)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_restart_probe.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.train import train
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import CheckpointManager
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)

    writes, reads, loads = [], [], []
    write, restore, load_into = (CheckpointManager._write,
                                 CheckpointManager.restore, loop._load_into)

    def timed_write(self, step, arrays, meta, host_id):
        if step > 2:            # see the docstring: the final commit
            writes.append(dict(step=step, s=None, bytes=0))
            return
        t0 = time.perf_counter()
        write(self, step, arrays, meta, host_id)
        writes.append(dict(step=step, s=time.perf_counter() - t0,
                           bytes=sum(a.nbytes for a in arrays.values())))

    def timed_restore(self, *a, **k):
        t0 = time.perf_counter()
        out = restore(self, *a, **k)
        reads.append(dict(step=out[1]["step"], s=time.perf_counter() - t0))
        return out

    def measured_load_into(params, opt_state, tree):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        load_into(params, opt_state, tree)
        torch.cuda.synchronize()
        loads.append(dict(s=time.perf_counter() - t0,
                          peak_before_gib=peak_before / 2**30,
                          allocated_before_gib=before / 2**30,
                          allocated_after_gib=torch.cuda.memory_allocated()
                          / 2**30,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30))

    ckpt_dir = ROOT / "build" / "train_restart_probe"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    CheckpointManager._write, CheckpointManager.restore = (timed_write,
                                                           timed_restore)
    loop._load_into = measured_load_into
    t0 = time.perf_counter()
    try:
        res = train(args.arch, steps=4, seq=4096, global_batch=2,
                    microbatches=2, device="cuda",
                    layers=args.layers or None, fail_at=(3,),
                    checkpoint_every=2, keep=1, ckpt_dir=str(ckpt_dir),
                    log=lambda m: print(m, flush=True))
    finally:
        CheckpointManager._write, CheckpointManager.restore = write, restore
        loop._load_into = load_into
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    peak_since_restore = torch.cuda.max_memory_allocated() / 2**30
    L = res["losses"]
    out = dict(arch=args.arch, layers=res["cfg"].n_layers, moments="f32",
               losses=L, restarts=res["restarts"],
               step_s=res["step_times"], writes=writes, reads=reads,
               restore_copy=loads,
               peak_since_restore_gib=peak_since_restore, wall_s=wall)
    del res
    print(json.dumps(out), flush=True)
    ok = (all(math.isfinite(x) for x in L) and out["restarts"] == 1
          and len(L) == 5 and L[2] == L[3] and len(loads) == 1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
