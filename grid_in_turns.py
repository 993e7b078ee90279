#!/usr/bin/env python3
"""Time the 135-cell figure grid of `chip_smoke.py` (`run_grid` on the
paper's Table-1 system) under two settings of one knob, in turns on one
card: A, B, B, A after one warm run, each run ending in
`torch.cuda.synchronize()`.

    python3 grid_in_turns.py [--vary land td_step]

`land`: REPRO_SWEEP_LAND=async (A, the default) against sync (B); every
run's metrics must equal the warm run's.  `td_step`: the TD step's
batch-invariant kernels (A, `kernels/batched_linear`) against the plain
torch versions (B: cuBLAS batched matmuls and torch sums, the order that
made a grid's learned cells part from their serial runs); only the wall
is read for B.  Grid walls are host-bound and spread between machines,
so the two settings are compared only inside one call.  It prints one
line per run and a JSON object of the walls as its last line; it needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from chip_smoke import card_line, figure_grid


@contextlib.contextmanager
def land(mode: str):
    knob = os.environ.get("REPRO_SWEEP_LAND")
    os.environ["REPRO_SWEEP_LAND"] = mode
    try:
        yield
    finally:
        if knob is None:
            os.environ.pop("REPRO_SWEEP_LAND", None)
        else:
            os.environ["REPRO_SWEEP_LAND"] = knob


@contextlib.contextmanager
def td_step(which: str):
    from repro_torch.core import dqn
    from repro_torch.kernels.batched_linear import ref
    from repro_torch.train import optimizer
    saved = dqn.linear, optimizer.sq_norm
    if which == "plain":
        dqn.linear, optimizer.sq_norm = ref.linear, ref.sq_norm
    try:
        yield
    finally:
        dqn.linear, optimizer.sq_norm = saved


KNOBS = {"land": (land, ("async", "sync"), True),
         "td_step": (td_step, ("kernels", "plain"), False)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vary", nargs="+", choices=tuple(KNOBS),
                    default=list(KNOBS))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("grid_in_turns: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.sweep import run_grid
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {card_line()}", flush=True)
    cfg, grid, dev = NMPConfig(), figure_grid(), torch.device("cuda")
    first = run_grid(grid, cfg, device=dev).metrics           # warm
    walls = {}
    for name in args.vary:
        ctx, (a, b), same = KNOBS[name]
        for setting in (a, b, b, a):
            with ctx(setting):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run_grid(grid, cfg, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls.setdefault(name, {}).setdefault(setting, []).append(wall)
            if (same or setting == a) and not all(
                    np.array_equal(res.metrics[k], first[k]) for k in first):
                raise AssertionError(f"{name}={setting}: metrics differ "
                                     f"from the warm run's")
            print(f"[turn] {name}={setting}: run_grid {len(grid)} cells "
                  f"{wall:.3f} s", flush=True)
    print(json.dumps({"cells": len(grid), "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
