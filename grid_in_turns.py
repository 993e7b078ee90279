#!/usr/bin/env python3
"""Time the 135-cell figure grid of `chip_smoke.py` (`run_grid` on the
paper's Table-1 system) under the settings of one knob, in turns on one
card: A, B, B, A (A, B, C, C, B, A for three) after one warm run, each
run ending in `torch.cuda.synchronize()`.

    python3 grid_in_turns.py [--vary land td_step]

`land`: REPRO_SWEEP_LAND=async (A, the default) against sync (B); every
run's metrics must equal the warm run's.  `td_step`: the TD step the three
`chip_smoke.TD_PATHS` ways: the port's kernels (A: one `td_grad` and one
`adamw_lanes` launch a step), the card path before them (B: autograd over
`batched_linear`'s batch-invariant products, its norm and the optimizer's
torch ops) and plain torch (C: cuBLAS batched matmuls and torch sums, the
order that made a grid's learned cells part from their serial runs); A's
metrics must equal the warm run's, only the wall is read for B and C.
Grid walls are host-bound and spread between machines, so the settings
are compared only inside one call.  It prints one
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

from chip_smoke import TD_PATHS, card_line, figure_grid, td_path


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


KNOBS = {"land": (land, ("async", "sync"), True),
         "td_step": (td_path, TD_PATHS, False)}


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
        ctx, settings, same = KNOBS[name]
        a = settings[0]
        for setting in settings + settings[::-1]:
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
