"""The AIMM agent searching a training run's sharding/mapping knobs, on the
PyTorch port.

The same continual dueling-DQN that remaps NMP pages drives microbatching,
remat policy, FSDP, int8-optimizer and expert-parallel decisions for any
assigned architecture, rewarded by the analytic roofline step time on a
mesh of H100 cards (the card's peaks and 80 GB, `launch/roofline.py`'s
`H100`), and is validated against exhaustive search over the knob lattice.

    PYTHONPATH=src python examples/torch_sharding_search.py --arch qwen3-32b

Like the NMP sweep engine, the example is grid-shaped: `--arch all` (or a
comma list) sweeps architectures x seeds and prints one row per cell with
the RL-vs-exhaustive optimality gap.  The CLI of
`examples/sharding_search.py` plus `--device` (default the card, where the
agent's Q network, TD step and draws run as kernels; `cpu` runs the
plain-torch path).
"""
import argparse

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core.sharding_mapper import Knobs, exhaustive_best, search


def _fmt(t):
    return "OOM" if t == float("inf") else f"{t*1e3:.1f} ms"


def run_one(arch: str, shape_name: str, steps: int, seed: int, verbose: bool,
            device: str = "cuda"):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    res = search(cfg, shape, steps=steps, seed=seed, device=device)
    gt, gt_t = exhaustive_best(cfg, shape)
    gap = (res.best_step_s / gt_t - 1) * 100 if gt_t > 0 else 0.0
    if verbose:
        print(f"arch={arch} shape={shape_name} mesh=16x16 (256 chips)")
        print(f"  start mapping : {Knobs()}  step={_fmt(res.baseline_step_s)}")
        print(f"  RL-found      : {res.best}  step={_fmt(res.best_step_s)}")
        print(f"  exhaustive    : {gt}  step={_fmt(gt_t)}")
        print(f"  RL vs optimum : {gap:+.1f}%")
        visited = len({k for k, _ in res.trajectory})
        print(f"  ({steps} invocations, {visited} distinct mappings visited; "
              f"exhaustive sweep is {6*3*2*2*2})")
    return res, gt_t, gap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b",
                    help="architecture, comma list, or 'all'")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per architecture in sweep mode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    for a in archs:
        if a not in ARCHS:
            raise SystemExit(f"unknown arch {a!r} (choices: "
                             f"{', '.join(ARCHS)})")

    if len(archs) == 1 and args.seeds == 1:
        run_one(archs[0], args.shape, args.steps, seed=0, verbose=True,
                device=args.device)
        return

    print(f"{'arch':28s} {'seed':>4s} {'RL step':>10s} {'optimum':>10s} "
          f"{'gap':>7s}")
    for arch in archs:
        for seed in range(args.seeds):
            res, gt_t, gap = run_one(arch, args.shape, args.steps, seed,
                                     verbose=False, device=args.device)
            print(f"{arch:28s} {seed:4d} {_fmt(res.best_step_s):>10s} "
                  f"{_fmt(gt_t):>10s} {gap:+6.1f}%")


if __name__ == "__main__":
    main()
