"""Paper reproduction demo on the PyTorch port: Fig. 6-style table for one
or all apps — techniques {BNMP, LDB, PEI} x mappers {Baseline, TOM, AIMM}.

The whole table is one batched sweep (`sweep.run_grid`): every
(app, technique, mapper) cell is a lane of one batched run on the device
instead of a serial run per cell.

    PYTHONPATH=src python examples/torch_nmp_aimm_demo.py [--app SPMV | --all]

The CLI of `examples/nmp_aimm_demo.py` plus `--device` (default the card;
`cpu` runs the port's plain-torch path).
"""
import argparse

from repro_torch.nmp import NMPConfig
from repro_torch.nmp.scenarios import single_program_grid
from repro_torch.nmp.sweep import run_grid
from repro_torch.nmp.traces import APPS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="PR")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--n-ops", type=int, default=16384)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = NMPConfig()
    apps = APPS if args.all else [args.app]
    grid = single_program_grid(apps=apps,
                               techniques=("bnmp", "ldb", "pei"),
                               mappers=("none", "tom", "aimm"),
                               n_ops=args.n_ops,
                               aimm_episodes=args.episodes)
    res = run_grid(grid, cfg, device=args.device)
    cell = {sc.name: res.episode_summary(i)["cycles"]
            for i, sc in enumerate(grid)}

    print(f"{'app':6s} {'tech':5s} {'B':>6s} {'TOM':>6s} {'AIMM':>6s}   "
          "(execution time normalized to each technique's baseline; "
          f"{len(grid)} lanes in {res.wall_s:.1f}s batched)")
    for app in apps:
        for tech in ("bnmp", "ldb", "pei"):
            base = cell[f"{app}/{tech}/none/s0"]
            tom = cell[f"{app}/{tech}/tom/s0"]
            aimm = cell[f"{app}/{tech}/aimm/s0"]
            print(f"{app:6s} {tech:5s} {1.0:6.2f} {tom / base:6.2f} "
                  f"{aimm / base:6.2f}")


if __name__ == "__main__":
    main()
