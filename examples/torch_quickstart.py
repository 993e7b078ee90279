"""Quickstart on the PyTorch port: AIMM improving an NMP workload.

    PYTHONPATH=src python examples/torch_quickstart.py [--app SPMV]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The CLI of `examples/quickstart.py` plus `--device` (default the card;
`cpu` runs the port's plain-torch path).
"""
import argparse

from repro_torch.nmp import NMPConfig, make_trace, run_episode, run_program
from repro_torch.nmp.stats import summarize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="PR", help="BP LUD KM MAC PR RBM RD SC SPMV")
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = NMPConfig()                       # paper Table 1: 4x4 cube mesh
    trace = make_trace(args.app, n_ops=16384)

    base = summarize(run_episode(trace, cfg, technique="bnmp", mapper="none",
                                 device=args.device))
    print(f"BNMP baseline : OPC={base['opc']:.3f} cycles={base['cycles']:.0f}")

    results = run_program(trace, cfg, technique="bnmp", mapper="aimm",
                          episodes=args.episodes, seed=0, device=args.device)
    for i, r in enumerate(results):
        s = summarize(r)
        print(f"AIMM episode {i}: OPC={s['opc']:.3f} "
              f"speedup={base['cycles'] / s['cycles']:.2f}x "
              f"migrations={s['migrations']:.0f} "
              f"util={s['compute_util']:.2f}")
    print("(the dueling-DQN persists across episodes — the paper's "
          "continual-learning protocol)")


if __name__ == "__main__":
    main()
