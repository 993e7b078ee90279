"""Batched serving entry point: continuous-batching greedy decode.

    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --requests 4

`--arch` takes every arch of `repro_torch.configs` (dense, sliding-window,
MoE, Mamba2, hybrid, encoder-decoder and vision: their cross caches are
zeros, as the reference's server never fills them).  Runs on the CUDA card unless `--device cpu` is
given; without a card it raises rather than drop to the CPU.  Weights are
drawn from `--seed` on the device (there is nothing to download).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve(cfg, *, requests: int = 4, batch: int = 4, max_seq: int = 128,
          max_new: int = 16, device: str = "cuda", seed: int = 0,
          params=None):
    """Serve `requests` random prompts of 8 tokens to completion with the
    model of `cfg` (a `ModelConfig`), on `params` or weights drawn from
    `seed`.  Returns (requests, decode steps, wall seconds of the serving
    loop)."""
    from repro_torch.models import build_model
    from repro_torch.train.serve_step import BatchServer, Request

    model = build_model(cfg, device)
    if params is None:
        params = model.init(seed)
    server = BatchServer(model, params, batch=batch, max_seq=max_seq)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, 8).tolist(),
                    max_new=max_new) for _ in range(requests)]
    pending = list(reqs)
    steps = 0
    t0 = time.perf_counter()
    while pending or any(server.slots):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
        steps += 1
        if steps > 10000:
            break
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return reqs, steps, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    with torch.inference_mode():
        reqs, steps, wall = serve(
            get_config(args.arch, smoke=args.smoke), requests=args.requests,
            batch=args.batch, max_seq=args.max_seq, max_new=args.max_new,
            device=args.device, seed=args.seed)
    done = [r for r in reqs if r.done]
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt={r.prompt[:4]}... -> {r.generated}")
    print(f"[serve] {len(done)}/{len(reqs)} completed in {steps} decode steps"
          f" ({wall:.3f} s on {args.device})")
    return 0 if len(done) == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
