"""Training driver (port of `repro/launch/train.py`): an arch's model, the
train step, the synthetic data pipeline and the fault-tolerant loop on one
device.

    python -m repro_torch.launch.train --arch minitron-8b --smoke --steps 50
    python -m repro_torch.launch.train --arch mamba2-370m --smoke --steps 4 \\
        --device cpu

The reference's flags, plus `--device` (default the card; `cpu` runs the
plain-torch path, as `launch/serve.py`) and `--layers` (cut the depth,
for a full-width model whose training state would not fit the card).
`train` also takes the restart drill (`fail_at`, `checkpoint_every`) as
keyword arguments.  The reference places the model on a mesh of
`--data-parallel` x `--model-parallel` devices; the port runs on one,
and either flag above 1 raises NotImplementedError (ROADMAP.md queue 1
items 2 and 4).  Weights are drawn from seed 0 on the device, as the
reference's PRNGKey(0); AdamW (lr 1e-3, weight decay 0.01, clip 1.0), or
its int8-moment form with `--quantized-opt`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable

import torch


def train(arch: str, *, smoke: bool = False, steps: int = 50, seq: int = 128,
          global_batch: int = 4, microbatches: int = 1,
          data_parallel: int = 0, model_parallel: int = 1,
          ckpt_dir: str | None = None, quantized_opt: bool = False,
          device: str = "cuda", layers: int | None = None,
          fail_at: tuple[int, ...] = (), checkpoint_every: int | None = None,
          keep: int = 3, log: Callable = print) -> dict:
    """Train `arch` for `steps` steps; returns `train_loop`'s result plus
    the config (`cfg`) and the tokens a step takes (`tokens_per_step`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, count_params
    from repro_torch.train.data import DataConfig, SyntheticDataset
    from repro_torch.train.elastic import SimulatedFailures
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_train_step

    if data_parallel > 1 or model_parallel > 1:
        raise NotImplementedError(
            f"launch.train: data_parallel {data_parallel} x model_parallel "
            f"{model_parallel} needs the sharding and multi-device slices, "
            f"not ported yet (ROADMAP.md queue 1 items 2 and 4); the port "
            f"trains on one device")
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    log(f"[train] arch={cfg.name} layers={cfg.n_layers} "
        f"params={count_params(cfg) / 1e6:.1f}M device={device}")
    model = build_model(cfg, device)
    params = model.init(0)
    opt = (quantized_adamw if quantized_opt else adamw)(
        1e-3, weight_decay=0.01, grad_clip=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=seq,
                                       global_batch=global_batch),
                            device=model.device)
    loop = LoopConfig(
        total_steps=steps,
        checkpoint_every=checkpoint_every or max(steps // 2, 10),
        checkpoint_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                "repro_torch_launch_train"),
        keep=keep, log_every=10)
    res = train_loop(step_fn, params, opt_state, data, loop,
                     failures=SimulatedFailures(tuple(fail_at)), log=log,
                     model_cfg=cfg)
    log(f"[train] final loss {res['losses'][-1]:.4f}")
    return {**res, "cfg": cfg, "tokens_per_step": global_batch * seq}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="0 = one device (the port trains on one)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_launch_train in the temp dir")
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    res = train(args.arch, smoke=args.smoke, steps=args.steps, seq=args.seq,
                global_batch=args.global_batch,
                microbatches=args.microbatches,
                data_parallel=args.data_parallel,
                model_parallel=args.model_parallel, ckpt_dir=args.ckpt_dir,
                quantized_opt=args.quantized_opt, device=args.device,
                layers=args.layers)
    ok = all(torch.isfinite(torch.tensor(res["losses"])).tolist())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
