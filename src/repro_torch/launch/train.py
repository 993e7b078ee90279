"""Training driver (port of `repro/launch/train.py`): an arch's model, the
train step, the synthetic data pipeline and the fault-tolerant loop on a
`data` x `model` mesh of processes, one card each.

    python -m repro_torch.launch.train --arch minitron-8b --smoke --steps 50
    python -m repro_torch.launch.train --arch mamba2-370m --smoke --steps 4 \\
        --device cpu

The reference's flags, plus `--device` (default the card; `cpu` runs the
plain-torch path, as `launch/serve.py`) and `--layers` (cut the depth,
for a full-width model whose training state would not fit the card).
`train` also takes the restart drill (`fail_at`, `checkpoint_every`) as
keyword arguments; `checkpoint_every=0` writes no checkpoint at all.

The mesh: every rank runs the same command, started with REPRO_DIST_COORD
/ REPRO_DIST_NPROCS / REPRO_DIST_RANK (`launch.mesh.join_group`; on the
card `nccl` for CUDA tensors, on the CPU `gloo`).  As the reference,
`--data-parallel` 0 takes every rank the model axis leaves, dp = world /
`--model-parallel`.  Each rank inits the whole model from seed 0, then
keeps its shards (`policies.distribute` by `param_specs`, the optimizer
state by `opt_state_specs`); the batch is a DTensor of `batch_specs`'
placements, each rank making its data coordinate's rows; the gradients
are held to `param_specs` (the reference's `grad_shardings=pspecs`).  A
process without a group trains on one device with plain tensors; in a
group (of one rank too) the mesh takes every rank, and a mesh of another
size raises a ValueError that names the knobs.  Only rank 0 logs.

Weights are drawn from seed 0 on the device, as the reference's
PRNGKey(0); AdamW (lr 1e-3, weight decay 0.01, clip 1.0), or its
int8-moment form with `--quantized-opt`.
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
          keep: int = 3, remat: str | None = None, opt=None,
          log: Callable = print) -> dict:
    """Train `arch` for `steps` steps; returns `train_loop`'s result plus
    the config (`cfg`), the tokens a step takes (`tokens_per_step`) and the
    mesh (`mesh`, None without a process group).  `remat` overrides the
    config's ("block" by default; models/transformer.py); `opt` replaces
    the default optimizer by one of the kind `quantized_opt` names (int8
    moments or not: their placements follow it)."""
    import torch.distributed as dist
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.mesh import DIST_KNOBS, join_group, make_host_mesh
    from repro_torch.models.model import (abstract_init, build_model,
                                          count_params)
    from repro_torch.sharding import policies as P
    from repro_torch.train.data import DataConfig, SyntheticDataset
    from repro_torch.train.elastic import SimulatedFailures
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_train_step

    dev = resolve_device(device)
    join_group(dev.type)
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    dp = data_parallel or max(world // model_parallel, 1)
    if dp * model_parallel != world:
        alone = "" if world > 1 else (
            "; this process is alone (no process group): the trainer runs "
            "one process per card, so start one process for each rank")
        raise ValueError(
            f"launch.train: a {dp} x {model_parallel} (data x model) mesh "
            f"needs {dp * model_parallel} ranks and the process group has "
            f"{world}{alone}; every rank of the mesh is one process, joined "
            f"by {DIST_KNOBS}")
    mesh = None
    if dist.is_initialized():
        if dev.type == "cuda" and "nccl" not in dist.get_backend():
            raise RuntimeError(
                f"launch.train: the process group's backend is "
                f"{dist.get_backend()!r}; CUDA tensors need nccl")
        mesh = make_host_mesh(dp, model_parallel, dev.type)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    log = log if rank == 0 else (lambda msg: None)     # rank 0 speaks
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    log(f"[train] arch={cfg.name} layers={cfg.n_layers} "
        f"params={count_params(cfg) / 1e6:.1f}M remat={cfg.remat} "
        f"mesh={{'data': {dp}, 'model': {model_parallel}}} device={dev}")
    model = build_model(cfg, dev)
    params, roles = model.init(0)
    if opt is None:
        opt = (quantized_adamw if quantized_opt else adamw)(
            1e-3, weight_decay=0.01, grad_clip=1.0)
    opt_state = opt.init(params)
    data_cfg = DataConfig(vocab=cfg.vocab, seq=seq, global_batch=global_batch)
    if mesh is None:
        step_fn = make_train_step(model, opt, microbatches=microbatches)
        data = SyntheticDataset(data_cfg, device=model.device)
    else:
        shapes, _ = abstract_init(model)
        pspecs = P.param_specs(roles, shapes, cfg, mesh)
        params = P.distribute(params, pspecs, mesh)
        opt_state = P.distribute(opt_state, P.opt_state_specs(
            pspecs, shapes, mesh, cfg, quantized=quantized_opt), mesh)

        def batch_specs(rows: int) -> dict:
            shape = ShapeCfg("train", seq, rows, "train")
            specs = P.batch_specs(cfg, shape, mesh, model.input_specs(shape))
            return {k: specs[k] for k in ("tokens", "labels")}

        step_fn = make_train_step(
            model, opt, microbatches=microbatches, grad_shardings=pspecs,
            batch_shardings=batch_specs(global_batch // microbatches))
        data = SyntheticDataset(
            data_cfg, device=model.device, mesh=mesh,
            placements=batch_specs(global_batch)["tokens"].placements)
    loop = LoopConfig(
        total_steps=steps,
        checkpoint_every=(max(steps // 2, 10) if checkpoint_every is None
                          else checkpoint_every),
        checkpoint_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                "repro_torch_launch_train"),
        keep=keep, log_every=10)
    res = train_loop(step_fn, params, opt_state, data, loop,
                     failures=SimulatedFailures(tuple(fail_at)), log=log,
                     model_cfg=cfg)
    log(f"[train] final loss {res['losses'][-1]:.4f}")
    return {**res, "cfg": cfg, "tokens_per_step": global_batch * seq,
            "mesh": mesh}


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
                    help="0 = every rank of the group the model axis leaves")
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
