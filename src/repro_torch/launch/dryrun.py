"""Multi-pod dry run (port of `repro/launch/dryrun.py`): every (architecture x
input shape) on the production meshes, 16 x 16 (one pod, 256 H100s) and
2 x 16 x 16 (two pods, 512), counted for memory, FLOPs and collectives.

How it runs.  The mesh is a `fake` process group of 256 (512) ranks in this
one process (`launch.mesh.fake_world`): this process is rank 0, and a
collective moves nothing.  The two-pod mesh runs as (32, 16), its pod axis
folded into data (`launch.mesh.make_production_mesh`: the same ranks
under every placement the policies give).  Params, optimizer state and batch are DTensors
placed by `sharding.policies`, each local shard a `meta` tensor (nothing
allocated).  The port's real step (`make_train_step`, a prefill, the serve
step) is traced by `roofline.count_step_costs` at one and two super-block
periods, each with two microbatches of the cell's microbatch size, and
scaled to full depth and microbatch count (`roofline.period_scaled`, the
reference's scan correction): the FLOPs and collective bytes per card.  The reference
lowers and compiles; here the trace is all (`lower_s`), and nothing is
compiled (`compile_s` 0.0).

Memory per card: `argument_bytes_per_device` sums this rank's shards of the
full-depth params, optimizer state and batch; `temp_bytes_per_device` is
the peak of what the step allocates beyond them (`roofline._peak_mode`, on the
meta shards) at one and two periods (two microbatches), extrapolated
linearly to full depth;
`fits_hbm` holds the total to `Chip.hbm_bytes` (80 GB).  The roofline takes
the counted FLOPs and collective bytes x cards and the analytic
`memory_model.memory_bytes`, at the H100's peaks; `collective_net_s`
charges the collectives at the network's rate (every collective of these
meshes crosses hosts; `roofline.py`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json [--workers 6]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch.mesh import axis_sizes, fake_world, \
    make_production_mesh
from repro_torch.launch.roofline import H100, Roofline, count_step_costs, \
    period_scaled
from repro_torch.models.model import abstract_init, build_model, model_flops
from repro_torch.sharding import policies
from repro_torch.sharding.context import sharding_ctx
from repro_torch.train.optimizer import adamw, quantized_adamw
from repro_torch.train.serve_step import make_serve_step
from repro_torch.train.train_step import make_train_step

# Training memory knobs per arch (microbatching + int8 moments for the 398B).
TRAIN_MICROBATCH = {"default": 8, "jamba-1.5-large-398b": 16}
QUANTIZED_OPT = {"jamba-1.5-large-398b", "mixtral-8x22b"}
# Baseline uses full remat for training (save only super-block boundaries);
# block-level dot-saving is a variant (memory <-> recompute tradeoff).
TRAIN_REMAT = "full"
# one fake group for every cell of a process: the two-pod mesh's 512 ranks
# (the one-pod mesh takes the first 256)
WORLD = 512


def apply_variant(cfg, variant: str, mesh):
    """The reference's beyond-baseline variants, applied per variant tag."""
    if variant == "baseline":
        return cfg
    sizes = axis_sizes(mesh)
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    if cfg.moe is not None and "moe_local" in variant:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=data))
    if cfg.moe is not None and "moe_tp" in variant:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=data, prefer_tp=True))
    if "remat_block" in variant:
        cfg = dataclasses.replace(cfg, remat="block")
    if "remat_none" in variant:
        cfg = dataclasses.replace(cfg, remat="none")
    if "seqpar" in variant:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    if "savear" in variant:
        cfg = dataclasses.replace(cfg, remat="collectives")
    return cfg


def at_depth(cfg, periods: int):
    """cfg cut to `periods` super-block periods (the encoder's layers cut
    in the same ratio; the leading dense blocks kept)."""
    enc = cfg.encoder
    if enc is not None:
        if enc.n_layers % cfg.n_super:
            raise ValueError(f"{cfg.name}: {enc.n_layers} encoder layers do "
                             f"not scale with {cfg.n_super} periods")
        enc = dataclasses.replace(
            enc, n_layers=enc.n_layers // cfg.n_super * periods)
    return dataclasses.replace(
        cfg, n_layers=cfg.first_k_dense + periods * len(cfg.pattern),
        encoder=enc)


def _cell_inputs(cfg, shape, mesh, quant: bool, mb: int, k: int, pol):
    """The model and the meta DTensors of one traced step: params, and for
    training the optimizer state and k microbatches of global_batch / mb
    rows, for decode the caches; placed by `pol` (the full config's
    policy: a cut config's own would resolve FSDP from its own size)."""
    model = build_model(cfg, "cpu")
    shapes, roles = abstract_init(model)
    pspecs = policies.param_specs(roles, shapes, cfg, mesh, pol)
    out = {"model": model, "shapes": shapes, "pspecs": pspecs,
           "params": policies.meta_dtensors(shapes, pspecs, mesh)}
    if shape.kind == "train":
        per = shape.global_batch // mb
        sub = ShapeCfg(shape.name, shape.seq, per * k, "train")
        one = ShapeCfg(shape.name, shape.seq, per, "train")
        opt = (quantized_adamw if quant else adamw)(1e-4, weight_decay=0.1)
        ospecs = policies.opt_state_specs(pspecs, shapes, mesh, cfg,
                                          quantized=quant, policy=pol)
        bsds = model.input_specs(sub)
        out.update(
            opt=opt, ospecs=ospecs,
            state=policies.meta_dtensors(opt.init(shapes), ospecs, mesh),
            batch=policies.meta_dtensors(
                bsds, policies.batch_specs(cfg, sub, mesh, bsds, pol), mesh),
            mb_specs=policies.batch_specs(cfg, one, mesh,
                                          model.input_specs(one), pol),
            gspecs=policies.zero_shard_specs(pspecs, shapes, mesh, cfg,
                                             pol))
    else:
        bsds = model.input_specs(shape)
        bspecs = policies.batch_specs(cfg, shape, mesh, bsds, pol)
        out["batch"] = policies.meta_dtensors(
            {k: v for k, v in bsds.items() if k != "position"},
            {k: v for k, v in bspecs.items() if k != "position"}, mesh)
    return out


def _step(cfg, shape, mesh, quant: bool, mb: int, k: int, pol=None):
    """(fn, args) of one traced step at cfg's depth with k microbatches."""
    pol = pol or policies.resolve_policy(cfg, mesh)
    c = _cell_inputs(cfg, shape, mesh, quant, mb, k, pol)
    model = c["model"]
    if shape.kind == "train":
        fn = make_train_step(model, c["opt"], microbatches=k,
                             grad_shardings=c["gspecs"],
                             batch_shardings={n: c["mb_specs"][n]
                                              for n in c["batch"]})
        return fn, (c["params"], c["state"], c["batch"],
                    torch.zeros((), dtype=torch.int32))
    return serve_fn(model, shape), (c["params"], c["batch"])


def serve_fn(model, shape):
    """fn(params, batch) of a serving cell: prefill, `apply` then the last
    token's `logits`; decode, `make_serve_step` (the greedy next token)
    at position S - 1 of caches of S entries, as the reference's cells.
    Traced on meta DTensors here, run on real tensors from `serve_inputs`
    by the card's serving cells."""
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                hidden, _ = model.apply(params, batch)
                return model.logits(params, hidden[:, -1:])
        return prefill_step
    serve = make_serve_step(model)

    def decode_step(params, batch):
        with torch.no_grad():
            return serve(params, batch["token"], batch["caches"],
                         shape.seq - 1)
    return decode_step


def serve_inputs(model, shape, seed: int = 0) -> dict:
    """The real-tensor counterpart of `_cell_inputs`' batch for a serving
    cell, on the model's device, drawn from a `torch.Generator` seeded
    with `seed` in the order of `model.input_specs(shape)`: prefill
    tokens and labels in [1, vocab), an encoder's frames and a VLM's image
    embeddings from randn (bf16); decode a token and caches from
    `model.init_caches(B, S)`, each self-attention K/V entry (a windowed
    layer's ring of `window` entries), Mamba SSM and conv state drawn
    from randn in the tree's order, the cross caches left zeros (the
    reference's serving path never fills them).  The step takes position
    S - 1 itself."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    specs = model.input_specs(shape)

    def draw(meta):
        if meta.dtype.is_floating_point:
            return torch.randn(meta.shape, generator=gen, device=dev,
                               dtype=meta.dtype)
        return torch.randint(1, cfg.vocab, meta.shape, generator=gen,
                             device=dev, dtype=meta.dtype)

    if shape.kind == "prefill":
        return {k: draw(v) for k, v in specs.items()}
    caches = model.init_caches(shape.global_batch, shape.seq)

    def fill(tree):
        if isinstance(tree, list):
            for t in tree:
                fill(t)
            return
        for key, t in tree.items():
            if isinstance(t, (dict, list)):
                fill(t)
            elif key not in ("xk", "xv"):
                t.normal_(generator=gen)
    fill(caches)
    return {"token": draw(specs["token"]), "caches": caches}


def serve_batch(cfg, shape, mesh, budget: float = H100.hbm_bytes):
    """(batch, argument bytes, peak bytes) of a serving cell on one card:
    the largest batch up to the shape's own whose dry-run prediction on
    `mesh` (a (1, 1) mesh: `count_cell`'s argument bytes plus its
    extrapolated peak) fits `budget`.  Counted at batch 1 and 2, then at
    the batch the two put on the budget, and from there one batch at a
    time up or down to the last that fits; a cell that does not fit at
    batch 1 keeps batch 1 and its prediction."""
    def pred(b):
        arg, stats = count_cell(cfg, dataclasses.replace(
            shape, global_batch=b), mesh, False, 1)
        return b, arg, stats.peak_bytes

    def fits(p):
        return p[1] + p[2] <= budget

    full = shape.global_batch
    one = pred(1)
    if full == 1 or not fits(one):
        return one
    per = sum(pred(2)[1:]) - sum(one[1:])
    b = full if per <= 0 else max(1, min(
        full, 1 + int((budget - sum(one[1:])) // per)))
    got = pred(b)
    while fits(got) and b < full:
        up = pred(b + 1)
        if not fits(up):
            break
        b, got = b + 1, up
    while not fits(got):
        b -= 1
        got = pred(b)
    return got


def cell_knobs(arch: str, shape, variant: str = "baseline"):
    """(quantized moments, microbatches) of a cell."""
    mb = 1
    if shape.kind == "train":
        mb = TRAIN_MICROBATCH.get(arch, TRAIN_MICROBATCH["default"])
        if "mb16" in variant:
            mb = 16
        if "mb32" in variant:
            mb = 32
    return arch in QUANTIZED_OPT, mb


def argument_bytes(cfg, shape, mesh, quant: bool, mb: int) -> int:
    """Bytes of this rank's shards of the step's arguments at full depth:
    params, optimizer state and the batch (or decode caches)."""
    full = _cell_inputs(cfg, shape, mesh, quant, mb, mb,
                        policies.resolve_policy(cfg, mesh))
    return sum(policies.local_bytes(full[k])
               for k in ("params", "state", "batch") if k in full)


def count_cell(cfg, shape, mesh, quant: bool, mb: int):
    """(argument bytes per card, the period-scaled `HLOStats` with the
    extrapolated peak in `peak_bytes`) of one cell on `mesh`."""
    pol = policies.resolve_policy(cfg, mesh)
    with sharding_ctx(mesh, pol):
        arg_bytes = argument_bytes(cfg, shape, mesh, quant, mb)

        def count(n):
            fn, args = _step(at_depth(cfg, n), shape, mesh, quant, mb,
                             min(mb, 2), pol)
            return count_step_costs(fn, *args, memory=True)

        return arg_bytes, period_scaled(count, cfg.n_super, mb)


def lower_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               variant: str = "baseline"):
    cfg = get_config(arch)
    if SHAPES[shape_name].kind == "train":
        cfg = dataclasses.replace(cfg, remat=TRAIN_REMAT)
    cfg = apply_variant(cfg, variant, mesh)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}

    t0 = time.time()
    quant, mb = cell_knobs(arch, shape, variant)
    arg_bytes, stats = count_cell(cfg, shape, mesh, quant, mb)
    temp = stats.peak_bytes
    t_lower = time.time() - t0

    chips = policies.count_devices(mesh)
    mf = model_flops(cfg, shape)
    from repro_torch.launch.memory_model import memory_bytes
    mem_bytes = memory_bytes(cfg, shape,
                             mb=mb if shape.kind == "train" else 1,
                             quantized_opt=quant)
    roof = Roofline(flops=stats.flops * chips, bytes_hbm=mem_bytes,
                    bytes_collective=stats.collective_bytes * chips,
                    chips=chips, model_flops=mf)
    per_dev = arg_bytes + temp
    rd = roof.as_dict()
    rd["collective_net_s"] = roof.collective_net_s
    return {
        "status": "ok",
        "chips": chips,
        "multi_pod": multi_pod,
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,
        "memory": {
            "argument_bytes_per_device": int(arg_bytes),
            "output_bytes_per_device": 0,
            "temp_bytes_per_device": int(temp),
            "total_bytes_per_device": int(per_dev),
            "fits_hbm": bool(per_dev < H100.hbm_bytes),
        },
        "counted_flops_per_device": stats.flops,
        "counted_over_model_flops": stats.flops * chips / mf,
        "hlo_parsed_hbm_bytes_per_device": stats.hbm_bytes,
        "collective_ops_bytes_raw": {k: float(v) for k, v in
                                     stats.collective_ops.items()},
        "trip_counts": stats.trip_counts,
        "roofline": rd,
    }


def _key(arch, shape_name, multi_pod, variant):
    key = f"{arch}|{shape_name}|{'multi' if multi_pod else 'single'}"
    return key if variant == "baseline" else key + f"|{variant}"


def _lowered(arch, shape_name, multi_pod, variant="baseline"):
    """lower_cell on the cell's production mesh (a `fake` group of this
    process); an exception becomes an "error" result."""
    fake_world(WORLD)
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        return lower_cell(arch, shape_name, mesh, multi_pod, variant)
    except Exception as e:
        traceback.print_exc()
        return {"status": "error", "error": f"{type(e).__name__}: {e}"}


def run_cell(arch, shape_name, multi_pod, out, variant="baseline",
             res=None):
    """One cell into `out`, printed (`res`: its result, when a worker
    process lowered it)."""
    key = _key(arch, shape_name, multi_pod, variant)
    print(f"=== {key} ===", flush=True)
    if res is None:
        res = _lowered(arch, shape_name, multi_pod, variant)
    out[key] = res
    if res["status"] == "ok":
        r = res["roofline"]
        print(f"  lower={res['lower_s']}s "
              f"mem/dev={res['memory']['total_bytes_per_device']/1e9:.2f}GB "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"coll={r['collective_s']*1e3:.2f}ms "
              f"(net {r['collective_net_s']*1e3:.2f}ms) "
              f"dom={r['dominant']} "
              f"roofline_frac={r['roofline_fraction']:.3f}", flush=True)
    else:
        print(f"  {res['status']}: {res.get('reason', res.get('error'))}",
              flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells lowered in this many processes at once")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        meshes = [args.multi_pod] if not args.both_meshes else [False, True]
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    todo = []
    for arch, shape, mp in cells:
        key = _key(arch, shape, mp, args.variant)
        if out.get(key, {}).get("status") == "ok":
            print(f"=== {key} === (cached)", flush=True)
        else:
            todo.append((arch, shape, mp, args.variant))

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    if args.workers > 1 and todo:
        import concurrent.futures as cf
        import multiprocessing as mp_
        with cf.ProcessPoolExecutor(
                args.workers, mp_context=mp_.get_context("spawn")) as ex:
            for cell, res in zip(todo, ex.map(_lowered, *zip(*todo))):
                run_cell(*cell[:3], out, cell[3], res=res)
                save()
    else:
        for cell in todo:
            run_cell(*cell[:3], out, cell[3])
            save()

    n_ok = sum(1 for v in out.values() if v["status"] == "ok")
    n_skip = sum(1 for v in out.values() if v["status"] == "skipped")
    n_err = sum(1 for v in out.values() if v["status"] == "error")
    print(f"\nDONE: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}")


if __name__ == "__main__":
    main()
