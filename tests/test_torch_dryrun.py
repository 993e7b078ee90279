"""The port's dry run (`repro_torch.launch.dryrun`) and step-cost counter
(`launch.roofline.count_step_costs`) on `fake` process groups in this
process, against the reference's shardings where they meet:

  * per-card argument bytes of a training cell `==` the sum of the
    reference's `NamedSharding.shard_shape` bytes over the same params,
    optimizer state and batch (minitron-8b and jamba at full size on
    (16, 16), the smoke configs too);
  * the period-scaled FLOP and collective counts `==` the unscaled ones at
    smoke depth (4 super-blocks, 4 microbatches);
  * the flash and SSD FLOPs come from their formulas, the same on the
    plain path (CPU tensors) as on `meta`;
  * collective bytes 0 on a (1, 1) mesh and > 0 where 'model' > 1;
  * the FLOPs per card are each rank's own work: split work its share,
    repeated work in full;
  * `lower_cell`'s "skipped" reasons `==` `shape_applicable`'s.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.model import abstract_init as j_abstract_init
from repro.sharding import policies as jpol
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh, \
    make_production_mesh
from repro_torch.launch.roofline import count_step_costs, period_scaled
from repro_torch.sharding.context import sharding_ctx
from repro_torch.sharding import policies


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(data, model):
    fake_world(data * model)
    return make_host_mesh(data, model, device_type="cpu")


def _ref_argument_bytes(arch, smoke, shape_name):
    """The reference's shard bytes of a training step's arguments on
    (16, 16), its own knobs (int8 moments for the QUANTIZED_OPT archs)."""
    jcfg = j_get_config(arch, smoke=smoke)
    jm = j_build_model(jcfg)
    shapes, roles = j_abstract_init(jm)
    mesh = JAbstractMesh((16, 16), ("data", "model"))
    shape = J_SHAPES[shape_name]
    quant = arch in dryrun.QUANTIZED_OPT
    opt = (jopt.quantized_adamw if quant else jopt.adamw)(
        1e-4, weight_decay=0.1)
    pspecs = jpol.param_specs(roles, shapes, jcfg, mesh)
    ospecs = jpol.opt_state_specs(pspecs, shapes, mesh, jcfg,
                                  quantized=quant)
    bsds = jm.input_specs(shape)
    bspecs = jpol.batch_specs(jcfg, shape, mesh, bsds)
    total = 0
    for tree, specs in ((shapes, pspecs),
                        (jax.eval_shape(opt.init, shapes), ospecs),
                        (bsds, bspecs)):
        for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(specs)):
            total += math.prod(sh.shard_shape(leaf.shape)) * \
                np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,smoke", [("minitron-8b", False),
                                        ("jamba-1.5-large-398b", False),
                                        ("minitron-8b", True),
                                        ("mamba2-370m", True),
                                        ("deepseek-moe-16b", True),
                                        ("whisper-large-v3", True)])
def test_argument_bytes_match_reference_shardings(arch, smoke):
    fake_world(dryrun.WORLD)
    mesh = make_production_mesh()
    shape = SHAPES["train_4k"]
    cfg = dataclasses.replace(get_config(arch, smoke=smoke),
                              remat=dryrun.TRAIN_REMAT)
    quant, mb = dryrun.cell_knobs(arch, shape)
    got = dryrun.argument_bytes(cfg, shape, mesh, quant, mb)
    assert got == _ref_argument_bytes(arch, smoke, "train_4k")


def _smoke_step(arch, mesh, n_super, k, shape):
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(
        cfg, remat="full",
        n_layers=cfg.first_k_dense + n_super * len(cfg.pattern))
    quant = arch == "deepseek-moe-16b"
    fn, args = dryrun._step(cfg, shape, mesh, quant, 4, k)
    return cfg, fn, args


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m",
                                  "deepseek-moe-16b"])
def test_period_scaled_counts_equal_unscaled(arch):
    mesh = _mesh(2, 2)
    shape = ShapeCfg("t", 128, 8, "train")
    with sharding_ctx(mesh, policies.resolve_policy(
            get_config(arch, smoke=True), mesh)):
        _, fn, args = _smoke_step(arch, mesh, 4, 4, shape)
        whole = count_step_costs(fn, *args)

        def count(n):
            _, f, a = _smoke_step(arch, mesh, n, 2, shape)
            return count_step_costs(f, *a)
        scaled = period_scaled(count, 4, 4)
    assert whole.flops > 0 and whole.collective_bytes > 0
    assert scaled.flops == whole.flops
    assert scaled.collective_ops == whole.collective_ops
    assert scaled.collective_bytes == whole.collective_bytes


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_kernel_flops_from_their_formulas(arch):
    """One smoke training step on plain CPU tensors and on meta tensors:
    the same FLOPs, the flash (SSD) ops' share that of their formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full")
    B, S = 2, 128
    per_op = {}
    for dev in ("cpu", "meta"):
        m = build_model(cfg, "cpu")
        if dev == "cpu":
            params, _ = m.init(0)
        else:
            params, _ = abstract_init(m)
        opt = adamw(1e-4)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.long, device=dev),
                 "labels": torch.zeros((B, S), dtype=torch.long, device=dev)}
        step = make_train_step(m, opt)
        with FlopCounterMode(display=False) as fc, costs.counting():
            step(params, opt.init(params), batch, torch.zeros(
                (), dtype=torch.int32, device=dev))
        per_op[dev] = {str(k): v for k, v in
                       fc.get_flop_counts()["Global"].items()}
    assert per_op["cpu"] == per_op["meta"]
    layers = cfg.n_layers
    if arch == "minitron-8b":
        H, hd = cfg.attn.n_heads, cfg.attn.head_dim
        fwd = costs.flash_flops(B, S, S, H, hd, True, 0)
        # remat "full": the forward and its re-forward, one backward
        assert per_op["cpu"]["repro_torch.flash_attention"] == \
            2 * layers * fwd
        assert per_op["cpu"]["repro_torch.flash_attention_bwd"] == \
            layers * int(costs.FLASH_BWD_FACTOR * fwd)
    else:
        from repro_torch.models.mamba import dims
        d_inner, H = dims(cfg.d_model, cfg.ssm)
        args = (B, S, H, cfg.ssm.head_dim, cfg.ssm.d_state,
                min(cfg.ssm.chunk, S))
        assert per_op["cpu"]["repro_torch.ssd_scan"] == \
            2 * layers * costs.ssd_flops(*args)
        assert per_op["cpu"]["repro_torch.ssd_scan_bwd"] == \
            layers * costs.ssd_bwd_flops(*args)


def test_collective_bytes_zero_on_one_card():
    shape = ShapeCfg("t", 128, 4, "train")
    out = {}
    for model in (1, 2):
        mesh = _mesh(1, model)
        with sharding_ctx(mesh, policies.resolve_policy(
                get_config("minitron-8b", smoke=True), mesh)):
            _, fn, args = _smoke_step("minitron-8b", mesh, 2, 2, shape)
            out[model] = count_step_costs(fn, *args)
    assert out[1].collective_bytes == 0
    assert out[2].collective_bytes > 0
    assert out[1].flops == out[2].flops * 2     # per card, over 1 and 2


@pytest.mark.parametrize("arch,data,ratio", [
    ("minitron-8b", 2, 2.0),        # the 2-row microbatches split
    ("minitron-8b", 4, 1.0),        # 2 rows over 4 ranks: all repeat
    ("deepseek-moe-16b", 2, 2.0)])  # the router's rows, the expert slots
def test_counts_each_ranks_own_work(arch, data, ratio):
    """Per-card FLOPs on (data, 1) against (1, 1): work that the data
    ranks split counts its share, work that they repeat counts in full
    on each (the reference's per-device program).  The MoE's router
    product is split over the mesh by rows and its expert products over
    data by capacity slot, though its routing runs on every token."""
    shape = ShapeCfg("t", 128, 8, "train")
    out = {}
    for d in (1, data):
        mesh = _mesh(d, 1)
        with sharding_ctx(mesh, policies.resolve_policy(
                get_config(arch, smoke=True), mesh)):
            _, fn, args = _smoke_step(arch, mesh, 2, 2, shape)
            out[d] = count_step_costs(fn, *args).flops
    assert out[1] == ratio * out[data]


def test_skipped_reasons_match_shape_applicable():
    fake_world(dryrun.WORLD)
    mesh = make_production_mesh()
    n = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            ok, why = shape_applicable(get_config(arch), shape)
            if ok:
                continue
            res = dryrun.lower_cell(arch, name, mesh, False)
            assert res == {"status": "skipped", "reason": why}
            n += 1
    assert n > 0


def _serve_count(cfg, shape, mesh, pol):
    def count(n):
        fn, args = dryrun._step(dryrun.at_depth(cfg, n), shape, mesh, False,
                                1, 1, pol)
        return count_step_costs(fn, *args, memory=True)
    return count


@pytest.mark.parametrize("arch,kind", [("minitron-8b", "prefill"),
                                       ("jamba-1.5-large-398b", "prefill"),
                                       ("mamba2-370m", "decode"),
                                       ("gemma3-12b", "decode")])
def test_serving_peak_from_periods_equals_unscaled(arch, kind):
    """A serving step keeps nothing from one period for the next: the peak
    `period_scaled` reads at 2 and 3 periods `==` the peak traced at 5
    (from 1 and 2 periods it scaled the first period's smaller peak by
    the depth)."""
    mesh = _mesh(1, 1)
    cfg = get_config(arch, smoke=True)
    shape = ShapeCfg(kind, 256, 2, kind)
    pol = policies.resolve_policy(cfg, mesh)
    with sharding_ctx(mesh, pol):
        count = _serve_count(cfg, shape, mesh, pol)
        whole = count(5).peak_bytes
        assert whole > 0
        assert period_scaled(count, 5, 1).peak_bytes == whole


def test_serve_batch_is_the_largest_that_fits():
    """`serve_batch` on a (1, 1) mesh: the budget of batch 5's prediction
    gives batch 5; a byte less, 4; the published batch where it fits."""
    mesh = _mesh(1, 1)
    cfg = get_config("minitron-8b", smoke=True)
    shape = ShapeCfg("decode_cell", 4096, 16, "decode")

    def need(b):
        arg, stats = dryrun.count_cell(
            cfg, dataclasses.replace(shape, global_batch=b), mesh, False, 1)
        return arg + stats.peak_bytes
    assert dryrun.serve_batch(cfg, shape, mesh, need(5))[0] == 5
    assert dryrun.serve_batch(cfg, shape, mesh, need(5) - 1)[0] == 4
    b, arg, peak = dryrun.serve_batch(cfg, shape, mesh, 1e12)
    assert b == 16 and arg + peak == need(16)
