"""The trainer on a process mesh: `launch/train.py`'s `train` on `gloo`
ranks joined through REPRO_DIST_COORD / _NPROCS / _RANK, one `mp.spawn` a
world size (four ranks, then two), against the same run in one process.

The smoke minitron-8b, mamba2-370m and deepseek-moe-16b in float32 (each
package's activation dtype patched, as tests/test_torch_distributed.py
does, whose docstring gives the reason for Adam's lr 1 and eps 1 here),
4 steps at 2 microbatches, a checkpoint every 2 steps and a failure
injected before step 3, on meshes (1, 2), (2, 1) and (2, 2):

  * every step's loss within rtol 1e-5 of one process, the replayed step's
    loss `==` the first run's;
  * the final params and the plain moments within rtol 1e-5 (atol 1e-5 x
    the leaf's largest value);
  * the state read back at the restart `torch.equal`, as whole tensors, to
    the state saved at step 2, and every leaf's local shard of the shape
    its spec implies;
  * `quantized_adamw` on (2, 2) for minitron-8b: losses and params.

Checkpoints: `CheckpointManager.restore(shardings=, mesh=)` puts each
rank's slice of a (2, 2) checkpoint onto (1, 2) and (2, 1); the
reference's `CheckpointManager` restores a (2, 2) run's
onto its own `(params, opt_state)`, every leaf `==` to the run's final
state; a reference `train_loop`'s checkpoint resumes the port on (2, 1) as
in one process.  Elastic: each (2, 2) run's step-2 checkpoint resumes on
(2, 1) and in one process, the restored state `torch.equal` to the one
saved, the next steps' losses within rtol 1e-5 of the uninterrupted run.
The CLI with `--data-parallel 2` trains on two ranks; a mesh of another
size than the group raises the ValueError that names the knobs.
"""
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.train import checkpoint as j_ckpt
from repro.train import data as j_data
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.core.tree import leaf_paths
from repro_torch.models.convert import (opt_state_to_reference,
                                        to_reference_layout)

ARCHS = ("minitron-8b", "mamba2-370m", "deepseek-moe-16b")
MESHES = ((1, 2), (2, 1), (2, 2))
QUANT_ARCH = "minitron-8b"
REF_ARCH = "mamba2-370m"
STEPS, SEQ, BATCH, MB, FAIL_AT, EVERY = 4, 32, 4, 2, 3, 2
LR, EPS = 1.0, 1.0
RTOL = 1e-5
KNOBS = ("REPRO_DIST_COORD", "REPRO_DIST_NPROCS", "REPRO_DIST_RANK")


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _f32(setattr_):
    import repro_torch.models.attention as attention
    import repro_torch.models.layers as layers
    import repro_torch.models.mamba as mamba
    import repro_torch.models.model as model_mod
    for mod in (attention, layers, mamba, model_mod):
        setattr_(mod, "DTYPE", torch.float32)


def _opt(quant):
    from repro_torch.train.optimizer import adamw, quantized_adamw
    return (quantized_adamw if quant else adamw)(
        LR, eps=EPS, weight_decay=0.01, grad_clip=1.0)


def _whole(tree):
    """Every leaf as a whole tensor, a copy (a DTensor gathered: every rank
    joins)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.sharding.context import is_dtensor
    return tree_map(lambda t: (t.full_tensor() if is_dtensor(t) else t)
                    .detach().clone(), tree)


class _Spy:
    """Within the block, the whole state at each checkpoint `train_loop`
    saves (`saved`) and right after each restore (`loaded`)."""

    def __init__(self):
        self.saved, self.loaded = [], []

    def __enter__(self):
        from repro_torch.train import loop
        self.loop = loop
        self.to_disk, self.load_into = loop._to_disk, loop._load_into

        def to_disk(model_cfg, params, opt_state, *rest):
            self.saved.append(dict(leaf_paths(_whole([params, opt_state]))))
            return self.to_disk(model_cfg, params, opt_state, *rest)

        def load_into(params, opt_state, tree):
            self.load_into(params, opt_state, tree)
            self.loaded.append(dict(leaf_paths(_whole([params,
                                                       opt_state]))))
        loop._to_disk, loop._load_into = to_disk, load_into
        return self

    def __exit__(self, *exc):
        self.loop._to_disk, self.loop._load_into = (self.to_disk,
                                                    self.load_into)


def _local_shape_errors(res, quant) -> list:
    """Leaves whose local shard is not the shape its spec implies."""
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.sharding import policies as P
    mesh, cfg = res["mesh"], res["cfg"]
    shapes, roles = abstract_init(build_model(cfg, "cpu"))
    pspecs = P.param_specs(roles, shapes, cfg, mesh)
    ospecs = P.opt_state_specs(pspecs, shapes, mesh, cfg, quantized=quant)
    bad = []

    def check(path, t, s):
        want = P.local_shape(tuple(t.shape), s.spec, mesh)
        if tuple(t.to_local().shape) != want:
            bad.append((path, tuple(t.to_local().shape), want))
    P._walk(check, res["params"], pspecs)
    P._walk(check, res["opt_state"], ospecs)
    return bad


def _run(arch, ckpt, dp=0, mp=1, quant=False, fail_at=(FAIL_AT,)):
    """`train` of the drill; what it returns whole, on every rank."""
    from repro_torch.launch.train import train
    with _Spy() as spy:
        res = train(arch, smoke=True, steps=STEPS, seq=SEQ,
                    global_batch=BATCH, microbatches=MB, data_parallel=dp,
                    model_parallel=mp, ckpt_dir=str(ckpt), device="cpu",
                    quantized_opt=quant, opt=_opt(quant), fail_at=fail_at,
                    checkpoint_every=EVERY, log=lambda msg: None)
    params, opt_state = _whole([res["params"], res["opt_state"]])
    cfg = res["cfg"]
    return {"losses": res["losses"], "restarts": res["restarts"],
            "state": dict(leaf_paths([params, opt_state])),
            "reference_layout": dict(leaf_paths([
                to_reference_layout(cfg, params),
                opt_state_to_reference(cfg, opt_state)])),
            "saved": spy.saved, "loaded": spy.loaded,
            "local_shape_errors": (None if res["mesh"] is None
                                   else _local_shape_errors(res, quant))}


def _restore_onto_mesh(arch, ckpt, shape) -> list:
    """`CheckpointManager.restore(shardings=, mesh=)` of `ckpt`'s step 2
    onto a `shape` mesh, each leaf sharded on its first even dim over
    'data' and its second over 'model': over every rank, the leaves whose
    local shard is not this rank's slice of the whole array, or whose full
    tensor is not the whole array."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import abstract_init, build_model
    from repro_torch.sharding import policies as P
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = get_config(arch, smoke=True)
    shapes, _ = abstract_init(build_model(cfg, "cpu"))
    template = [to_reference_layout(cfg, shapes), opt_state_to_reference(
        cfg, _opt(False).init(shapes))]
    mesh = make_host_mesh(*shape, device_type="cpu")

    def spec(_, t):
        even = [d for d, n in enumerate(t.shape) if n % 2 == 0][:2]
        axes = dict(zip(even, ("data", "model")))
        return P.sharding(tuple(axes.get(d) for d in range(t.ndim)), mesh)
    shardings = P._walk(spec, template)
    mgr = CheckpointManager(str(ckpt))
    placed, info = mgr.restore(template, step=2, shardings=shardings,
                               mesh=mesh)
    whole, _ = mgr.restore(template, step=2, device="cpu")
    bad = [] if info["step"] == 2 else ["step"]

    def check(path, t, w, s):
        if (tuple(t.placements) != s.placements or not torch.equal(
                t.to_local(), P.local_slice(w, mesh, s.placements))
                or not torch.equal(t.full_tensor(), w)):
            bad.append(path)
    P._walk(check, placed, whole, shardings)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, bad)
    return every


def _worker(rank, world, port, jobs, out):
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    os.environ.update(REPRO_DIST_COORD=f"127.0.0.1:{port}",
                      REPRO_DIST_NPROCS=str(world),
                      REPRO_DIST_RANK=str(rank))
    torch.set_num_threads(1)
    _f32(setattr)
    try:
        results = {}
        for name, kind, kw in jobs:
            if kind == "run":
                results[name] = _run(**kw)
            elif kind == "cli":
                results[name] = launch_train.main(kw)
            elif kind == "restore":
                results[name] = _restore_onto_mesh(**kw)
            else:                       # a mesh of another size
                try:
                    launch_train.train(REF_ARCH, smoke=True, device="cpu",
                                       **kw)
                    results[name] = None
                except ValueError as e:
                    results[name] = str(e)
        if rank == 0:
            torch.save(results, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(world, jobs, out):
    mp.spawn(_worker, args=(world, _port(), jobs, str(out)), nprocs=world,
             join=True)
    return torch.load(out, weights_only=False)


def _reference_checkpoint(directory):
    """The reference's `train_loop` for 2 steps of REF_ARCH (float32, the
    same optimizer), its checkpoint at step 2 in `directory`."""
    cfg = jax_get_config(REF_ARCH, smoke=True)
    jm = jax_build_model(cfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    opt = j_opt.adamw(LR, eps=EPS, weight_decay=0.01, grad_clip=1.0)
    step = jax.jit(j_make_train_step(jm, opt, microbatches=MB))
    data = j_data.SyntheticDataset(j_data.DataConfig(
        vocab=cfg.vocab, seq=SEQ, global_batch=BATCH))
    j_loop.train_loop(step, params, opt.init(params), data,
                      j_loop.LoopConfig(total_steps=2, checkpoint_every=2,
                                        checkpoint_dir=str(directory)),
                      log=lambda msg: None)


def _step2_copy(src, dst):
    """`src` with its step-2 checkpoint alone."""
    shutil.copytree(src, dst)
    for d in os.listdir(dst):
        if d != "step_000000002":
            shutil.rmtree(os.path.join(dst, d))
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import repro.models.attention as j_attention
    import repro.models.layers as j_layers
    import repro.models.mamba as j_mamba
    import repro.models.model as j_model
    import repro.models.moe as j_moe
    root = tmp_path_factory.mktemp("train_mesh")
    with pytest.MonkeyPatch.context() as patch:
        for k in KNOBS:
            patch.delenv(k, raising=False)
        _f32(patch.setattr)
        for mod in (j_attention, j_layers, j_mamba, j_model, j_moe):
            patch.setattr(mod, "DTYPE", jnp.float32)
        torch.manual_seed(0)
        one = {arch: _run(arch, root / f"one_{arch}") for arch in ARCHS}
        one["quant"] = _run(QUANT_ARCH, root / "one_quant", quant=True)
        _reference_checkpoint(root / "ref")
        w4 = _spawn(4, [(f"{arch} (2, 2)", "run",
                         dict(arch=arch, ckpt=root / f"w4_{arch}", dp=2,
                              mp=2)) for arch in ARCHS]
                    + [("quant", "run", dict(arch=QUANT_ARCH, quant=True,
                                              ckpt=root / "w4_quant", dp=2,
                                              mp=2))], root / "w4.pt")
        jobs = [(f"{arch} {mesh}", "run",
                 dict(arch=arch, ckpt=root / f"w2_{arch}_{mesh[0]}",
                      dp=mesh[0], mp=mesh[1]))
                for mesh in MESHES[:2] for arch in ARCHS]
        jobs += [(f"elastic {arch}", "run",
                  dict(arch=arch, dp=2, mp=1, fail_at=(),
                       ckpt=_step2_copy(root / f"w4_{arch}",
                                        root / f"el2_{arch}")))
                 for arch in ARCHS]
        jobs += [("from reference", "run",
                  dict(arch=REF_ARCH, dp=2, mp=1, fail_at=(),
                       ckpt=_step2_copy(root / "ref", root / "ref2"))),
                 ("cli", "cli", ["--arch", REF_ARCH, "--smoke", "--steps",
                                 "2", "--device", "cpu", "--data-parallel",
                                 "2", "--ckpt-dir", str(root / "cli")]),
                 ("mesh of 1 in 2", "refused", dict(data_parallel=1))]
        jobs += [(f"restore {mesh}", "restore",
                  dict(arch=QUANT_ARCH, ckpt=root / f"w4_{QUANT_ARCH}",
                       shape=mesh)) for mesh in MESHES[:2]]
        w2 = _spawn(2, jobs, root / "w2.pt")
        for arch in ARCHS:
            one[f"elastic {arch}"] = _run(arch, _step2_copy(
                root / f"w4_{arch}", root / f"el1_{arch}"), fail_at=())
        one["from reference"] = _run(REF_ARCH, _step2_copy(
            root / "ref", root / "ref1"), fail_at=())
        # the reference's template, float32 as the runs
        templates = {}
        for arch in ARCHS:
            jm = jax_build_model(jax_get_config(arch, smoke=True))
            jp, _ = jm.init(jax.random.PRNGKey(0))
            templates[arch] = (jp, j_opt.adamw(LR).init(jp))
    return {"root": root, "one": one, "mesh": {**w4, **w2},
            "templates": templates}


def _close(got, want, what):
    atol = RTOL * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=max(atol, 1e-12), msg=what)


def _case(runs, arch, mesh):
    return runs["mesh"][f"{arch} {mesh}"], runs["one"][arch]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_within_rtol_of_one_process(runs, arch, mesh):
    got, want = _case(runs, arch, mesh)
    assert len(got["losses"]) == len(want["losses"]) == STEPS + 1
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               err_msg=f"{arch} {mesh}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_final_params_and_moments_within_rtol_of_one_process(runs, arch,
                                                             mesh):
    got, want = _case(runs, arch, mesh)
    assert list(got["state"]) == list(want["state"])
    for k, w in want["state"].items():
        _close(got["state"][k], w, f"{arch} {mesh} {k}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_restart_restores_the_saved_state(runs, arch, mesh):
    """The failure before step 3 goes back to step 2's checkpoint: step 2
    runs again to the same loss, and the state read back is the state
    saved, whole and bit for bit."""
    got, _ = _case(runs, arch, mesh)
    L = got["losses"]
    assert got["restarts"] == 1 and L[2] == L[3]
    saved, loaded = got["saved"][0], got["loaded"]
    assert len(loaded) == 1 and list(loaded[0]) == list(saved)
    for k, t in saved.items():
        assert torch.equal(loaded[0][k], t), k


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_have_their_specs_shapes(runs, arch, mesh):
    got, _ = _case(runs, arch, mesh)
    assert got["local_shape_errors"] == []


def test_quantized_adamw_on_a_2x2_mesh(runs):
    got, want = runs["mesh"]["quant"], runs["one"]["quant"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["local_shape_errors"] == []
    assert any(k.endswith("/mq") for k in want["state"])
    for k, w in want["state"].items():
        if k.startswith("0/"):
            _close(got["state"][k], w, f"int8 moments: param {k}")
    for k, t in got["saved"][0].items():
        assert torch.equal(got["loaded"][0][k], t), k


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_restores_a_2x2_checkpoint(runs, arch):
    """The reference's `CheckpointManager` reads the (2, 2) run's last
    checkpoint (one `shard_0.npz`, written by rank 0) onto its own
    `(params, opt_state)`: the same leaf keys, every value `==` to the
    run's final state."""
    mgr = j_ckpt.CheckpointManager(str(runs["root"] / f"w4_{arch}"))
    assert sorted(os.listdir(os.path.join(mgr.dir, "step_000000004"))) == [
        "meta.json", "shard_0.npz"]
    tree, extras = mgr.restore(runs["templates"][arch])
    assert extras["step"] == STEPS and extras["data_step"] == STEPS
    want = runs["mesh"][f"{arch} (2, 2)"]["reference_layout"]
    got = dict(j_ckpt._leaf_paths(tree))
    assert list(got) == list(want)
    for k, t in want.items():
        assert np.array_equal(np.asarray(got[k], np.float32),
                              t.float().numpy()), k


def test_reference_checkpoint_resumes_on_2x1(runs):
    got, want = runs["mesh"]["from reference"], runs["one"]["from reference"]
    assert len(got["losses"]) == len(want["losses"]) == STEPS - 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    for k, t in want["loaded"][0].items():
        assert torch.equal(got["loaded"][0][k], t), k


@pytest.mark.parametrize("mesh", MESHES[:2], ids=lambda m: f"{m[0]}x{m[1]}")
def test_restore_places_each_ranks_slice(runs, mesh):
    """The (2, 2) run's step-2 checkpoint restored onto (1, 2) and (2, 1)
    with `shardings=`: on every rank each leaf a DTensor of its
    placements, its local shard this rank's slice of the whole array."""
    assert runs["mesh"][f"restore {mesh}"] == [[], []]


@pytest.mark.parametrize("where", ["2x1", "one process"])
@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_resume_of_a_2x2_checkpoint(runs, arch, where):
    """(2, 2)'s step-2 checkpoint on another mesh: the state restored is
    the state the (2, 2) run saved at step 2, and steps 2 and 3 give the
    uninterrupted run's losses."""
    got = (runs["mesh"] if where == "2x1" else runs["one"])[
        f"elastic {arch}"]
    saved = runs["mesh"][f"{arch} (2, 2)"]["saved"][0]
    assert list(got["loaded"][0]) == list(saved)
    for k, t in saved.items():
        assert torch.equal(got["loaded"][0][k], t), k
    L = runs["one"][arch]["losses"]
    np.testing.assert_allclose(got["losses"], [L[3], L[4]], rtol=RTOL)


def test_cli_trains_on_two_ranks_and_refuses_another_mesh_size(runs):
    assert runs["mesh"]["cli"] == 0
    assert os.listdir(runs["root"] / "cli") == ["step_000000002"]
    msg = runs["mesh"]["mesh of 1 in 2"]
    assert msg is not None and "REPRO_DIST_COORD" in msg, msg


@pytest.mark.parametrize("flag", ["--data-parallel", "--model-parallel"])
def test_lone_process_refuses_a_mesh(flag, tmp_path, monkeypatch):
    from repro_torch.launch import train as launch_train
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="REPRO_DIST_COORD, "
                       "REPRO_DIST_NPROCS and REPRO_DIST_RANK"):
        launch_train.main(["--arch", REF_ARCH, "--smoke", "--steps", "1",
                           "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "x"), flag, "2"])
