"""The port's sharded steps on CPU meshes of `gloo` processes against the
same steps in one process: the smoke minitron-8b, mamba2-370m and
deepseek-moe-16b in float32 (each package's activation dtype patched, as
the other float32 tests do), placed by `sharding.policies`.

  * one training step, 2 microbatches, ZeRO moments (the accumulator held
    to `zero_shard_specs`), `adamw` and `quantized_adamw`: the loss and
    every updated parameter within rtol 1e-5 (atol 1e-5 x the leaf's
    largest value), the plain moments too (v, the squared gradient, at
    twice the bar);
  * prefill logits and 8 greedy decode steps on caches placed by
    `cache_specs`: the tokens `==`, the logits within the same bar;
  * every leaf's local shard has the shape its spec implies (params,
    optimizer state, caches);
  * remat "full" / "block" / "collectives": loss and gradients `==` to
    "none" (one process).

One spawn per world size: (1, 2) and (2, 1) in two processes, (2, 2) in
four.  Adam's eps and lr are 1 here: at the first step the update is
lr g / (|g| + eps), close to linear in g, so a parameter moves by the
gradient and a gradient that differs from the one-process one by
rounding moves it by as little.  With eps 1e-8 the update is sign(g) x
lr, and a gradient of -1e-12 against +1e-12 moves it by 2 lr; with eps
near |g| it squashes a leaf's large updates, and an element's rounding
error, small against its leaf's largest gradient, is large against the
leaf's largest update.
"""
import dataclasses
import socket

import pytest
import torch
import torch.multiprocessing as mp

ARCHS = ("minitron-8b", "mamba2-370m", "deepseek-moe-16b")
B, S, MB, DECODE = 4, 64, 2, 8
LR, EPS = 1.0, 1.0
RTOL = 1e-5


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _f32():
    import repro_torch.models.layers as layers
    import repro_torch.models.model as model_mod
    layers.DTYPE = torch.float32
    model_mod.DTYPE = torch.float32


def _close(got, want, what, rtol=RTOL):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    atol = rtol * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=max(atol, 1e-12), msg=what)


def _check_local_shapes(tree, shardings, mesh, what):
    from repro_torch.sharding import policies as P
    P._walk(lambda path, t, s: _eq(tuple(t.to_local().shape),
                                   P.local_shape(tuple(t.shape), s.spec,
                                                 mesh), (what, path)),
            tree, shardings)


def _eq(a, b, what):
    if a != b:
        raise AssertionError(f"{what}: {a} != {b}")


def _model(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    m = build_model(get_config(arch, smoke=True), "cpu")
    params, roles = m.init(0)
    params = _tree(params, lambda t: t.float())
    return m, params, roles


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _clone(tree):
    return _tree(tree, lambda t: t.clone())


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -3:] = -100
    return {"tokens": tokens, "labels": labels}


def _train(arch, mesh, quant):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.sharding import policies as P
    from repro_torch.train.optimizer import adamw, quantized_adamw
    from repro_torch.train.train_step import make_train_step
    m, params, roles = _model(arch)
    cfg = m.cfg
    shapes = _tree(params, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                 device="meta"))
    opt = (quantized_adamw if quant else adamw)(LR, eps=EPS,
                                                 weight_decay=0.1)
    batch = _batch(cfg, 3)
    step = torch.tensor(0, dtype=torch.int32)
    # one process
    p1, s1 = _clone(params), opt.init(_clone(params))
    p1, s1, met1 = make_train_step(m, opt, microbatches=MB)(p1, s1, batch,
                                                            step)
    # the mesh
    pspecs = P.param_specs(roles, shapes, cfg, mesh)
    gspecs = P.zero_shard_specs(pspecs, shapes, mesh, cfg)
    ospecs = P.opt_state_specs(pspecs, shapes, mesh, cfg, quantized=quant)
    shape = ShapeCfg("t", S, B, "train")
    bspecs = P.batch_specs(cfg, shape, mesh, m.input_specs(shape))
    dp = P.distribute(_clone(params), pspecs, mesh)
    ds = P.distribute(opt.init(_clone(params)), ospecs, mesh)
    db = P.distribute(batch, {k: bspecs[k] for k in batch}, mesh)
    mb_specs = P.batch_specs(cfg, ShapeCfg("mb", S, B // MB, "train"), mesh,
                             m.input_specs(ShapeCfg("mb", S, B // MB,
                                                    "train")))
    step_fn = make_train_step(m, opt, microbatches=MB, grad_shardings=gspecs,
                              batch_shardings={k: mb_specs[k]
                                               for k in batch})
    dp, ds, met = step_fn(dp, ds, db, step)
    what = f"{arch} {tuple(mesh.shape)} {'int8' if quant else 'f32'}"
    _close(met["loss"], met1["loss"], f"{what} loss")
    P._walk(lambda path, g, w: _close(g, w, f"{what} param {path}"), dp, p1)
    if not quant:
        # m is linear in the gradient, v = (1 - b2) g^2 doubles its
        # relative rounding
        P._walk(lambda path, g, w: _close(g, w, f"{what} moment {path}"),
                ds["m"], s1["m"])
        P._walk(lambda path, g, w: _close(g, w, f"{what} moment {path}",
                                          2 * RTOL), ds["v"], s1["v"])
    _check_local_shapes(dp, pspecs, mesh, f"{what} params")
    _check_local_shapes(ds, ospecs, mesh, f"{what} opt state")


def _serve(arch, mesh):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.sharding import policies as P
    m, params, roles = _model(arch)
    cfg = m.cfg
    shapes = _tree(params, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                 device="meta"))
    pspecs = P.param_specs(roles, shapes, cfg, mesh)
    dparams = P.distribute(params, pspecs, mesh)
    what = f"{arch} {tuple(mesh.shape)}"
    # prefill
    shape = ShapeCfg("p", S, B, "prefill")
    bspecs = P.batch_specs(cfg, shape, mesh, m.input_specs(shape))
    tokens = _batch(cfg, 5)["tokens"]
    with torch.no_grad():
        h1, _ = m.apply(params, {"tokens": tokens})
        want = m.logits(params, h1)
        dt = P.distribute({"tokens": tokens}, {"tokens": bspecs["tokens"]},
                          mesh)
        h, _ = m.apply(dparams, dt)
        _close(m.logits(dparams, h), want, f"{what} prefill logits")
    # decode
    dshape = ShapeCfg("d", S, B, "decode")
    caches = m.init_caches(B, S)
    cspecs = P.batch_specs(cfg, dshape, mesh, m.input_specs(dshape))
    dcaches = P.distribute(_clone(caches), cspecs["caches"], mesh)
    _check_local_shapes(dcaches, cspecs["caches"], mesh, f"{what} caches")
    tok = tokens[:, :1].clone()
    dtok = P.distribute({"t": tok}, {"t": cspecs["token"]}, mesh)["t"]
    with torch.no_grad():
        for pos in range(DECODE):
            want, caches = m.decode_step(params, tok, caches, pos)
            got, dcaches = m.decode_step(dparams, dtok, dcaches, pos)
            _close(got, want, f"{what} decode {pos} logits")
            tok = torch.argmax(want[:, -1].float(), dim=-1)[:, None]
            dnext = torch.argmax(got.full_tensor()[:, -1].float(),
                                 dim=-1)[:, None]
            _eq(dnext.tolist(), tok.tolist(), f"{what} decode {pos} tokens")
            dtok = P.distribute({"t": tok.clone()}, {"t": cspecs["token"]},
                                mesh)["t"]
    _check_local_shapes(dcaches, cspecs["caches"], mesh, f"{what} caches")
    P._walk(lambda path, g, w: _close(g, w, f"{what} cache {path}"),
            dcaches, caches)


def _worker(rank, world, port, meshes):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _f32()
        for shape in meshes:
            mesh = make_host_mesh(*shape, device_type="cpu")
            for arch in ARCHS:
                for quant in (False, True):
                    _train(arch, mesh, quant)
                _serve(arch, mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("meshes", [((1, 2), (2, 1)), ((2, 2),)],
                         ids=["world2", "world4"])
def test_sharded_steps_match_one_process(meshes):
    world = meshes[0][0] * meshes[0][1]
    mp.spawn(_worker, args=(world, _port(), meshes), nprocs=world,
             join=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_equal_none(arch, monkeypatch):
    """Loss and every gradient `==` to remat "none" (one process, f32);
    with remat each super-block's attention (SSD) runs again in the
    backward (the leading dense blocks, outside the super-blocks, as in
    the reference, once)."""
    import repro_torch.models.layers as layers
    import repro_torch.models.mamba as mamba
    import repro_torch.models.model as model_mod
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models import attention
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_loss_fn
    calls = [0]

    def counted(fn):
        def wrapped(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(attention, "flash", counted(attention.flash))
    monkeypatch.setattr(mamba, "_ssd", counted(mamba._ssd))
    monkeypatch.setattr(layers, "DTYPE", torch.float32)
    monkeypatch.setattr(model_mod, "DTYPE", torch.float32)
    m0, params, _ = _model(arch)
    batch = _batch(m0.cfg, 7)
    out = {}
    for mode in ("none", "full", "block", "collectives"):
        m = build_model(dataclasses.replace(m0.cfg, remat=mode), "cpu")
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        calls[0] = 0
        loss, _ = make_loss_fn(m)(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[mode] = (loss.detach(), grads, calls[0])
    assert out["none"][2] > 0
    for mode in ("full", "block", "collectives"):
        assert out[mode][2] == 2 * out["none"][2] - m0.cfg.first_k_dense, \
            mode
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for g, w in zip(out[mode][1], out["none"][1]):
            assert (g is None) == (w is None), mode
            if g is not None:
                assert torch.equal(g, w), mode


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_keeps_products(arch):
    """Remat "block" takes the products with no batch dims back in the
    re-forward: its step computes the same `mm` FLOPs as "none", and
    "full", which computes them again, more."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_loss_fn
    m0, params, _ = _model(arch)
    batch = _batch(m0.cfg, 7)
    mm = {}
    for mode in ("none", "full", "block"):
        m = build_model(dataclasses.replace(m0.cfg, remat=mode), "cpu")
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with FlopCounterMode(display=False) as fc:
            loss, _ = make_loss_fn(m)(tree_unflatten(params, leaves), batch)
            torch.autograd.grad(loss, leaves, allow_unused=True)
        mm[mode] = fc.get_flop_counts()["Global"][torch.ops.aten.mm]
    assert mm["block"] == mm["none"] < mm["full"]
