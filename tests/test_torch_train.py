"""The port's LM training path (`repro_torch.train`, `models.model`
`model_flops` / `abstract_init`, `launch/train.py`) on the CPU against the
live JAX reference.

Inputs come from numpy seeds; model weights from the reference's
`Model.init`, carried across bit-equal (`models.convert`).  Bars:
  * data, elastic, compression (int8), `model_flops`, `abstract_init`
    shapes and `sample_token`: `==`; top-k sparsification within 1e-6.
  * optimizers and schedules over 5 steps in float32: within 1e-6 relative
    (and 1e-6 x max |reference| absolute); the int8 moment codes of
    `quantized_adamw` `==`.
  * losses and gradients of the bf16 smoke models: the zoo's bf16 bar
    (rtol 2e-2, atol 2e-2 x max |reference|, `repro_torch.testing`): XLA
    and torch round bf16 at different places (tests/test_torch_models.py).
    deepseek-moe's MoE layers run on the reference's own expert choice
    (`RouteReplay`), since bf16 flips router near-ties.
  * the training loop: losses `==` across a restart and against an
    uninterrupted run (the same program twice on the same device); its
    checkpoints restore in the reference's `CheckpointManager` onto the
    reference's (params, opt_state), every leaf `==`, and back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.models import moe as jax_moe
from repro.models.model import abstract_init as j_abstract_init
from repro.models.model import build_model as jax_build_model
from repro.models.model import model_flops as j_model_flops
from repro.train import checkpoint as j_ckpt
from repro.train import compression as j_comp
from repro.train import data as j_data
from repro.train import elastic as j_elastic
from repro.train import optimizer as j_opt
from repro.train.serve_step import sample_token as j_sample_token
from repro.train.train_step import chunked_ce_loss as j_chunked_ce_loss
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import prng
from repro_torch.core.tree import (leaf_paths, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (opt_state_from_numpy,
                                        opt_state_to_reference,
                                        params_from_numpy,
                                        to_reference_layout)
from repro_torch.models.model import abstract_init, build_model, model_flops
from repro_torch.testing import BF16_RTOL, RouteReplay
from repro_torch.train import compression, data, elastic, optimizer
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.serve_step import sample_token
from repro_torch.train.train_step import (chunked_ce_loss, make_loss_fn,
                                          make_train_step)

CPU = torch.device("cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_bar(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = BF16_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol,
                               err_msg=what)


def _f32_close(got, want, what, rtol=1e-6):
    got, want = _np(got), _np(want)
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _host(x) -> np.ndarray:
    """A tensor's exact values as numpy (bf16 as float32, exactly)."""
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


def _ref_paths(tree) -> dict:
    return dict(j_ckpt._leaf_paths(tree))


# ---------------------------------------------------------------------------
# data, elastic, compression, sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 1000])
def test_global_batch_and_shards_equal(step):
    kw = dict(vocab=512, seq=64, global_batch=4, seed=2)
    jc, tc = j_data.DataConfig(**kw), data.DataConfig(**kw)
    assert np.array_equal(data.global_batch_np(tc, step),
                          j_data.global_batch_np(jc, step))
    for host in (0, 1):
        assert np.array_equal(data.host_shard(tc, step, host, 2),
                              j_data.host_shard(jc, step, host, 2))


def test_dataset_yields_the_reference_batches_and_resumes():
    kw = dict(vocab=300, seq=32, global_batch=4, seed=1)
    jd = j_data.SyntheticDataset(j_data.DataConfig(**kw), start_step=5,
                                 host_id=1, n_hosts=2)
    td = data.SyntheticDataset(data.DataConfig(**kw), start_step=5,
                               host_id=1, n_hosts=2, device="cpu")
    for _ in range(2):
        jb, tb = next(jd), next(td)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int64 and tb[k].device == CPU
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert td.state() == jd.state() == {"step": 7}
    td.restore({"step": 5})
    jd.restore({"step": 5})
    assert np.array_equal(next(td)["tokens"].numpy(),
                          np.asarray(next(jd)["tokens"]))


def test_mesh_factoring_equal():
    for n in range(1, 41):
        for mp in (1, 2, 4, 8):
            for pods in (1, 2, 3):
                assert (elastic.factor_mesh(n, mp, pods)
                        == j_elastic.factor_mesh(n, mp, pods))
            for bd in (8, 12, 30, 256):
                assert (elastic.largest_viable_mesh(n, mp, bd)
                        == j_elastic.largest_viable_mesh(n, mp, bd))


def test_watchdog_and_failures_equal():
    times = [1.0, 1.1, 0.9, 3.5, 1.0, 2.05, 4.0, 1.2] * 6
    jw, tw = j_elastic.StragglerWatchdog(window=5), \
        elastic.StragglerWatchdog(window=5)
    for t in times:
        assert tw.observe(t) == jw.observe(t)
        assert tw.median == jw.median
    assert tw.flagged == jw.flagged > 0
    fail = elastic.SimulatedFailures((2, 5))
    fail.check(1)
    for s in (2, 5):
        with pytest.raises(RuntimeError, match=f"step {s}"):
            fail.check(s)
        fail.check(s)                   # once each


@pytest.mark.parametrize("shape,dtype", [((100,), "f32"), ((3, 700), "f32"),
                                         ((64, 256), "bf16"),
                                         ((1000,), "bf16")])
def test_compress_decompress_equal(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    g = (rng.standard_normal(shape) * rng.uniform(0.01, 10, shape)
         ).astype(np.float32)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    if dtype == "bf16":
        jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
    got = compression.compress_decompress(tg)
    want = j_comp.compress_decompress(jg)
    assert got.dtype == tg.dtype
    assert np.array_equal(_host(got), _host(want))


def test_topk_error_feedback_within_1e6():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((33, 70)).astype(np.float32)
    r = (rng.standard_normal((33, 70)) * 0.1).astype(np.float32)
    for frac in (0.01, 0.2):
        sent, res = compression.topk_with_error_feedback(
            torch.from_numpy(g), torch.from_numpy(r), frac)
        jsent, jres = j_comp.topk_with_error_feedback(jnp.asarray(g),
                                                      jnp.asarray(r), frac)
        _f32_close(sent, jsent, "sent")
        _f32_close(res, jres, "residual")


def test_sample_token_equal():
    rng = np.random.default_rng(0)
    for seed in range(12):
        lg = (rng.standard_normal((3, 97)) * 3).astype(np.float32)
        for temp, top_k in ((1.0, 0), (0.7, 5), (1.3, 1), (0.2, 40)):
            want = j_sample_token(jnp.asarray(lg), jax.random.PRNGKey(seed),
                                  temp, top_k)
            got = sample_token(torch.from_numpy(lg),
                               prng.PRNGKey(seed, "cpu"), temp, top_k)
            assert np.array_equal(got.numpy(), np.asarray(want)), (seed,
                                                                   temp)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _build(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _build(v, rng) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_build(v, rng) for v in shapes]
    return rng.standard_normal(shapes).astype(np.float32)


OPTS = {"sgd": lambda m: m.sgd(0.05),
        "adamw": lambda m: m.adamw(1e-2),
        "adamw_clip_wd_cosine": lambda m: m.adamw(
            m.cosine_schedule(1e-2, 2, 5), weight_decay=0.01, grad_clip=1.0),
        "quantized_adamw": lambda m: m.quantized_adamw(1e-2),
        "quantized_adamw_clip_wd": lambda m: m.quantized_adamw(
            1e-2, weight_decay=0.01, grad_clip=1.0)}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_five_steps_within_1e6(name):
    rng = np.random.default_rng(9)
    params = _build_tree(rng)
    jopt, topt = OPTS[name](j_opt), OPTS[name](optimizer)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, _copy(params))
    js, ts = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for step in range(5):
        grads = _build_tree(rng, scale=3.0)
        jp, js = update(jax.tree.map(jnp.asarray, grads), js, jp,
                        jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(tree_map(torch.from_numpy, grads), ts,
                             tp, torch.tensor(step, dtype=torch.int32))
        for (k, w), g in zip(_ref_paths(jp).items(), tree_leaves(tp)):
            _f32_close(g, w, f"{name} step {step} {k}")
        ref_state = _ref_paths(js)
        for k, g in leaf_paths(ts):
            w = ref_state[k]
            if w.dtype == jnp.int8:
                assert np.array_equal(g.numpy(), np.asarray(w)), (name, k)
            else:
                _f32_close(g, w, f"{name} step {step} state {k}")


def _build_tree(rng, scale=1.0):
    shapes = {"w": (4, 512), "b": {"c": (256,), "d": [(5,), (3, 256)]},
              "e": (7, 3)}
    tree = _build(shapes, rng)
    return tree_map(lambda a: (a * scale).astype(np.float32), tree)


def _copy(tree):
    return tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.mark.parametrize("name", ["adamw_clip_wd_cosine",
                                  "quantized_adamw_clip_wd"])
def test_optimizer_in_pieces_equals_whole(name, monkeypatch):
    """The in-place update by pieces (rows of a quantized leaf, flat pieces
    of a plain one) gives the same bits as one piece per leaf."""
    rng = np.random.default_rng(3)
    params, grads = _build_tree(rng), _build_tree(rng, scale=3.0)
    runs = []
    for piece in (optimizer.UPDATE_PIECE, 512):
        monkeypatch.setattr(optimizer, "UPDATE_PIECE", piece)
        opt = OPTS[name](optimizer)
        p = tree_map(torch.from_numpy, _copy(params))
        st = opt.init(p)
        for step in range(2):
            p, st = opt.update(tree_map(torch.from_numpy, grads), st, p,
                               torch.tensor(step, dtype=torch.int32))
        runs.append(leaf_paths([p, st]))
    for (k, a), (_, b) in zip(*runs):
        assert torch.equal(a, b), k


def test_cosine_and_constant_schedules_within_1e6():
    steps = torch.arange(40, dtype=torch.int32)
    for lr, warm, total, mf in ((1e-3, 5, 30, 0.1), (3e-4, 0, 10, 0.0),
                                (1.0, 10, 10, 0.5)):
        got = optimizer.cosine_schedule(lr, warm, total, mf)(steps)
        want = j_opt.cosine_schedule(lr, warm, total, mf)(jnp.arange(40))
        _f32_close(got, want, f"cosine {lr} {warm} {total}")
    got = optimizer.constant_schedule(2e-3)(torch.tensor(3))
    assert float(got) == float(j_opt.constant_schedule(2e-3)(jnp.asarray(3)))


def test_global_norm_within_1e6():
    tree = _build_tree(np.random.default_rng(1))
    _f32_close(optimizer.global_norm(tree_map(torch.from_numpy,
                                                        tree)),
               j_opt.global_norm(jax.tree.map(jnp.asarray, tree)), "norm")


# ---------------------------------------------------------------------------
# model_flops, abstract_init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_flops_equal(arch):
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for name, shape in SHAPES.items():
            assert model_flops(cfg, shape) == j_model_flops(
                jcfg, J_SHAPES[name]), (arch, smoke, name)


@pytest.mark.parametrize("arch,smoke", [(a, True) for a in sorted(J_ARCHS)]
                         + [("minitron-8b", False), ("mamba2-370m", False)])
def test_abstract_init_shapes_equal(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    port = to_reference_layout(cfg, abstract_init(build_model(cfg, "cpu")))
    ref, _ = j_abstract_init(jax_build_model(jax_get_config(arch,
                                                            smoke=smoke)))
    want = _ref_paths(ref)
    got = dict(leaf_paths(port))
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# the loss, gradients and the train step of the smoke models
# ---------------------------------------------------------------------------

def _batch(cfg, seq, batch, step=0):
    block = j_data.global_batch_np(j_data.DataConfig(
        vocab=cfg.vocab, seq=seq, global_batch=batch), step)
    jb = {"tokens": jnp.asarray(block[:, :-1]),
          "labels": jnp.asarray(block[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    return jb, tb


@pytest.fixture(scope="module", params=["minitron-8b", "mamba2-370m"])
def smoke(request):
    """(reference model, params, port model, params) of a smoke config."""
    arch = request.param
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(arch, smoke=True), "cpu")
    p = params_from_numpy(m.cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, m, p


def _port_value_and_grad(m, p, tb):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
    loss, aux = make_loss_fn(m)(tree_unflatten(p, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    return loss, aux, tree_unflatten(p, list(grads))


def test_model_loss_and_every_gradient_within_bf16_bar(smoke):
    """As shipped (bf16 weights and activations): the loss within the zoo's
    bar; every gradient leaf of minitron-8b within the zoo's elementwise
    bar, of mamba2-370m within 5e-2 relative L2.  The mamba smoke model
    (tied 512-token embedding, loss ~64) is far more sensitive to where
    bf16 rounds: its leaves differ from the reference's by 0.15-2.7%
    relative L2, and rounding the port's own causal conv once instead of
    after each tap moves them by 0.5-1.9%, so a few elements of its
    reduction-like leaves (norm scales, conv bias, dt_bias) cross the
    elementwise bar by up to 1.3x.  The float32 test below holds the same
    gradients to 1e-4."""
    jm, jp, m, p = smoke
    jb, tb = _batch(m.cfg, 64, 2)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jm), has_aux=True))(jp, jb)
    loss, _, grads = _port_value_and_grad(m, p, tb)
    _bf16_bar(loss, jloss, "loss")
    want = _ref_paths(jgrads)
    got = dict(leaf_paths(to_reference_layout(m.cfg, grads)))
    assert list(got) == list(want)
    for k, g in got.items():
        assert g.dtype == torch.bfloat16 or str(want[k].dtype) == "float32"
        if m.cfg.ssm is None:
            _bf16_bar(g, want[k], k)
        else:
            assert _rel_l2(g, want[k]) <= 5e-2, k


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_model_loss_and_every_gradient_in_float32(arch, monkeypatch):
    """The same loss and gradients with both models run in float32 (the
    weights cast, each package's activation dtype patched to float32 for
    this test): the loss within 1e-5 relative, every gradient leaf within
    1e-4 relative L2."""
    import repro.models.model as j_model_mod
    import repro_torch.models.model as t_model_mod
    monkeypatch.setattr(j_model_mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(t_model_mod, "DTYPE", torch.float32)
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    m = build_model(get_config(arch, smoke=True), "cpu")
    p = params_from_numpy(m.cfg, jp, "cpu")
    jb, tb = _batch(m.cfg, 64, 2)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jm), has_aux=True))(jp, jb)
    loss, _, grads = _port_value_and_grad(m, p, tb)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _ref_paths(jgrads)
    for k, g in leaf_paths(to_reference_layout(m.cfg, grads)):
        assert g.dtype == torch.float32
        assert _rel_l2(g, want[k]) <= 1e-4, k


def test_chunked_ce_loss_and_grads_within_bf16_bar(smoke):
    """B 2, S 300: one 512-token chunk, 88 tokens dropped as the reference
    drops them; some labels ignored (-100)."""
    jm, jp, m, p = smoke
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((2, 300, m.cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, m.cfg.vocab, (2, 300))
    labels[:, ::7] = -100
    jh = jnp.asarray(hidden).astype(jnp.bfloat16)
    key = "head" if "head" in jp else "embed"

    def jf(h, w):
        return j_chunked_ce_loss(jm, {**jp, key: w}, h, jnp.asarray(labels))

    jloss, (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(jh, jp[key])
    th = torch.from_numpy(hidden).to(torch.bfloat16).requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in p[key].items()}
    loss = chunked_ce_loss(m, {**p, key: w}, th, torch.from_numpy(labels))
    gh, *gw = torch.autograd.grad(loss, [th] + list(w.values()))
    _bf16_bar(loss, jloss, "loss")
    _bf16_bar(gh, jgh, "d hidden")
    for (k, _), g in zip(w.items(), gw):
        _bf16_bar(g, jgw[k], f"d {key}/{k}")


def test_moe_lb_loss_term_on_the_reference_routes(monkeypatch):
    """deepseek-moe smoke: the loss with its load-balancing term and the
    lb_loss itself, the MoE layers on the reference's expert choice."""
    arch = "deepseek-moe-16b"
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(arch, smoke=True), "cpu")
    p = params_from_numpy(m.cfg, jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(m.cfg, 32, 2)
    routes = RouteReplay()
    dispatch = jax_moe._moe_dispatch

    def recording(params, x, cfg, swiglu=True):
        logits = (x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                  @ params["router"])
        score = (jax.nn.softmax(logits, axis=-1)
                 if cfg.router_pre_softmax else logits)
        _, idx = jax.lax.top_k(score, cfg.top_k)
        jax.debug.callback(lambda e: routes.push(np.array(e)), idx,
                           ordered=True)
        return dispatch(params, x, cfg, swiglu)
    monkeypatch.setattr(jax_moe, "_moe_dispatch", recording)
    jloss, jaux = j_make_loss_fn(jm)(jp, jb)
    with routes.replay():
        loss, aux = make_loss_fn(m)(p, tb)
    routes.check("deepseek-moe smoke")
    assert float(jaux["lb_loss"]) > 0
    _bf16_bar(aux["lb_loss"], jaux["lb_loss"], "lb_loss")
    _bf16_bar(loss, jloss, "loss")


def _step_pair(arch, mb, comp, dtype):
    """One adamw step (clip 1.0, weight decay 0.01) of a smoke model by both
    packages: (reference metrics, new params; port metrics, new params)."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(1))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    m = build_model(get_config(arch, smoke=True), "cpu")
    p = params_from_numpy(m.cfg, jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(m.cfg, 64, 4)
    jo = j_opt.adamw(1e-2, weight_decay=0.01, grad_clip=1.0)
    to = optimizer.adamw(1e-2, weight_decay=0.01, grad_clip=1.0)
    jstep = jax.jit(j_make_train_step(jm, jo, microbatches=mb,
                                      grad_compression=comp))
    jnew, _, jmet = jstep(jp, jo.init(jp), jb, jnp.asarray(0, jnp.int32))
    new, _, met = make_train_step(m, to, microbatches=mb,
                                  grad_compression=comp)(
        p, to.init(p), tb, torch.tensor(0, dtype=torch.int32))
    return jmet, jnew, met, to_reference_layout(m.cfg, new)


@pytest.mark.parametrize("mb,comp", [(1, "none"), (2, "none"), (2, "int8")])
def test_train_step_in_float32(mb, comp, monkeypatch):
    """minitron-8b's smoke model in float32 (as in the float32 gradient
    test): loss and grad_norm within 1e-5 relative, every new parameter
    within 1e-4 relative L2 after the step (Adam's first step moves a
    weight by ~ lr sign(g), so the parameters compare in float32, where no
    gradient near 0 flips its sign between the two packages)."""
    import repro.models.model as j_model_mod
    import repro_torch.models.model as t_model_mod
    monkeypatch.setattr(j_model_mod, "DTYPE", jnp.float32)
    monkeypatch.setattr(t_model_mod, "DTYPE", torch.float32)
    jmet, jnew, met, new = _step_pair("minitron-8b", mb, comp, "f32")
    for key in ("loss", "grad_norm"):
        assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * abs(
            float(jmet[key])), key
    want = _ref_paths(jnew)
    for k, t in leaf_paths(new):
        assert _rel_l2(t, want[k]) <= 1e-4, k


def test_train_step_in_bf16_within_bar():
    """As shipped, with 2 microbatches: loss and grad_norm within the zoo's
    bf16 bar."""
    jmet, _, met, _ = _step_pair("minitron-8b", 2, "none", "bf16")
    _bf16_bar(met["loss"], jmet["loss"], "loss")
    _bf16_bar(met["grad_norm"], jmet["grad_norm"], "grad_norm")


def test_train_step_refuses_shardings():
    m = build_model(get_config("minitron-8b", smoke=True), "cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        make_train_step(m, optimizer.sgd(), grad_shardings={})


def test_optimizer_state_carried_across_both_ways():
    """The reference's adamw and quantized_adamw states after a step, in the
    port's layout and back, every leaf `==`."""
    cfg = get_config("mamba2-370m", smoke=True)
    jm = jax_build_model(jax_get_config("mamba2-370m", smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(2))
    jb, _ = _batch(cfg, 32, 2)
    for jo in (j_opt.adamw(1e-3), j_opt.quantized_adamw(1e-3)):
        _, js, _ = jax.jit(j_make_train_step(jm, jo))(
            jp, jo.init(jp), jb, jnp.asarray(0, jnp.int32))
        ts = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, js), "cpu")
        back = dict(leaf_paths(opt_state_to_reference(cfg, ts)))
        want = _ref_paths(js)
        assert list(back) == list(want)
        for k, t in back.items():
            assert np.array_equal(t.numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# the loop and the launcher
# ---------------------------------------------------------------------------

def _loop(tmp, fail_at=(), steps=4, quantized_opt=False):
    res = launch_train.train("mamba2-370m", smoke=True, steps=steps, seq=32,
                             global_batch=2, microbatches=2, device="cpu",
                             ckpt_dir=str(tmp), fail_at=fail_at,
                             checkpoint_every=2, quantized_opt=quantized_opt,
                             log=lambda msg: None)
    return res


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    return root, _loop(root / "failed", fail_at=(3,)), _loop(root / "clean")


def test_train_loop_restart_replays_the_uninterrupted_losses(loop_runs):
    _, failed, clean = loop_runs
    assert failed["restarts"] == 1 and clean["restarts"] == 0
    # step 2 ran, the failure struck before step 3, the loop went back to
    # the checkpoint at step 2: step 2 again, then 3
    L = failed["losses"]
    assert len(L) == 5 and L[2] == L[3]
    assert L[:3] + L[4:] == clean["losses"]
    assert np.isfinite(L).all()


@pytest.mark.parametrize("quantized_opt", [False, True])
def test_train_loop_restart_ends_in_the_uninterrupted_state(tmp_path,
                                                            quantized_opt):
    """The restart restores the optimizer state too: a loss depends on the
    params alone, so only the state after the replayed steps shows a lost
    or corrupted moment.  f32 moments, and the int8 ones, which go through
    `opt_state_to/from_reference`."""
    failed = _loop(tmp_path / "failed", fail_at=(3,),
                   quantized_opt=quantized_opt)
    clean = _loop(tmp_path / "clean", quantized_opt=quantized_opt)
    assert failed["restarts"] == 1
    got = leaf_paths([failed["params"], failed["opt_state"]])
    want = leaf_paths([clean["params"], clean["opt_state"]])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), k


def test_train_loop_checkpoint_restores_in_the_reference(loop_runs):
    root, failed, _ = loop_runs
    cfg = failed["cfg"]
    jm = jax_build_model(jax_get_config("mamba2-370m", smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    jo = j_opt.adamw(1e-3, weight_decay=0.01, grad_clip=1.0)
    mgr = j_ckpt.CheckpointManager(str(root / "failed"))
    (rp, rs), extras = mgr.restore((jp, jo.init(jp)))
    assert extras["step"] == 4 and extras["data_step"] == 4
    want = dict(leaf_paths([to_reference_layout(cfg, failed["params"]),
                            opt_state_to_reference(cfg,
                                                   failed["opt_state"])]))
    got = _ref_paths((rp, rs))
    assert list(got) == list(want)
    for k, t in want.items():
        assert np.array_equal(_host(t), _host(got[k])), k
    # and back: the reference's checkpoint resumes the port's loop
    mgr2 = j_ckpt.CheckpointManager(str(root / "from_ref"))
    mgr2.save(4, (rp, rs), extras={"data_step": 4})
    mgr2.wait()
    model = build_model(cfg, "cpu")
    opt = optimizer.adamw(1e-3, weight_decay=0.01, grad_clip=1.0)
    p0 = model.init(7)
    ds = data.SyntheticDataset(data.DataConfig(vocab=cfg.vocab, seq=32,
                                               global_batch=2), device="cpu")
    res = train_loop(make_train_step(model, opt), p0, opt.init(p0), ds,
                     LoopConfig(total_steps=4,
                                checkpoint_dir=str(root / "from_ref")),
                     log=lambda msg: None, model_cfg=cfg)
    assert res["step"] == 4 and res["losses"] == [] and ds.state()["step"] == 4
    for (k, t), (_, w) in zip(leaf_paths(res["params"]),
                              leaf_paths(failed["params"])):
        assert torch.equal(t, w), k


def test_launch_train_cli_on_cpu(tmp_path):
    argv = ["--arch", "mamba2-370m", "--smoke", "--steps", "4", "--device",
            "cpu", "--ckpt-dir", str(tmp_path / "cli")]
    assert launch_train.main(argv) == 0
    with pytest.raises(NotImplementedError, match="queue 1 items 2 and 4"):
        launch_train.main(argv + ["--data-parallel", "2"])
