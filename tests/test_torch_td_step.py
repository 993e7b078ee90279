"""The agents' TD step as the port runs it (`dqn.td_loss_and_grads`, the
`td_grad` kernel's plain version, and the `adamw_lanes` kernel's plain
version behind `update_lanes`) against autograd of the port's own
`td_loss` (bit for bit: the plain version is the CPU path) and against
the JAX reference's `jax.value_and_grad(td_loss)` and `adamw` update,
vmapped over the agents, within the bar of
`test_torch_dqn_agent.py::test_td_loss_grads_and_adamw_step_match_reference`
(rtol 1e-5, atol 1e-6: float32 products summed in another order).

Inputs are made with numpy from a seed; the reference's initial weights
are carried across with their biases made non-zero.  Shapes: the paper's
network (hidden 128 / 128, 8 actions, 64 replay rows) at the Table-1 state
(106), the sharding mapper's (24) and the 8x8 mesh's (298), G 1 and 3
agents, masked rows and agents not ready.  The kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py `[batched_linear]`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as j_dqn
from repro.train.optimizer import adamw as j_adamw
from repro_torch.core import dqn as t_dqn
from repro_torch.kernels.adamw_lanes import ops as aops
from repro_torch.kernels.adamw_lanes import ref as aref
from repro_torch.kernels.batched_linear import ops as lops
from repro_torch.kernels.td_grad import ops as tops
from repro_torch.kernels.td_grad import ref as tref
from repro_torch.train.optimizer import adamw as t_adamw

N, A = 64, 8
TOL = dict(rtol=1e-5, atol=1e-6)
MESH_8X8_STATE = 298      # nmp.engine.state_spec_for(8x8 mesh).dim


def _cfgs(S):
    return (j_dqn.DQNConfig(state_dim=S, n_actions=A, gamma=0.95),
            t_dqn.DQNConfig(state_dim=S, n_actions=A, gamma=0.95))


def _params(S, G, seed):
    """G agents' reference-initialised weights (numpy, stacked), biases
    non-zero."""
    jcfg, _ = _cfgs(S)
    rng = np.random.default_rng(seed)
    agents = []
    for g in range(G):
        p = {k: np.asarray(v) for k, v in j_dqn.init_params(
            jax.random.PRNGKey(seed + g), jcfg).items()}
        for k in p:
            if k.startswith("b"):
                p[k] = rng.normal(0, 0.1, p[k].shape).astype(np.float32)
        agents.append(p)
    return {k: np.stack([a[k] for a in agents]) for k in agents[0]}


def _batch(S, G, seed):
    rng = np.random.default_rng(seed)
    st = lambda: (rng.random((G, N, S)) * 2).astype(np.float32)
    return {"s": st(), "a": rng.integers(0, A, (G, N)).astype(np.int32),
            "r": rng.choice([-1.0, 0.0, 1.0], (G, N)).astype(np.float32),
            "s2": st(), "done": (rng.random((G, N)) < 0.1).astype(np.float32),
            "w": (rng.random((G, N)) < 0.9).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _inputs(S, G, ready, seed=0):
    p, tgt, b = _params(S, G, seed), _params(S, G, seed + 7), _batch(S, G,
                                                                     seed)
    ready = np.asarray(ready, np.float32)
    b["w"] = b["w"] * ready[:, None]        # as train_step masks the batch
    return p, tgt, b, ready


CASES = [(106, 1, [1.0]), (106, 3, [1.0, 0.0, 1.0]), (24, 3, [1.0] * 3),
         (MESH_8X8_STATE, 1, [1.0]), (24, 1, [0.0])]


@pytest.mark.parametrize("S,G,ready", CASES)
def test_plain_td_grad_is_autograd_of_td_loss(S, G, ready):
    """`td_grad/ref.py` is the CPU path of the TD step: bit for bit the
    autograd gradients of `dqn.td_loss` times `ready`."""
    p, tgt, b, rdy = _inputs(S, G, ready)
    _, cfg = _cfgs(S)
    tp, tt, tb, tr = _t(p), _t(tgt), _t(b), torch.from_numpy(rdy)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    want = t_dqn.td_loss(leaves, tt, tb, cfg)
    wg = torch.autograd.grad(want.sum(), list(leaves.values()))
    y = t_dqn.td_targets(tp, tt, tb, cfg)
    loss, grads = tref.td_grad(tp, tb["s"], tb["a"], y, tb["w"], tr, cfg)
    assert torch.equal(loss, want.detach())
    for (k, g), w_ in zip(grads.items(), wg):
        assert torch.equal(g, w_ * tr.reshape((-1,) + (1,) * (g.dim() - 1)))
    got = t_dqn.td_loss_and_grads(tp, tt, tb, cfg, tr)
    assert torch.equal(got[0], loss)
    assert all(torch.equal(got[1][k], grads[k]) for k in grads)
    if not any(ready):
        assert not any(g.any() for g in grads.values())


@pytest.mark.parametrize("S,G,ready", CASES)
def test_td_loss_and_grads_match_reference(S, G, ready):
    p, tgt, b, rdy = _inputs(S, G, ready)
    jcfg, cfg = _cfgs(S)

    def j_step(p_, t_, b_, r_):
        loss, g = jax.value_and_grad(j_dqn.td_loss)(p_, t_, b_, jcfg)
        return loss, jax.tree.map(lambda x: x * r_, g)

    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    j_loss, j_grads = jax.jit(jax.vmap(j_step))(j(p), j(tgt), j(b),
                                                jnp.asarray(rdy))
    loss, grads = t_dqn.td_loss_and_grads(_t(p), _t(tgt), _t(b), cfg,
                                          torch.from_numpy(rdy))
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **TOL)
    assert set(grads) == set(j_grads)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(j_grads[k]),
                                   **TOL)
        for g in np.flatnonzero(rdy == 0):
            assert not grads[k][g].any()


def _adam_inputs(S, G, seed=3):
    rng = np.random.default_rng(seed)
    p = _params(S, G, seed)
    grads = {k: (rng.normal(0, 0.3, v.shape)).astype(np.float32)
             for k, v in p.items()}
    m = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: (rng.random(v.shape) * 1e-5).astype(np.float32)
         for k, v in p.items()}
    return p, grads, m, v


@pytest.mark.parametrize("S,G,clip", [(106, 3, 1.0), (24, 1, 1.0),
                                      (106, 2, 0.0)])
def test_adamw_lanes_plain_is_update_lanes_and_reference(S, G, clip):
    """`update_lanes` (the agent's AdamW, a (G,) step) is the plain
    version on the CPU, bit for bit, and the reference's clipped AdamW
    vmapped over the agents within the bar.  Agent 1 (where G > 1) has
    zero gradients, as an agent that is not ready."""
    p, grads, m, v = _adam_inputs(S, G)
    if G > 1:
        grads = {k: np.concatenate([x[:1], np.zeros_like(x[1:2]), x[2:]])
                 for k, x in grads.items()}
    steps = np.arange(G, dtype=np.int32) * 5 + 3
    opt = t_adamw(1e-3, grad_clip=clip)
    new_p, new_s = opt.update(_t(grads), {"m": _t(m), "v": _t(v)}, _t(p),
                              torch.from_numpy(steps))
    t = torch.from_numpy(steps).to(torch.float32) + 1.0
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, grad_clip=clip)
    args = (_t(grads), _t(m), _t(v), _t(p), 1 - torch.pow(0.9, t),
            1 - torch.pow(0.999, t), torch.full((G,), 1e-3))
    for fn in (aref.adamw_lanes, aops.adamw_lanes):
        rp, rm, rv = fn(*args, **kw)
        for k in p:
            assert torch.equal(rp[k], new_p[k])
            assert torch.equal(rm[k], new_s["m"][k])
            assert torch.equal(rv[k], new_s["v"][k])
    assert aops.launches["adamw_lanes"] == 0

    j = lambda tree: {k: jnp.asarray(x) for k, x in tree.items()}
    jnew, jopt = jax.jit(jax.vmap(j_adamw(1e-3, grad_clip=clip).update))(
        j(grads), {"m": j(m), "v": j(v)}, j(p), jnp.asarray(steps))
    for k in p:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(jnew[k]),
                                   **TOL)
        np.testing.assert_allclose(new_s["m"][k].numpy(),
                                   np.asarray(jopt["m"][k]), **TOL)
        np.testing.assert_allclose(new_s["v"][k].numpy(),
                                   np.asarray(jopt["v"][k]), **TOL)


def _torch_params(S, hidden=(128, 128), n_actions=A, dueling=True, G=2):
    cfg = t_dqn.DQNConfig(state_dim=S, hidden=hidden, n_actions=n_actions,
                          dueling=dueling)
    return t_dqn.init_params(torch.tensor([0, 1]), cfg, G,
                             torch.device("cpu")), cfg


@pytest.mark.parametrize("S,hidden,n_actions,dueling,rows,covered", [
    (106, (128, 128), 8, True, 64, True),
    (24, (128, 128), 8, True, 64, True),
    (MESH_8X8_STATE, (128, 128), 8, True, 64, True),
    (tops.MAX_STATE, (128, 128), 8, True, 64, True),
    (tops.MAX_STATE + 1, (128, 128), 8, True, 64, False),
    (106, (96, 64), 8, True, 64, False),
    (106, (128, 128, 128), 8, True, 64, False),
    (106, (128,), 8, True, 64, False),
    (106, (128, 128), 8, False, 64, False),
    (106, (128, 128), 5, True, 64, False),
    (106, (128, 128), 8, True, 32, False)])
def test_td_step_routes_by_shape_and_counts_nothing_on_the_cpu(
        S, hidden, n_actions, dueling, rows, covered, monkeypatch):
    """`td_loss_and_grads` sends the shapes the kernel covers to
    `td_grad.ops` and every other one to the plain version (on the card:
    autograd over `batched_linear`'s products); on the CPU no kernel
    launches."""
    params, cfg = _torch_params(S, hidden, n_actions, dueling)
    assert tops.covers(params, torch.zeros((2, rows, S))) is covered
    calls = []
    for mod in (tops, tref):
        fn = mod.td_grad
        monkeypatch.setattr(mod, "td_grad", lambda *a, _f=fn, _m=mod: (
            calls.append(_m), _f(*a))[1])
    for ops in (tops, aops, lops):
        ops.reset_launches()
    rng = np.random.default_rng(1)
    G = 2
    batch = {"s": torch.from_numpy(rng.random((G, rows, S), np.float32)),
             "a": torch.from_numpy(rng.integers(0, n_actions, (G, rows)
                                                ).astype(np.int32)),
             "r": torch.ones((G, rows)), "s2": torch.zeros((G, rows, S)),
             "done": torch.zeros((G, rows)), "w": torch.ones((G, rows))}
    loss, grads = t_dqn.td_loss_and_grads(params, params, batch, cfg,
                                          torch.ones(G))
    # on the CPU the kernel's wrapper takes the plain version itself
    assert calls == ([tops, tref] if covered else [tref])
    assert loss.shape == (G,) and set(grads) == set(params)
    opt = t_adamw(cfg.lr, grad_clip=cfg.grad_clip)
    opt.update(grads, opt.init(params), params,
               torch.zeros(G, dtype=torch.int32))
    assert tops.launches == {"td_grad": 0}
    assert aops.launches == {"adamw_lanes": 0}
    assert lops.launches == {"batched_linear": 0}
