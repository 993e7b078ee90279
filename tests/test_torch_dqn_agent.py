"""The port's dueling DQN, optimizer, replay and agent against the JAX
reference, with the same numpy-made weights and batches on both sides.

Random streams differ by design (torch.Generator vs JAX keys), so the agent
is held by its parts: the Q network (rtol/atol 1e-4, the reference kernel
tests' tolerance), one TD loss + gradients + AdamW step on a numpy batch
(rtol 1e-5, atol 1e-6: float32 matmuls summed in another order), an exact
replay push, the greedy action from carried weights, and the numpy
snapshot round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as j_agent
from repro.core import dqn as j_dqn
from repro.core import replay as j_replay
from repro.kernels.dueling_qnet.ops import qnet_forward as j_qnet_forward
from repro.train.optimizer import adamw as j_adamw
from repro_torch.core import agent as t_agent
from repro_torch.core import dqn as t_dqn
from repro_torch.core import replay as t_replay
from repro_torch.kernels.dueling_qnet.ops import qnet_forward
from repro_torch.kernels.dueling_qnet.ref import dueling_qnet_ref
from repro_torch.train.optimizer import adamw as t_adamw

CPU = torch.device("cpu")
S, A = 106, 8
J_CFG = j_dqn.DQNConfig(state_dim=S, n_actions=A, gamma=0.95)
T_CFG = t_dqn.DQNConfig(state_dim=S, n_actions=A, gamma=0.95)
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(seed=0):
    """Reference-initialised weights as numpy, with non-zero biases."""
    p = {k: np.asarray(v) for k, v in
         j_dqn.init_params(jax.random.PRNGKey(seed), J_CFG).items()}
    rng = np.random.default_rng(seed)
    for k in p:
        if k.startswith("b"):
            p[k] = rng.normal(0, 0.1, p[k].shape).astype(np.float32)
    return p


def _tp(p):
    """numpy param dict -> torch with an agent axis of 1."""
    return {k: torch.from_numpy(v.copy())[None] for k, v in p.items()}


def _states(n, seed=1):
    return np.random.default_rng(seed).random((n, S)).astype(np.float32) * 2


@pytest.mark.parametrize("n", [1, 64, 200])
def test_q_values_match_reference_kernel(n):
    p, x = _params(), _states(n)
    want = np.asarray(j_qnet_forward({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x),
                                     interpret=True))
    tp, tx = _tp(p), torch.from_numpy(x)[None]
    np.testing.assert_allclose(t_dqn.q_values(tp, tx, T_CFG).numpy()[0],
                               want, **TOL)
    np.testing.assert_allclose(t_dqn.q_values_infer(tp, tx, T_CFG).numpy()[0],
                               want, **TOL)
    np.testing.assert_allclose(qnet_forward(tp, tx).numpy()[0], want, **TOL)


def test_qnet_ref_agent_axis():
    """Two agents in one call compute each agent's own network."""
    p0, p1, x = _params(0), _params(1), _states(5)
    tp = {k: torch.from_numpy(np.stack([p0[k], p1[k]])) for k in p0}
    tx = torch.from_numpy(np.stack([x, x]))
    q = dueling_qnet_ref(tx, *[tp[k] for k in ("w0", "b0", "w1", "b1", "w_v",
                                               "b_v", "w_a", "b_a")])
    for g, p in enumerate((p0, p1)):
        want = np.asarray(j_dqn.q_values({k: jnp.asarray(v) for k, v in
                                          p.items()}, jnp.asarray(x), J_CFG))
        np.testing.assert_allclose(q[g].numpy(), want, **TOL)


def _batch(seed=2, n=64):
    rng = np.random.default_rng(seed)
    return {"s": _states(n, seed), "a": rng.integers(0, A, n).astype(np.int32),
            "r": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
            "s2": _states(n, seed + 1),
            "done": (rng.random(n) < 0.1).astype(np.float32),
            "w": (rng.random(n) < 0.9).astype(np.float32)}


def test_td_loss_grads_and_adamw_step_match_reference():
    p, tgt, b = _params(0), _params(5), _batch()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jt = {k: jnp.asarray(v) for k, v in tgt.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss_fn = jax.jit(lambda a, c, d: jax.value_and_grad(j_dqn.td_loss)(
        a, c, d, J_CFG))
    j_loss, j_grads = loss_fn(jp, jt, jb)
    rng = np.random.default_rng(3)
    m = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: rng.random(v.shape).astype(np.float32) * 1e-5
         for k, v in p.items()}
    opt_j = j_adamw(1e-3, grad_clip=1.0)
    jnew, jopt = jax.jit(opt_j.update)(
        j_grads, {"m": {k: jnp.asarray(x) for k, x in m.items()},
                  "v": {k: jnp.asarray(x) for k, x in v.items()}}, jp,
        jnp.asarray(7, jnp.int32))

    tp = {k: t.requires_grad_(True) for k, t in _tp(p).items()}
    tb = {k: torch.from_numpy(x.copy())[None] for k, x in b.items()}
    t_loss = t_dqn.td_loss(tp, _tp(tgt), tb, T_CFG)
    keys = list(tp)
    grads = dict(zip(keys, torch.autograd.grad(t_loss.sum(),
                                               [tp[k] for k in keys])))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **tol)
    for k in keys:
        np.testing.assert_allclose(grads[k].numpy()[0],
                                   np.asarray(j_grads[k]), **tol)
    tnew, topt = t_adamw(1e-3, grad_clip=1.0).update(
        grads, {"m": _tp(m), "v": _tp(v)},
        {k: t.detach() for k, t in tp.items()}, torch.tensor([7]))
    for k in keys:
        np.testing.assert_allclose(tnew[k].numpy()[0], np.asarray(jnew[k]),
                                   **tol)
        np.testing.assert_allclose(topt["m"][k].numpy()[0],
                                   np.asarray(jopt["m"][k]), **tol)
        np.testing.assert_allclose(topt["v"][k].numpy()[0],
                                   np.asarray(jopt["v"][k]), **tol)


def _agent_cfgs():
    j = j_agent.AgentConfig(dqn=J_CFG, replay_capacity=64)
    t = t_agent.AgentConfig(dqn=T_CFG, replay_capacity=64)
    return j, t


def test_masked_td_step_is_exact_noop_before_min_replay():
    _, tcfg = _agent_cfgs()
    ag = t_agent.init_agent(4, tcfg, device="cpu")
    for i in range(5):
        ag = t_agent.observe(ag, torch.rand(1, S), torch.tensor([i % A]),
                             torch.tensor([1.0]), torch.rand(1, S))
    assert not bool(t_agent.replay_ready(ag, tcfg)[0])
    out = t_agent.train(ag, tcfg)
    for k in ag.params:
        assert torch.equal(out.params[k], ag.params[k])
        assert torch.equal(out.target_params[k], ag.target_params[k])
        assert not out.opt_state["m"][k].any()
        assert not out.opt_state["v"][k].any()
    assert int(out.train_steps[0]) == 0 and float(out.loss_ema[0]) == 0.0


def test_train_step_learns_once_ready():
    _, tcfg = _agent_cfgs()
    ag = t_agent.init_agent(4, tcfg, device="cpu")
    for i in range(40):
        ag = t_agent.observe(ag, torch.rand(1, S), torch.tensor([i % A]),
                             torch.tensor([1.0]), torch.rand(1, S))
    out = t_agent.train(ag, tcfg)
    assert int(out.train_steps[0]) == 1
    assert any(not torch.equal(out.params[k], ag.params[k])
               for k in ag.params)


def test_replay_push_exact():
    rng = np.random.default_rng(6)
    cap = 8
    jb = j_replay.init_replay(cap, S)
    tb = t_replay.init_replay(cap, S, 1, CPU)
    for i in range(11):                          # wraps the ring
        s, s2 = _states(1, i)[0], _states(1, i + 50)[0]
        a, r = np.int32(rng.integers(0, A)), np.float32(rng.normal())
        done = float(i % 4 == 0)
        jb = j_replay.push(jb, s, a, r, s2, done)
        tb = t_replay.push(tb, torch.from_numpy(s)[None], torch.tensor([a]),
                           torch.tensor([r]), torch.from_numpy(s2)[None],
                           done)
    for f in j_replay.ReplayBuffer._fields:
        assert np.array_equal(getattr(tb, f).numpy()[0],
                              np.asarray(getattr(jb, f))), f
    kept = t_replay.push(tb, torch.ones(1, S), torch.tensor([3]),
                         torch.tensor([1.0]), torch.ones(1, S), 0.0,
                         mask=torch.tensor([False]))
    for f in ("s", "a", "r", "s2", "done", "ptr", "size"):
        assert torch.equal(getattr(kept, f), getattr(tb, f)), f


def _trained_reference_agent():
    """A reference agent with a non-trivial replay, moments and counters."""
    jcfg, _ = _agent_cfgs()
    ag = j_agent.cold_start(3, jcfg)
    observe = jax.jit(j_agent.observe)
    train = jax.jit(j_agent.train, static_argnums=1)
    for i in range(40):
        ag = observe(ag, _states(1, i)[0], jnp.int32(i % A),
                     jnp.float32(1.0), _states(1, i + 1)[0])
        if i >= 32:
            ag = train(ag, jcfg)
    return ag


def test_greedy_act_picks_reference_action():
    jcfg, tcfg = _agent_cfgs()
    jag = _trained_reference_agent()
    tag = t_agent.import_agent(j_agent.export_agent(jag), device="cpu")
    xs = _states(24, 9)
    j_act = jax.jit(j_agent.act, static_argnums=(1, 3))
    for x in xs:
        ja, _ = j_act(jag, jcfg, jnp.asarray(x), False)
        ta, tag2 = t_agent.act(tag, tcfg, torch.from_numpy(x)[None],
                               explore=False)
        assert int(ta[0]) == int(ja)
        assert int(tag2.step[0]) == int(tag.step[0]) + 1


def test_agent_from_numpy_round_trip():
    """`import_agent` (earlier `agent_from_numpy`) then `export_agent` on a
    trained reference agent gives back the reference's snapshot leaf for
    leaf, and importing it again gives the same state."""
    jag = _trained_reference_agent()
    snap = j_agent.export_agent(jag)
    tag = t_agent.import_agent(snap, device="cpu")
    back = t_agent.export_agent(tag)
    for k in snap.params:
        assert np.array_equal(back["params"][k], snap.params[k])
        assert np.array_equal(back["target_params"][k],
                              snap.target_params[k])
        for mv in ("m", "v"):
            assert np.array_equal(back["opt_state"][mv][k],
                                  snap.opt_state[mv][k])
    for f in j_replay.ReplayBuffer._fields:
        assert np.array_equal(back["replay"][f], getattr(snap.replay, f)), f
    for f in ("step", "train_steps", "loss_ema", "global_step"):
        assert np.array_equal(back[f], getattr(snap, f)), f
    again = t_agent.import_agent(back, device="cpu")
    assert torch.equal(again.replay.s, tag.replay.s)


def test_batched_linear_on_cpu_is_the_plain_layer_and_counts_nothing():
    """On the CPU the TD step's layer is `x @ w + b` under autograd (the
    kernels' batch-invariant order is the card's concern): the same values
    and gradients, and no kernel launch counted."""
    from repro_torch.kernels.batched_linear import ops
    ops.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 7), generator=g)
    w = torch.randn((3, 7, 4), generator=g).requires_grad_(True)
    b = torch.randn((3, 4), generator=g).requires_grad_(True)
    y = ops.linear(x, w, b)
    assert torch.equal(y, x @ w + b[:, None, :])
    gw, gb = torch.autograd.grad(y.square().sum(), [w, b])
    assert torch.equal(gw, x.transpose(1, 2) @ (2 * y.detach()))
    assert torch.equal(gb, (2 * y.detach()).sum(1))
    assert torch.equal(ops.bgemm(x, w.detach(), b.detach()), y)
    c, s = ops.bgemm_colsum(x.transpose(1, 2), y.detach())
    assert torch.equal(c, x.transpose(1, 2) @ y.detach())
    assert torch.equal(s, y.detach().sum(1))
    leaves = [x, w.detach()]
    assert torch.equal(ops.sq_norm(leaves), torch.sqrt(
        0 + x.square().reshape(3, -1).sum(1)
        + w.detach().square().reshape(3, -1).sum(1)))
    assert ops.launches == {"batched_linear": 0} and not ops.launches_by_shape
    with pytest.raises(ValueError, match="float32"):
        ops.sq_norm([torch.ones((2, 2), dtype=torch.float64)])


@pytest.mark.parametrize("hidden", [(128, 128), (64,), (32, 16, 8)])
def test_num_params_matches_reference_and_the_tree(hidden):
    """`num_params` `==` the reference's, and the size of one agent's
    (dueling) parameter tree."""
    jc = j_dqn.DQNConfig(state_dim=S, n_actions=A, hidden=hidden)
    tc = t_dqn.DQNConfig(state_dim=S, n_actions=A, hidden=hidden)
    n = t_dqn.num_params(tc)
    assert n == j_dqn.num_params(jc)
    params = t_dqn.zeros_params(tc)
    assert n == sum(int(np.prod(np.shape(v))) for v in params.values())
