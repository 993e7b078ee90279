"""threefry2x32 random streams of the PyTorch port (`repro_torch.core.prng`,
`kernels/threefry`) against jax 0.9.0's `jax.random` with its live flags
(threefry2x32, `jax_threefry_partitionable=True`), on the CPU.

Bars: `PRNGKey`, `split` (single and batched keys), `bits`, `uniform`,
`randint` and `choice(p=)` are `==` to jax over many seeds; so are the
engine's draws built on them (the neighbour draw of every topology's rows,
the agent's cold-start key).  `normal` is within 3 ulp of
`jax.random.normal` over 2^22 draws (measured maximum 3) and `erf_inv`
within 2 ulp of `jax.lax.erf_inv` (measured maximum 2): the port repeats
XLA's Giles polynomial, but torch's and XLA's `log1p` differ in the last bit
on some inputs, and the product by sqrt 2 rounds once more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from repro.core import actions as j_actions
from repro.core import agent as j_agent
from repro.core import dqn as j_dqn
from repro.nmp import topology as j_topo
from repro.nmp.config import NMPConfig as JCfg
from repro_torch.core import actions as t_actions
from repro_torch.core import agent as t_agent
from repro_torch.core import dqn as t_dqn
from repro_torch.core import prng
from repro_torch.kernels.threefry import ops, ref
from repro_torch.nmp import topology as t_topo
from repro_torch.nmp.config import NMPConfig as TCfg

CPU = torch.device("cpu")
SEEDS = [0, 1, 2, 5, 17, 123, 4096, 99991, 2**31 - 1, -1, -77]


def _np(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def _key(seed):
    return prng.PRNGKey(seed, CPU)


def test_live_flags_are_the_ones_mirrored():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_hash_matches_jax_threefry():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (4, 1000), dtype=np.uint64).astype(np.uint32)
    want = jax_prng.threefry_2x32(jnp.asarray(w[:2, 0]), jnp.asarray(w[2]))
    t = torch.from_numpy(w.astype(np.int64))
    a, b = ref.threefry2x32(t[0, 0], t[1, 0], t[2, :500], t[2, 500:])
    got = torch.cat([a, b]).numpy()
    assert np.array_equal(got, _np(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_uniform_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    assert np.array_equal(tk.numpy(), _np(jk))
    for n in (2, 3, 7):
        assert np.array_equal(prng.split(tk, n).numpy(),
                              _np(jax.random.split(jk, n)))
    for shape in ((), (5,), (3, 4)):
        assert np.array_equal(prng.bits(tk, shape).numpy(),
                              _np(jax.random.bits(jk, shape)))
        assert np.array_equal(prng.uniform(tk, shape).numpy(),
                              np.asarray(jax.random.uniform(jk, shape)))
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    assert np.array_equal(
        prng.uniform(tk, (257,), lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, (257,), jnp.float32, lo, 1.0)))


def test_batched_split_matches_vmapped_jax():
    jk = jax.random.split(jax.random.PRNGKey(11), 40)
    tk = torch.from_numpy(_np(jk))
    for n in (2, 3):
        want = jax.vmap(lambda k: jax.random.split(k, n))(jk)
        assert np.array_equal(prng.split(tk, n).numpy(), _np(want))
    # a (G, S) grid of keys, as the sweep's cells carry them
    grid = tk.reshape(8, 5, 2)
    assert np.array_equal(prng.split(grid, 3).numpy(),
                          prng.split(tk, 3).reshape(8, 5, 3, 2).numpy())


@pytest.mark.parametrize("span", [1, 2, 3, 7, 8, 13, 100, 4095, 4096, 65536,
                                  65537, 100000, 2**31 - 1])
def test_randint_matches_jax(span):
    for seed in SEEDS[:6]:
        jk, tk = jax.random.PRNGKey(seed), _key(seed)
        for shape in ((), (64,)):
            want = np.asarray(jax.random.randint(jk, shape, 0, span))
            assert np.array_equal(prng.randint(tk, shape, 0, span).numpy(),
                                  want), (seed, shape)
        lo = 5 if span < 2**31 - 5 else -5
        want = np.asarray(jax.random.randint(jk, (9,), lo, lo + span))
        assert np.array_equal(prng.randint(tk, (9,), lo, lo + span).numpy(),
                              want)


def test_randint_with_one_bound_per_key_matches_vmapped_jax():
    """The replay's draw: each agent samples below its own fill level."""
    jk = jax.random.split(jax.random.PRNGKey(3), 12)
    hi = np.array([1, 2, 3, 31, 32, 33, 100, 1000, 4095, 4096, 7, 1],
                  np.int32)
    want = jax.vmap(lambda k, h: jax.random.randint(k, (64,), 0, h))(
        jk, jnp.asarray(hi))
    got = prng.randint(torch.from_numpy(_np(jk)), (64,), 0,
                       torch.from_numpy(hi))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", [dict(topology="mesh2d"),
                                 dict(topology="torus2d"),
                                 dict(topology="ring"),
                                 dict(topology="dragonfly"),
                                 dict(mesh_x=8, mesh_y=8)],
                         ids=["mesh2d", "torus2d", "ring", "dragonfly",
                              "mesh8x8"])
def test_choice_matches_jax_on_every_neighbour_row(cfg):
    """`random_neighbor` (choice with p over the validity row) for every
    cube of every topology, 24 keys a cube: the reference's draw exactly."""
    jt = j_topo.get_topology(JCfg(**cfg))
    tt = t_topo.topology_tensors(TCfg(**cfg), CPU)
    C = jt.n_cubes
    cube = np.repeat(np.arange(C, dtype=np.int32), 24)
    jk = jax.random.split(jax.random.PRNGKey(C), cube.size)
    want = jax.jit(jax.vmap(lambda k, c: j_actions.random_neighbor(
        k, c, jnp.asarray(jt.nbr), jnp.asarray(jt.nbr_valid))))(
            jk, jnp.asarray(cube))
    got = t_actions.random_neighbor(torch.from_numpy(_np(jk)),
                                    torch.from_numpy(cube), tt.nbr,
                                    tt.nbr_valid)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # and the raw choice on uneven weights
    p = np.random.default_rng(C).random((cube.size, 5)).astype(np.float32)
    p[:, 1] = 0.0
    want = jax.vmap(lambda k, q: jax.random.choice(k, 5, p=q))(
        jk, jnp.asarray(p))
    got = prng.choice(torch.from_numpy(_np(jk)), 5, torch.from_numpy(p))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_normal_within_3_ulp_and_erf_inv_within_2():
    n = 1 << 22
    jk, tk = jax.random.PRNGKey(3), _key(3)
    got = prng.normal(tk, (n,)).numpy()
    want = np.asarray(jax.random.normal(jk, (n,)))
    d = _ulps(got, want)
    assert d.max() <= 3, d.max()
    assert (d == 0).mean() > 0.95
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(tk, (n,), lo, 1.0)
    e = _ulps(prng.erf_inv(u).numpy(),
              np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u.numpy()))))
    assert e.max() <= 2, e.max()
    assert prng.erf_inv(torch.tensor([1.0, -1.0])).isinf().all()


def test_ref_fused_draws_equal_prngs_integer_path():
    """The kernel's one-launch formulations (ref.randint draws the key's
    two halves itself, ref.uniform/choice convert their own bits) equal
    the same draws assembled from prng's split and bits."""
    tk = prng.split(_key(9), 33)
    halves = prng.split(tk, 2)
    for span in (1, 8, 4096, 65537):
        want = ref.randint_from_bits(prng.bits(halves[:, 0], (16,)),
                                     prng.bits(halves[:, 1], (16,)), 0, span,
                                     1)
        assert torch.equal(ref.randint(tk, (16,), 0, span), want)
    assert torch.equal(ref.uniform(tk, (7,)),
                       ref.bits_to_uniform(prng.bits(tk, (7,))))
    p = torch.rand((33, 4))
    cum = torch.cumsum(p, 1)
    r = cum[:, -1] * (1.0 - ref.bits_to_uniform(prng.bits(tk, ())))
    assert torch.equal(ref.choice(tk, p), (cum < r[:, None]).sum(1))


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    ops.reset_launches()
    tk = _key(1)
    ops.split(tk, 3), ops.bits(tk, (4,)), ops.uniform(tk, (4,))
    ops.randint(tk, (4,), 0, 9), ops.choice(tk[None], torch.ones(1, 3))
    assert ops.launches == {"threefry": 0} and not ops.launches_by_mode
    with pytest.raises(ValueError, match="int64"):
        ops.bits(tk.to(torch.int32), (2,))


def test_cold_start_key_and_weights_follow_the_reference():
    """The agent's stream is the reference's key bit for bit; its weights
    are `prng.normal`'s, within the normal bar of the reference's."""
    from repro.nmp.engine import default_agent_cfg as j_cfg
    from repro_torch.nmp.engine import default_agent_cfg as t_cfg
    for seed in (0, 4):
        ja = j_agent.cold_start(seed, j_cfg(JCfg()))
        ta = t_agent.cold_start(seed, t_cfg(TCfg()), device="cpu")
        assert np.array_equal(ta.rng[0].numpy(), _np(ja.rng))
        for k, w in ja.params.items():
            d = _ulps(ta.params[k][0].numpy(), np.asarray(w))
            assert d.max() <= 3, (k, d.max())
    keys = torch.from_numpy(_np(jax.random.split(jax.random.PRNGKey(2), 3)))
    p = t_dqn.init_params(keys, t_dqn.DQNConfig(state_dim=10), 3, CPU)
    for g in range(3):
        w = j_dqn.init_params(jnp.asarray(keys[g].numpy().astype(np.uint32)),
                              j_dqn.DQNConfig(state_dim=10))
        for k in w:
            assert _ulps(p[k][g].numpy(), np.asarray(w[k])).max() <= 3
