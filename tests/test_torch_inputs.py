"""Host-side inputs and small helpers of the PyTorch port against the JAX
reference: traces, topology tables, allocators, TOM candidates, the
page-info cache, migration cost, state vector, reward and actions.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; the port runs on the CPU (plain torch).  Float functions of the
reference are held under `jax.jit`, as the engine runs them: XLA then folds a
division by a constant into a multiply by its float32 reciprocal, which the
port reproduces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import actions as j_actions
from repro.core import reward as j_reward
from repro.core import state as j_state
from repro.nmp import baselines as j_base
from repro.nmp import migration as j_mig
from repro.nmp import paging as j_paging
from repro.nmp import topology as j_topo
from repro.nmp import traces as j_traces
from repro.nmp.config import NMPConfig as JCfg
from repro_torch.core import actions as t_actions
from repro_torch.core import prng
from repro_torch.core import reward as t_reward
from repro_torch.core import state as t_state
from repro_torch.nmp import baselines as t_base
from repro_torch.nmp import migration as t_mig
from repro_torch.nmp import paging as t_paging
from repro_torch.nmp import topology as t_topo
from repro_torch.nmp import traces as t_traces
from repro_torch.nmp.config import ENERGY_NJ, NMPConfig as TCfg

CPU = torch.device("cpu")
TOPOS = ("mesh2d", "torus2d", "ring", "dragonfly")


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, copy=True)) if dtype is None else \
        torch.from_numpy(np.array(a, copy=True)).to(dtype)


def test_config_matches_reference():
    from repro.nmp.config import ENERGY_NJ as J_EN
    assert TCfg() == TCfg() and J_EN == ENERGY_NJ
    for f in ("n_cubes", "page_flits", "packet_flits", "mc_cubes"):
        assert getattr(TCfg(), f) == getattr(JCfg(), f)
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(TCfg)]
            == [(f.name, f.default) for f in dataclasses.fields(JCfg)])


@pytest.mark.parametrize("seed", [None, 11])
@pytest.mark.parametrize("app", j_traces.APPS)
def test_make_trace_array_equal(app, seed):
    assert t_traces.APPS == j_traces.APPS
    a = j_traces.make_trace(app, n_ops=4096, seed=seed)
    b = t_traces.make_trace(app, n_ops=4096, seed=seed)
    assert (a.name, a.n_pages, a.iter_ops) == (b.name, b.n_pages, b.iter_ops)
    for k in ("dest", "src1", "src2", "read_write", "program_id"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), (app, k)


@pytest.mark.parametrize("name", TOPOS)
def test_topology_tensors_equal(name):
    jc, tc = JCfg(topology=name), TCfg(topology=name)
    j, t = j_topo.get_topology(jc), t_topo.get_topology(tc)
    dev = t_topo.topology_tensors(tc, CPU)
    assert (j.n_cubes, j.n_links, j.mc_cubes) == (t.n_cubes, t.n_links,
                                                  t.mc_cubes)
    for k in ("hops", "route_links", "nearest_mc", "nbr", "nbr_valid", "far",
              "routes_flat", "hops_flat"):
        ja, ta = getattr(j, k), getattr(t, k)
        assert ja.dtype == ta.dtype and np.array_equal(ja, ta), (name, k)
        assert np.array_equal(getattr(dev, k).numpy(), ja), (name, k)
    assert dev.routes_flat.shape == (j.n_cubes ** 2, j.n_links)


def test_paper_mesh_sizes():
    dev = t_topo.topology_tensors(TCfg(), CPU)
    assert (dev.n_cubes, dev.n_links) == (16, 24)
    assert tuple(dev.routes_flat.shape) == (256, 24)


@pytest.mark.parametrize("n_pages", [96, 512, 4096])
def test_tom_candidates_and_default_alloc(n_pages):
    j = np.asarray(j_base.tom_candidates(n_pages, JCfg()))
    t = t_base.tom_candidates(n_pages, TCfg(), CPU)
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), j)
    assert np.array_equal(t_paging.default_alloc(n_pages, TCfg()),
                          j_paging.default_alloc(n_pages, JCfg()))


def test_tom_colocation_score_equal():
    rng = np.random.default_rng(0)
    P, W, C = 512, 128, 16
    cands = np.asarray(j_base.tom_candidates(P, JCfg()))
    for trial in range(8):
        d, s1, s2 = (rng.integers(0, P, W).astype(np.int32) for _ in range(3))
        if trial % 2:
            s1 = d.copy()                      # heavy co-location
        valid = (np.arange(W) < rng.integers(1, W + 1)).astype(np.float32)
        for k in range(cands.shape[0]):
            want = np.asarray(jax.jit(j_base.tom_colocation_score,
                                      static_argnums=5)(
                jnp.asarray(cands[k]), d, s1, s2, valid, C))
            got = t_base.tom_colocation_score(
                _t(cands[k]), _t(d)[None], _t(s1)[None], _t(s2)[None],
                _t(valid)[None], C)
            assert got.numpy()[0] == want, (trial, k)


def test_schedule_by_id_equal():
    rng = np.random.default_rng(1)
    W = 64
    d, s1, s2 = (rng.integers(0, 16, W).astype(np.int32) for _ in range(3))
    h1, h2 = rng.random(W) < 0.5, rng.random(W) < 0.5
    for tech in range(3):
        want = np.asarray(j_base.schedule_by_id(jnp.int32(tech), d, s1, s2,
                                                h1, h2))
        got = t_base.schedule_by_id(torch.tensor([tech]), _t(d)[None],
                                    _t(s1)[None], _t(s2)[None], _t(h1)[None],
                                    _t(h2)[None])
        assert np.array_equal(got.numpy()[0], want)


def _random_cache(rng, E=16):
    tag = rng.integers(-1, 40, E).astype(np.int32)
    freq = rng.integers(0, 5, E).astype(np.float32)
    acc = rng.integers(0, 50, E).astype(np.float32)
    mig = rng.integers(0, 3, E).astype(np.float32)
    hists = [rng.random((E, h)).astype(np.float32) for h in (8, 8, 4, 4)]
    return (tag, freq, acc, mig, *hists)


@pytest.mark.parametrize("case", range(6))
def test_lookup_or_insert_and_push_hist_equal(case):
    rng = np.random.default_rng(case)
    arrs = _random_cache(rng)
    if case == 0:
        arrs = (np.full(16, -1, np.int32),) + arrs[1:]   # empty cache
    page = np.int32(arrs[0][3] if case % 2 else 77)      # hit / miss
    jc, jent = j_paging.lookup_or_insert(
        j_paging.PageInfoCache(*[jnp.asarray(a) for a in arrs]),
        jnp.asarray(page))
    tc, tent = t_paging.lookup_or_insert(
        t_paging.PageInfoCache(*[_t(a)[None] for a in arrs]),
        torch.tensor([page], dtype=torch.int32))
    assert int(tent[0]) == int(jent)
    for f in j_paging.PageInfoCache._fields:
        assert np.array_equal(getattr(tc, f).numpy()[0],
                              np.asarray(getattr(jc, f))), f
    val = np.float32(rng.random() * 10)
    want = np.asarray(j_paging.push_hist(jc.hop_hist, jent, jnp.float32(val)))
    got = t_paging.push_hist(tc.hop_hist, tent, torch.tensor([val]))
    assert np.array_equal(got.numpy()[0], want)


@pytest.mark.parametrize("name", TOPOS)
def test_migration_cost_equal(name):
    jc, tc = JCfg(topology=name), TCfg(topology=name)
    topo = t_topo.topology_tensors(tc, CPU)
    C = jc.n_cubes
    old = np.repeat(np.arange(C), C).astype(np.int32)
    new = np.tile(np.arange(C), C).astype(np.int32)
    rw = (np.arange(C * C) % 3 == 0)
    touches = (np.arange(C * C) % 11).astype(np.float32)
    lat, stall, loads = t_mig.migration_cost(_t(old), _t(new), _t(rw),
                                             _t(touches), tc, topo)
    for i in range(0, C * C, 7):
        jl, js, jld = j_mig.migration_cost(jnp.int32(old[i]), jnp.int32(new[i]),
                                           jnp.bool_(rw[i]),
                                           jnp.float32(touches[i]), jc)
        assert lat[i].item() == float(jl) and stall[i].item() == float(js)
        assert np.array_equal(loads[i].numpy(), np.asarray(jld))


def test_build_state_dim_and_values():
    rng = np.random.default_rng(3)
    spec_j = j_state.StateSpec(n_cubes=16, n_mcs=4)
    spec_t = t_state.StateSpec(n_cubes=16, n_mcs=4)
    assert spec_t.dim == spec_j.dim == 106
    args = [rng.random(16).astype(np.float32) * 900,
            rng.random(16).astype(np.float32),
            rng.random(4).astype(np.float32) * 200,
            rng.integers(0, 8, 8).astype(np.int32), np.int32(2),
            np.float32(0.3), np.float32(0.1),
            rng.random(8).astype(np.float32) * 20,
            rng.random(8).astype(np.float32) * 3000,
            rng.random(4).astype(np.float32) * 3000,
            rng.integers(0, 8, 4).astype(np.int32), np.int32(5),
            np.int32(11)]
    want = np.asarray(jax.jit(j_state.build_state, static_argnums=0)(
        spec_j, *[jnp.asarray(a) for a in args]))
    got = t_state.build_state(spec_t, *[_t(np.atleast_1d(a))[None]
                                        if np.ndim(a) else _t(np.array([a]))
                                        for a in args])
    # divisions by 500 are folded into a float32 reciprocal on both sides
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_reward_and_interval_equal():
    rng = np.random.default_rng(4)
    now = rng.random(64).astype(np.float32)
    prev = (now * (1 + rng.normal(0, 0.02, 64))).astype(np.float32)
    prev[:4] = 0.0
    want = np.asarray(j_reward.compute_reward(now, prev, deadband=0.01))
    got = t_reward.compute_reward(_t(now), _t(prev), deadband=0.01)
    assert np.array_equal(got.numpy(), want)
    lv = np.tile(np.arange(4, dtype=np.int32), 8)
    act = np.repeat(np.arange(8, dtype=np.int32), 4)
    want = np.asarray(j_actions.adjust_interval(lv, act))
    got = t_actions.adjust_interval(_t(lv), _t(act))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", TOPOS)
def test_random_neighbor_draws_legal_neighbours(name):
    topo = t_topo.topology_tensors(TCfg(topology=name), CPU)
    C = topo.n_cubes
    cube = torch.arange(C, dtype=torch.int32).repeat(64)
    keys = prng.split(prng.PRNGKey(0, CPU), cube.shape[0])
    got = t_actions.random_neighbor(keys, cube, topo.nbr, topo.nbr_valid)
    nbr, valid = topo.nbr.numpy(), topo.nbr_valid.numpy()
    for c, n in zip(cube.tolist(), got.tolist()):
        assert n in set(nbr[c][valid[c]].tolist())
    # every neighbour of every cube is reachable
    seen = {(c, n) for c, n in zip(cube.tolist(), got.tolist())}
    assert len(seen) == int(valid.sum())
    far = t_actions.far_target(cube[:C], topo.far)
    assert np.array_equal(far.numpy(), j_topo.get_topology(
        JCfg(topology=name)).far)
