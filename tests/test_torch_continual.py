"""The PyTorch port's continual-learning layer (`repro_torch/nmp/continual.py`,
the lineage lanes of `nmp/plan.py` and `nmp/sweep.py`, and the lifecycle
helpers of `core/agent.py`) on the CPU, against the live reference.

Reference runs sit in module-scoped fixtures: a two-phase lineage grid
(two tags, one seed-folded, beside a cold learned lane and a baseline) and
a 3-phase program-switch stream checkpointed after every phase, plus the
reference's own resume of that stream from step 0.

Bars.  Every metric and per-epoch array of every phase `==` (dtype too),
the store's tags and meta records `==`, and every integer leaf of every
stored agent `==` (replay actions, ring pointer and size, counters, the
threefry key).  The float leaves of a stored agent (weights, target
weights, Adam moments, loss EMA, replay states) are not `==`: a cold
start's weights are `prng.normal`'s, within 3 ulp of `jax.random.normal`
(tests/test_torch_prng.py); the TD step sums float32 products in another
order than XLA (one step is held at rtol 1e-5, atol 1e-6 in
tests/test_torch_dqn_agent.py); and XLA contracts the state vector's EMAs
into FMAs that eager torch does not (ROADMAP.md).  Over many TD steps
Adam's m / sqrt(v) amplifies a last-bit difference of a near-zero
gradient, and one step moves a weight by up to lr = 1e-3.

So each float leaf is held elementwise within rtol 1e-5 plus an atol
scaled to that leaf: min(1e-5, 1e-3 * max |leaf|) of the reference's
leaf.  For the weights (max |w| well above 1e-2) that is 1e-5, 1% of one
step, as for Adam's first moment m; Adam's second moment v lies far below
1e-2, so its atol is 1e-3 of its own largest value, and a v that is
zeroed, rescaled or swapped with m fails
(`test_leaf_bar_catches_planted_moment_faults`).  The differences never
flip an action here, so the metrics stay `==`.
Within the port (the same code on the same device) every leaf is `==`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as j_agent
from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp.continual import PolicyStore as JStore
from repro.nmp.continual import run_stream as j_run_stream
from repro.nmp.engine import default_agent_cfg as j_agent_cfg
from repro.nmp.scenarios import Scenario as JSc
from repro.nmp.scenarios import build_stream as j_build_stream
from repro.nmp.scenarios import seed_variants as j_sv
from repro.nmp.sweep import run_grid as j_run_grid
from repro.train.checkpoint import _leaf_paths as j_leaf_paths
from repro_torch.core import agent as A
from repro_torch.nmp import faults
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.continual import PolicyStore, run_stream
from repro_torch.nmp.engine import default_agent_cfg
from repro_torch.nmp.scenarios import Scenario, build_stream, seed_variants
from repro_torch.nmp.sweep import run_grid
from repro_torch.nmp.traces import make_trace
from repro_torch.train.checkpoint import (CheckpointCorruptError,
                                          CheckpointManager, leaf_paths)

CFG = TCfg()
ACFG = default_agent_cfg(CFG)
J_ACFG = j_agent_cfg(JCfg())
CPU = "cpu"
N_OPS = 1024
FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-5          # at most; see the module docstring
FLOAT_ATOL_SCALE = 1e-3    # of the reference leaf's max |value|


def _grid_phases(Sc, sv, mt):
    """Two lineage phases: tag "a" on three folded seeds (the lineage goes
    on from the first), tag "b" on one lane, a cold learned lane and a
    baseline beside them; the second phase moves both tags to other apps."""
    km, sc, spmv = (mt(a, n_ops=2 * N_OPS) for a in ("KM", "SC", "SPMV"))
    p0 = (sv(Sc(name="p0:a", trace=km, mapper="aimm", episodes=2,
                lineage="a"), seeds=(0, 1, 2))
          + [Sc(name="p0:b", trace=sc, mapper="aimm", episodes=2, seed=4,
                lineage="b"),
             Sc(name="p0:cold", trace=sc, mapper="aimm", episodes=2),
             Sc(name="p0:base", trace=km, technique="pei")])
    p1 = [Sc(name="p1:a", trace=spmv, mapper="aimm", lineage="a"),
          Sc(name="p1:b", trace=km, mapper="aimm", seed=4, lineage="b")]
    return p0, p1


@pytest.fixture(scope="module")
def ref_grids():
    p0, p1 = _grid_phases(JSc, j_sv, j_make_trace)
    r0 = j_run_grid(p0, JCfg())
    snap0 = {t: r0.store.get(t) for t in r0.store.tags}
    meta0 = {t: dict(m) for t, m in r0.store.meta.items()}
    r1 = j_run_grid(p1, JCfg(), store=r0.store)
    return r0, snap0, meta0, r1


def _stream(build):
    return build("switch", n_ops_per_app=N_OPS, episodes=2)


@pytest.fixture(scope="module")
def ref_stream(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ref_ck"))
    stream = _stream(j_build_stream)
    full = j_run_stream(stream, JCfg(), checkpoint_dir=ck)
    resumed = j_run_stream(stream[1:], JCfg(),
                           store=JStore.restore(ck, J_ACFG, step=0))
    return ck, full, resumed


def _metrics_equal(got, want, where=""):
    assert set(got.metrics) == set(want.metrics), where
    for k, w in want.metrics.items():
        w = np.asarray(w)
        g = got.metrics[k]
        assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)


def _leaves_vs_reference(got, want, where=""):
    """A stored port snapshot against a reference one, under the module
    docstring's bar."""
    gl, wl = leaf_paths(got), j_leaf_paths(want)
    assert [k for k, _ in gl] == [k for k, _ in wl], where
    for (k, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if np.issubdtype(w.dtype, np.floating):
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(
                g, w, rtol=FLOAT_RTOL,
                atol=min(FLOAT_ATOL, FLOAT_ATOL_SCALE * scale),
                err_msg=f"{where} {k}")
        else:
            assert np.array_equal(g, w), (where, k)


def _port(ref_snapshot):
    """A reference snapshot in the port's layout (an exact round trip)."""
    return A.export_agent(A.import_agent(ref_snapshot, CPU))


def _leaves_equal(a, b) -> bool:
    return all(ka == kb and x.dtype == y.dtype and np.array_equal(x, y)
               for (ka, x), (kb, y) in zip(leaf_paths(a), leaf_paths(b)))


# ---------------------------------------------------------------------------
# Agent lifecycle helpers
# ---------------------------------------------------------------------------

def test_hand_off_resets_scenario_counter_keeps_lifetime():
    ag = A.cold_start(0, ACFG, device=CPU)
    x = torch.zeros((1, ACFG.dqn.state_dim))
    _, ag = A.act(ag, ACFG, x)
    _, ag = A.act(ag, ACFG, x)
    assert int(ag.step[0]) == int(ag.global_step[0]) == 2
    ho = A.hand_off(ag)
    assert int(ho.step[0]) == 0 and int(ho.global_step[0]) == 2
    assert torch.equal(ho.rng, ag.rng)
    assert all(torch.equal(ho.params[k], ag.params[k]) for k in ag.params)
    assert torch.equal(ho.replay.s, ag.replay.s)


def test_agent_template_has_the_reference_layout():
    tmpl = A.agent_template(ACFG)
    want = j_leaf_paths(j_agent.export_agent(j_agent.agent_template(J_ACFG)))
    got = leaf_paths(tmpl)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype, k
        assert not g.any(), k
    # and a real agent's snapshot fits it leaf for leaf
    snap = A.export_agent(A.cold_start(3, ACFG, device=CPU))
    for (k, g), (_, t) in zip(leaf_paths(snap), got):
        assert g.shape == t.shape and g.dtype == t.dtype, k


def test_export_agent_takes_one_cell_of_a_batch():
    ag = A.cold_start(torch.tensor([5, 6, 7]), ACFG)
    for cell, seed in enumerate((5, 6, 7)):
        one = A.export_agent(A.cold_start(seed, ACFG, device=CPU))
        assert _leaves_equal(A.export_agent(ag, cell), one)
    with pytest.raises(ValueError, match="cell 3"):
        A.export_agent(ag, 3)
    both = A.cat_agents([A.import_agent(A.export_agent(ag, c), CPU)
                         for c in range(3)])
    assert _leaves_equal(A.export_agents(both), A.export_agents(ag))


def test_step_agent_matches_reference():
    """observe -> train -> act on the reference's agent: the action, key,
    counters and replay `==`, the weights within the TD step's bar."""
    jag = j_agent.cold_start(2, J_ACFG)
    rng = np.random.default_rng(0)
    tag = A.import_agent(j_agent.export_agent(jag), CPU)
    step = jax.jit(j_agent.step_agent, static_argnums=1)
    for i in range(40):
        s, s2 = (rng.standard_normal(ACFG.dqn.state_dim).astype(np.float32)
                 for _ in range(2))
        a, r = i % 8, np.float32(rng.standard_normal())
        ja, jag = step(jag, J_ACFG, jnp.asarray(s), jnp.int32(a), r,
                       jnp.asarray(s2))
        ta, tag = A.step_agent(tag, ACFG, torch.from_numpy(s)[None],
                               torch.tensor([a], dtype=torch.int32),
                               torch.tensor([r]), torch.from_numpy(s2)[None])
        assert int(ta[0]) == int(ja), i
    assert int(tag.train_steps[0]) == int(jag.train_steps) > 0
    _leaves_vs_reference(A.export_agent(tag), j_agent.export_agent(jag))


# ---------------------------------------------------------------------------
# PolicyStore registry
# ---------------------------------------------------------------------------

def test_store_put_get_checkout_and_tag_validation():
    store = PolicyStore()
    ag = A.cold_start(0, ACFG, device=CPU)
    _, ag = A.act(ag, ACFG, torch.zeros((1, ACFG.dqn.state_dim)))
    store.put("km", ag, scenario="KM")
    assert "km" in store and store.tags == ["km"] and len(store) == 1
    assert store.global_step("km") == 1
    assert store.meta["km"] == {"phases": 1, "version": 1, "global_step": 1,
                                "train_steps": 0, "scenario": "KM"}
    got = store.checkout("km", CPU)
    assert int(got.step[0]) == 0 and int(got.global_step[0]) == 1
    assert all(torch.equal(got.params[k], ag.params[k]) for k in ag.params)
    host = store.checkout_host("km")
    assert int(host["step"]) == 0 and host["step"].dtype == np.int32
    assert _leaves_equal(host, A.export_agent(got))
    for bad in ("", "a/b", 7):
        with pytest.raises(ValueError, match="lineage tag"):
            store.put(bad, ag)


def test_store_capacity_lru_eviction_and_versioning():
    with pytest.raises(ValueError, match="capacity"):
        PolicyStore(capacity=0)
    ag = A.cold_start(0, ACFG, device=CPU)
    store = PolicyStore(capacity=2)
    store.put("a", ag)
    store.put("b", ag)
    store.checkout("a", CPU)                 # recency now: b < a
    store.put("c", ag)                       # overflow -> evict LRU "b"
    assert store.tags == ["a", "c"] and "b" not in store
    assert store.evictions == 1 and store.meta["b"]["evicted"] == 1
    store.put("b", ag)                       # returning tag -> evict "a"
    assert store.tags == ["b", "c"] and store.version("b") == 2
    one = PolicyStore(capacity=1)
    for t in ("x", "y", "x"):
        one.put(t, ag)
    assert one.tags == ["x"] and one.evictions == 2
    trimmed = PolicyStore(agents={"a": A.export_agent(ag),
                                  "b": A.export_agent(ag)}, capacity=1)
    assert len(trimmed) == 1


def test_store_capacity_and_evictions_survive_checkpoint(tmp_path):
    ag = A.cold_start(0, ACFG, device=CPU)
    store = PolicyStore(capacity=2)
    for t in ("a", "b", "c"):
        store.put(t, ag)
    step = store.save(str(tmp_path))
    back = PolicyStore.restore(str(tmp_path), ACFG, step=step)
    assert back.capacity == 2 and back.evictions == 1
    assert back.tags == store.tags and back.meta == store.meta
    assert back.restored_step == step and store.restored_step is None
    # the reference restores the port's store with the same registry
    jback = JStore.restore(str(tmp_path), J_ACFG, step=step)
    assert jback.tags == store.tags and jback.evictions == 1
    for t in store.tags:
        assert _leaves_equal(_port(jback.get(t)), store.get(t))


def test_store_rollback_restores_last_good_version(tmp_path):
    store = PolicyStore()
    store.put("t", A.cold_start(0, ACFG, device=CPU))
    v1 = store.get("t")
    store.put("t", A.cold_start(1, ACFG, device=CPU))
    assert store.rollback("t") is True
    assert _leaves_equal(store.get("t"), v1)
    assert store.rollbacks == 1 and store.meta["t"]["rollbacks"] == 1
    assert store.rollback("t") is False and "t" not in store
    store.put("t", A.cold_start(2, ACFG, device=CPU))
    d = str(tmp_path / "ck")
    store.save(d, step=0)
    assert PolicyStore.restore(d, ACFG).rollbacks == 2


def _two_tag_store_dir(tmp_path):
    d = str(tmp_path / "ck")
    store = PolicyStore()
    store.put("a", A.cold_start(0, ACFG, device=CPU))
    store.put("b", A.cold_start(1, ACFG, device=CPU))
    store.save(d, step=0)
    store.put("a", A.cold_start(2, ACFG, device=CPU))
    store.put("b", A.cold_start(3, ACFG, device=CPU))
    store.save(d, step=1)
    return d


def _cold(seed):
    return A.export_agent(A.cold_start(seed, ACFG, device=CPU))


def test_restore_falls_back_past_garbage_newest_step(tmp_path):
    d = _two_tag_store_dir(tmp_path)
    shard = os.path.join(d, "step_000000001", "shard_0.npz")
    with open(shard, "r+b") as f:              # truncate: torn write
        f.truncate(os.path.getsize(shard) // 3)
    store = PolicyStore.restore(d, ACFG)
    assert store.restored_step == 0 and store.restore_fallbacks == 1
    assert store.corrupt_tags == []
    assert _leaves_equal(store.get("a"), _cold(0))
    assert _leaves_equal(store.get("b"), _cold(1))
    with pytest.raises(CheckpointCorruptError):
        PolicyStore.restore(d, ACFG, step=1)


def test_restore_empty_dir_clear_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        PolicyStore.restore(str(tmp_path), ACFG)


def test_restore_corrupted_lineage_cold_starts_only_that_tag(tmp_path):
    d = _two_tag_store_dir(tmp_path)
    meta = CheckpointManager(d).read_meta(1)
    key = next(k for k in meta["leaves"] if k.startswith("a/"))
    faults.tamper_leaf(d, 1, key)
    store = PolicyStore.restore(d, ACFG)
    assert store.restored_step == 1 and store.restore_fallbacks == 0
    assert store.corrupt_tags == ["a"] and "a" not in store
    assert store.meta["a"]["corrupt_restore"] == 1
    assert _leaves_equal(store.get("b"), _cold(3))
    # the reference makes the same call on the same directory
    jstore = JStore.restore(d, J_ACFG)
    assert jstore.corrupt_tags == ["a"] and jstore.meta == store.meta


# ---------------------------------------------------------------------------
# Lineage lanes in run_grid, against the reference
# ---------------------------------------------------------------------------

def test_lineage_grid_matches_reference(ref_grids):
    r0_ref, snap0, meta0, r1_ref = ref_grids
    p0, p1 = _grid_phases(Scenario, seed_variants, make_trace)
    r0 = run_grid(p0, CFG, device=CPU)
    assert [(g.lineage, g.n_lanes, g.n_seeds) for g in r0.plan.groups] == [
        (g.lineage, g.n_lanes, g.n_seeds) for g in r0_ref.plan.groups]
    _metrics_equal(r0, r0_ref, "phase 0")
    store = r0.store
    assert store.tags == ["a", "b"] and store.meta == meta0
    for t in store.tags:
        _leaves_vs_reference(store.get(t), snap0[t], f"phase 0 {t}")
    assert store.global_step("a") == r0.invocations(0) > 0
    r1 = run_grid(p1, CFG, store=store, device=CPU)
    assert r1.store is store
    _metrics_equal(r1, r1_ref, "phase 1")
    assert store.meta == r1_ref.store.meta
    assert all(store.meta[t]["train_steps"] > 0 for t in ("a", "b"))
    for t in store.tags:
        _leaves_vs_reference(store.get(t), r1_ref.store.get(t),
                             f"phase 1 {t}")


def test_fresh_lineage_matches_inline_cold_start():
    tr = make_trace("KM", n_ops=384)
    lin = run_grid([Scenario(name="km", trace=tr, mapper="aimm",
                             episodes=2, lineage="km")], CFG, device=CPU)
    cold = run_grid([Scenario(name="km", trace=tr, mapper="aimm",
                              episodes=2)], CFG, device=CPU)
    _metrics_equal(lin, cold)
    assert np.array_equal(lin.actions, cold.actions)
    assert cold.store is None and lin.store.tags == ["km"]


def test_warm_start_changes_trajectory():
    tr = make_trace("KM", n_ops=384)
    ph = lambda n, e=1: [Scenario(name=n, trace=tr, mapper="aimm",
                                  episodes=e, lineage="t")]
    store = run_grid(ph("p0", 2), CFG, device=CPU).store
    gs = store.global_step("t")
    warm = run_grid(ph("p1"), CFG, store=store, device=CPU)
    cold = run_grid(ph("p1"), CFG, device=CPU)
    assert (warm.metrics["cycles"][0, 0] != cold.metrics["cycles"][0, 0]
            or warm.invocations(0) != cold.invocations(0))
    assert store.global_step("t") == gs + warm.invocations(0)
    assert store.meta["t"]["phases"] == 2
    assert store.meta["t"]["scenario"] == "p1"


def _per_cell_stack(group, n_lanes_padded, store, agent_cfg, device,
                    n_seeds):
    """The warm batch stacked cell by cell on the device: `checkout` or
    `cold_start` per cell, concatenated (what `AgentStaging` replaces)."""
    cells = []
    for lane in group.lanes:
        tag = lane.scenario.lineage
        warm = store.checkout(tag, device) if tag in store else None
        for seed in lane.seeds + (lane.seeds[0],) * (n_seeds
                                                     - group.n_seeds):
            cells.append(warm if warm is not None
                         else A.cold_start(int(seed), agent_cfg,
                                           device=device))
    cells += cells[:n_seeds] * (n_lanes_padded - group.n_lanes)
    return A.cat_agents(cells)


@pytest.mark.parametrize("staging", ["on", "off"])
def test_warm_batch_staging_on_and_off_agree(staging):
    """The warm batch built through AgentStaging's host buffers equals the
    per-cell stack leaf for leaf (warm cells, a fresh tag cold-started,
    seed and lane padding), whether one AgentStaging is held across calls
    of different cell counts, as `run_grid` and the server hold one (`on`),
    or each call takes a throwaway one (`off`)."""
    from repro_torch.nmp import plan as plan_mod
    from repro_torch.nmp.sweep import AgentStaging, _warm_agent_batch
    tr = make_trace("SC", n_ops=256)
    grid = (seed_variants(Scenario(name="p", trace=tr, mapper="aimm",
                                   lineage="a"), seeds=(0, 1))
            + [Scenario(name="pb", trace=tr, mapper="aimm", seed=3,
                        lineage="b")])
    group = next(g for g in plan_mod.plan_grid(grid, CFG).groups
                 if g.lineage)
    store = PolicyStore()
    store.put("a", A.cold_start(11, ACFG, device=CPU))
    held = AgentStaging() if staging == "on" else None
    for n_lanes, n_seeds in ((3, 3), (2, 2), (3, 3)):
        if n_lanes == 2:                     # the fresh tag is warm now
            store.put("b", A.cold_start(12, ACFG, device=CPU))
        want = _per_cell_stack(group, n_lanes, store, ACFG, CPU, n_seeds)
        got = _warm_agent_batch(group, n_lanes, store, ACFG, CPU,
                                n_seeds=n_seeds, staging=held)
        assert got.step.shape == (n_lanes * n_seeds,)
        assert _leaves_equal(A.export_agents(got), A.export_agents(want))


def test_plan_refuses_ragged_lineage_episodes_and_bad_tags():
    tr = make_trace("KM", n_ops=256)
    ragged = [Scenario(name="x", trace=tr, mapper="aimm", episodes=e,
                       lineage=t) for e, t in ((1, "a"), (2, "b"))]
    with pytest.raises(ValueError, match="one episode count"):
        run_grid(ragged, CFG, device=CPU)
    with pytest.raises(ValueError, match="lineage tag"):
        run_grid([Scenario(name="x", trace=tr, mapper="aimm",
                           lineage="a/b")], CFG, device=CPU)


# ---------------------------------------------------------------------------
# run_stream and checkpoints across packages
# ---------------------------------------------------------------------------

def test_run_stream_matches_reference_and_chained_run_grids(ref_stream,
                                                            tmp_path):
    _, full_ref, _ = ref_stream
    stream = _stream(build_stream)
    res = run_stream(stream, CFG, checkpoint_dir=str(tmp_path), device=CPU)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0, 1, 2]
    for pi in range(3):
        _metrics_equal(res.phases[pi], full_ref.phases[pi], f"phase {pi}")
    assert res.store.meta == full_ref.store.meta
    _leaves_vs_reference(res.store.get("stream"),
                         full_ref.store.get("stream"), "final")
    store = PolicyStore()
    for pi, phase in enumerate(stream):
        manual = run_grid(phase, CFG, store=store, device=CPU)
        _metrics_equal(manual, res.phases[pi])
        assert np.array_equal(manual.actions, res.phases[pi].actions)
    assert _leaves_equal(store.get("stream"), res.store.get("stream"))
    # every checkpointed step holds that phase's store
    assert _leaves_equal(PolicyStore.restore(str(tmp_path), ACFG,
                                             step=2).get("stream"),
                         res.store.get("stream"))


def test_port_resumes_a_reference_checkpoint(ref_stream, tmp_path):
    """The reference wrote a stream's step 0; the port restores it and runs
    phases 1-2: the reference's own resumed run, under the module bar."""
    ck, full_ref, resumed_ref = ref_stream
    store = PolicyStore.restore(ck, ACFG, step=0)
    assert store.restored_step == 0 and store.tags == ["stream"]
    jstore = JStore.restore(ck, J_ACFG, step=0)
    assert store.meta == jstore.meta
    assert _leaves_equal(store.get("stream"), _port(jstore.get("stream")))
    out = str(tmp_path / "ck")
    res = run_stream(_stream(build_stream)[1:], CFG, store=store,
                     checkpoint_dir=out, device=CPU)
    assert CheckpointManager(out).all_steps() == [1, 2]
    for pi in range(2):
        _metrics_equal(res.phases[pi], resumed_ref.phases[pi],
                       f"resumed phase {pi + 1}")
        _metrics_equal(res.phases[pi], full_ref.phases[pi + 1],
                       f"uninterrupted phase {pi + 1}")
    _leaves_vs_reference(res.store.get("stream"),
                         resumed_ref.store.get("stream"), "resumed")


@pytest.mark.parametrize("fault", ["swap_m_v", "zero_v", "v_b0_times_0.9"])
def test_leaf_bar_catches_planted_moment_faults(ref_stream, fault):
    """The float-leaf bar holds Adam's moments at their own scale: the
    reference's trained stream agent, carried exactly into the port's
    layout, passes it; with m and v swapped, v zeroed, or v of one small
    leaf 10% off (under the flat atol 1e-5 it would pass), it fails."""
    _, full_ref, _ = ref_stream
    want = full_ref.store.get("stream")
    got = _port(want)
    _leaves_vs_reference(got, want, "exact copy")
    m, v = got["opt_state"]["m"], got["opt_state"]["v"]
    assert int(got["train_steps"]) > 0 and 0 < np.abs(v["b0"]).max() < 1e-4
    planted = {
        "swap_m_v": {"m": v, "v": m},
        "zero_v": {"m": m, "v": {k: np.zeros_like(x) for k, x in v.items()}},
        "v_b0_times_0.9": {"m": m, "v": {**v, "b0": v["b0"] * np.float32(
            0.9)}},
    }[fault]
    with pytest.raises(AssertionError):
        _leaves_vs_reference(got.replace(opt_state=planted), want, fault)


def test_resume_from_older_step_realigns_checkpoint_history(tmp_path):
    ck = str(tmp_path / "ck")
    stream = build_stream("switch", n_ops_per_app=384, episodes=1,
                          include_baseline=False)
    full = run_stream(stream, CFG, checkpoint_dir=ck, device=CPU)
    assert CheckpointManager(ck).all_steps() == [0, 1, 2]
    res = run_stream(stream[1:], CFG,
                     store=PolicyStore.restore(ck, ACFG, step=0),
                     checkpoint_dir=ck, device=CPU)
    assert CheckpointManager(ck).all_steps() == [0, 1, 2]
    for pi in (0, 1):
        _metrics_equal(res.phases[pi], full.phases[pi + 1])
    assert _leaves_equal(PolicyStore.restore(ck, ACFG, step=2).get("stream"),
                         full.store.get("stream"))
    run_stream(stream[2:], CFG, store=PolicyStore.restore(ck, ACFG, step=1),
               checkpoint_base_step=7, checkpoint_dir=ck, device=CPU)
    assert CheckpointManager(ck).all_steps() == [0, 1, 2, 7]
