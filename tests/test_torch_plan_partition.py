"""Plan and partition layers of the PyTorch port's batched engine
(`nmp/plan.py`, `nmp/partition.py`) against the live JAX reference, on the
CPU: the same grouping, seed folding, envelope, order, padding and mesh
decisions (the pattern of tests/test_plan_partition.py), the knobs'
validation, and the port's one-device placement: an explicit request for
more than one device raises NotImplementedError (multi-GPU placement is
not ported yet)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp import partition as j_part
from repro.nmp import plan as j_plan
from repro.nmp.scenarios import Scenario as JSc
from repro.nmp.scenarios import seed_variants as j_sv
from repro_torch.nmp import partition as t_part
from repro_torch.nmp import plan as t_plan
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.scenarios import Scenario as TSc
from repro_torch.nmp.scenarios import seed_variants as t_sv
from repro_torch.nmp.traces import make_trace as t_make_trace

PKG = {"j": (JSc, j_sv, j_make_trace, JCfg()),
       "t": (TSc, t_sv, t_make_trace, TCfg())}


def _mixed(side):
    Sc, sv, mt, _ = PKG[side]
    grid = []
    for app, n_ops in (("KM", 384), ("RBM", 512)):
        tr = mt(app, n_ops=n_ops)
        for mapper in ("none", "tom"):
            grid += sv(Sc(name=f"{app}/{mapper}", trace=tr, mapper=mapper),
                       seeds=(0, 1, 2))
    tr = mt("MAC", n_ops=384)
    grid += sv(Sc(name="MAC/aimm", trace=tr, mapper="aimm", episodes=2),
               seeds=(0, 1))
    grid += [Sc(name="KM/pei", trace=mt("KM", n_ops=640), technique="pei",
                mapper="aimm", forced_action=3, seed=5, topology="ring"),
             Sc(name="SPMV/pei", trace=mt("SPMV", n_ops=256),
                technique="pei", eval_episode=True, mapper="aimm")]
    grid += sv(Sc(name="KM/forced1", trace=mt("KM", n_ops=384),
                  mapper="aimm", forced_action=1), seeds=(0, 1, 2))
    grid.append(Sc(name="KM/forced3", trace=grid[-1].trace, mapper="aimm",
                   forced_action=3, seed=7))
    return grid


def _flags(f):
    return (f.has_agent, f.any_aimm, f.any_tom, f.pei_k, f.share_seed_inv)


def _same_plan(tp, jp):
    for k in ("n_ops_max", "n_pages_max", "n_epochs", "ring_len",
              "n_episodes", "agent_lineage", "topologies"):
        assert getattr(tp, k) == getattr(jp, k), k
    assert tp.n_lanes == jp.n_lanes and len(tp.groups) == len(jp.groups)
    for tg, jg in zip(tp.groups, jp.groups):
        for k in ("has_agent", "n_episodes", "n_seeds", "lineage",
                  "topology", "n_lanes"):
            assert getattr(tg, k) == getattr(jg, k), k
        assert _flags(tg.flags) == _flags(jg.flags)
        for tl, jl in zip(tg.lanes, jg.lanes):
            assert (tl.seeds, tl.indices, tl.slots) == (jl.seeds, jl.indices,
                                                        jl.slots)
            assert t_plan.lane_cost(tl) == j_plan.lane_cost(jl)
    for dims in ((1, 1), (2, 1), (2, 2), (1, 4)):
        assert (t_plan.packed_group_order(tp, *dims)
                == j_plan.packed_group_order(jp, *dims))
        assert t_plan.padding_waste(tp, *dims) == j_plan.padding_waste(jp,
                                                                       *dims)
    for i in range(len(jp.scenarios)):
        assert tp.seed_group(i) == jp.seed_group(i)


@pytest.mark.parametrize("share", ["on", "off"])
def test_plan_decisions_match_reference(share, monkeypatch):
    monkeypatch.setenv("REPRO_SEED_SHARE", share)
    tp = t_plan.plan_grid(_mixed("t"), TCfg())
    jp = j_plan.plan_grid(_mixed("j"), JCfg())
    _same_plan(tp, jp)
    assert any(g.flags.share_seed_inv for g in tp.groups) == (share == "on")


def test_group_batches_match_reference():
    tp = t_plan.plan_grid(_mixed("t"), TCfg())
    jp = j_plan.plan_grid(_mixed("j"), JCfg())
    for tg, jg in zip(tp.groups, jp.groups):
        cfg_t = dataclasses.replace(TCfg(), topology=tg.topology)
        cfg_j = dataclasses.replace(JCfg(), topology=jg.topology)
        tb = t_plan.build_group_batch(tp, tg, cfg_t)
        jb = j_plan.build_group_batch(jp, jg, cfg_j)
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].dtype == np.asarray(jb[k]).dtype, k
            assert np.array_equal(tb[k], np.asarray(jb[k])), k
        cache = {}
        again = t_plan.build_group_batch(tp, tg, cfg_t, host_cache=cache)
        assert cache and all(np.array_equal(again[k], tb[k]) for k in tb)
    for sc_t, sc_j in zip(tp.scenarios, jp.scenarios):
        for seed in (0, 4):
            for a, b in zip(t_plan.episode_schedule(sc_t, seed, 4),
                            j_plan.episode_schedule(sc_j, seed, 4)):
                assert np.array_equal(a, b)
    cands = t_plan.plan_tom_candidates(tp, TCfg(), torch.device("cpu"))
    assert np.array_equal(cands.numpy(), np.asarray(
        j_plan.plan_tom_candidates(jp, JCfg())))


def test_distinct_trace_objects_do_not_fold():
    grid = [TSc(name="a", trace=t_make_trace("KM", n_ops=384)),
            TSc(name="b", trace=t_make_trace("KM", n_ops=384))]
    assert t_plan.plan_grid(grid, TCfg()).n_lanes == 2


def test_lineage_lanes_wait_for_the_continual_layer():
    """Lineage lanes no longer wait: with the continual layer ported, a
    lineage lane forms its own group, as in the reference's plan."""
    plans = {}
    for pk, (Sc, _, mt, cfg) in PKG.items():
        tr = mt("KM", n_ops=384)
        plans[pk] = (j_plan if pk == "j" else t_plan).plan_grid(
            [Sc(name="a", trace=tr, mapper="aimm", lineage="tagA"),
             Sc(name="b", trace=tr, mapper="aimm")], cfg)
    for plan in plans.values():
        assert plan.lineage_tags() == ("tagA",)
        assert [(g.lineage, g.n_lanes) for g in plan.groups] == [
            (False, 1), (True, 1)]
    tr = t_make_trace("KM", n_ops=384)
    # a lineage tag on a lane without an agent is inert, as the reference's
    plan = t_plan.plan_grid([TSc(name="b", trace=tr, lineage="tagB"),
                             TSc(name="c", trace=tr, mapper="aimm",
                                 forced_action=2, lineage="tagC")], TCfg())
    assert plan.agent_lineage == (None, None) and plan.lineage_tags() == ()


def test_empty_grid_envelope_and_forced_plan():
    with pytest.raises(ValueError, match="empty scenario grid"):
        t_plan.plan_grid([], TCfg())
    with pytest.raises(ValueError, match="empty scenario grid"):
        t_plan.plan_envelope([], TCfg())
    grid_t, grid_j = _mixed("t"), _mixed("j")
    te = t_plan.plan_envelope(grid_t, TCfg())
    je = j_plan.plan_envelope(grid_j, JCfg())
    assert dataclasses.astuple(te) == dataclasses.astuple(je)
    big = t_plan.Envelope(te.n_ops_max * 2, te.n_pages_max + 64,
                          te.n_epochs * 2, te.ring_len + 1, te.n_episodes + 1)
    assert big.dominates(te) and not te.dominates(big)
    tp = t_plan.plan_grid(grid_t, TCfg(), envelope=big)
    jp = j_plan.plan_grid(grid_j, JCfg(), envelope=j_plan.Envelope(
        *dataclasses.astuple(big)))
    _same_plan(tp, jp)
    with pytest.raises(ValueError, match="does not cover"):
        t_plan.plan_grid(grid_t, TCfg(), envelope=dataclasses.replace(
            te, n_ops_max=1))


def test_seed_share_knob_validation(monkeypatch):
    for raw, want in (("", True), ("on", True), ("1", True), ("off", False),
                      ("0", False)):
        monkeypatch.setenv("REPRO_SEED_SHARE", raw)
        assert t_plan.seed_share_enabled() is want
    monkeypatch.setenv("REPRO_SEED_SHARE", "maybe")
    with pytest.raises(ValueError, match="REPRO_SEED_SHARE"):
        t_plan.seed_share_enabled()


# ---------------------------------------------------------------------------
# Partition layer
# ---------------------------------------------------------------------------

def test_single_device_degrades_to_no_mesh():
    assert t_part.build_mesh([object()]) is None
    assert t_part.mesh_desc(None) == j_part.mesh_desc(None)
    for n in (1, 5, 8):
        assert t_part.padded_lane_count(n, None) == j_part.padded_lane_count(
            n, None)
        assert t_part.padded_seed_count(n, None) == j_part.padded_seed_count(
            n, None)
    assert t_part.mesh_signature("cpu") == j_part.mesh_signature()


def test_pad_group_and_seed_axis_match_reference():
    rng = np.random.default_rng(0)
    batch = {"a": rng.integers(0, 9, (3, 4)), "ep_seed": rng.integers(
        0, 9, (3, 2, 5)).astype(np.int32)}
    for n_to in (3, 4, 7):
        got, want = (t_part.pad_group_batch(batch, n_to),
                     j_part.pad_group_batch(batch, n_to))
        assert all(np.array_equal(got[k], want[k]) for k in want)
    for s_to in (2, 3, 4):
        got, want = (t_part.pad_seed_axis(batch, s_to),
                     j_part.pad_seed_axis(batch, s_to))
        assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="empty group batch"):
        t_part.pad_group_batch({}, 4)


def test_sweep_devices_env_validation(monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "banana")
    with pytest.raises(ValueError, match="REPRO_SWEEP_DEVICES"):
        t_part.sweep_devices("cpu")
    for bad in ("0", "99"):
        monkeypatch.setenv("REPRO_SWEEP_DEVICES", bad)
        with pytest.raises(ValueError, match="outside"):
            t_part.sweep_devices("cpu")
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "all")
    assert len(t_part.sweep_devices("cpu")) >= 1
    assert t_part.placement("cpu") == torch.device("cpu")


def test_sweep_mesh_env_validation(monkeypatch):
    for bad in ("banana", "2x2x2", "4", "0x4", "2x-2"):
        monkeypatch.setenv("REPRO_SWEEP_MESH", bad)
        for mod in (t_part, j_part):
            with pytest.raises(ValueError, match="REPRO_SWEEP_MESH"):
                mod.sweep_mesh_shape(4)
    monkeypatch.setenv("REPRO_SWEEP_MESH", "3x2")
    with pytest.raises(ValueError) as ei:
        t_part.sweep_mesh_shape(4)
    msg = str(ei.value)
    assert "REPRO_SWEEP_MESH" in msg and "3x2" in msg
    assert "6 devices" in msg and "4 device(s)" in msg
    monkeypatch.setenv("REPRO_SWEEP_MESH", "2x2")
    assert t_part.sweep_mesh_shape(4) == j_part.sweep_mesh_shape(4) == (2, 2)
    for auto in ("", "auto"):
        monkeypatch.setenv("REPRO_SWEEP_MESH", auto)
        assert t_part.sweep_mesh_shape(4) is None


@pytest.mark.parametrize("n,groups", [
    (4, [(8, 1, 2)]), (4, [(2, 8, 2)]), (4, [(2, 8, 2), (2, 1, 1)]),
    (1, [(3, 2, 1)]), (8, [(5, 3, 6), (30, 1, 1)]), (6, [(15, 3, 6)]),
    (2, [(1, 1, 1)])])
def test_auto_mesh_shape_matches_reference(n, groups):
    assert t_part.auto_mesh_shape(n, groups) == j_part.auto_mesh_shape(
        n, groups)


def test_request_for_several_devices_raises(monkeypatch):
    """Four visible GPUs: with nothing set the sweep runs on the caller's
    one device; an explicit request for more raises NotImplementedError
    naming ROADMAP.md's multi-GPU item."""
    four = [torch.device("cpu")] * 4
    monkeypatch.setattr(t_part, "visible_devices", lambda device: four)
    monkeypatch.delenv("REPRO_SWEEP_DEVICES", raising=False)
    monkeypatch.delenv("REPRO_SWEEP_MESH", raising=False)
    assert t_part.placement("cpu") == torch.device("cpu")
    for knob, val in (("REPRO_SWEEP_DEVICES", "2"),
                      ("REPRO_SWEEP_DEVICES", "all"),
                      ("REPRO_SWEEP_MESH", "2x2")):
        monkeypatch.setenv(knob, val)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            t_part.placement("cpu")
        from repro_torch.nmp.sweep import run_grid
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_grid([TSc(name="a", trace=t_make_trace("KM", n_ops=128))],
                     TCfg(), device="cpu")
        monkeypatch.delenv(knob)
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "1")
    monkeypatch.setenv("REPRO_SWEEP_MESH", "1x1")
    assert t_part.placement("cpu") == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_part.build_mesh(four)
