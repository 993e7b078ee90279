"""The PyTorch port's batched engine `run_grid` (nmp/sweep.py) on the CPU,
held against the port's own serial runs (`run_grid_serial`: one
run_episode/run_program per scenario) and against the reference's
`run_grid` on the same grid (the pattern of tests/test_sweep_equivalence.py).

One grid covers: mixed apps (different op and page counts, so op, page and
epoch padding), mappers none/tom, techniques bnmp/ldb/pei, all 8 forced
actions on seed-folded lanes (actions 1 and 3 draw from the env's key),
learned AIMM chained over 3 training episodes (TD steps included) plus a
greedy eval episode on folded seeds, and lanes on a second topology (the stacked final env pads the link
axis).  It runs with the seed-invariant hoist on and off
(REPRO_SEED_SHARE) and with async and sync landing (REPRO_SWEEP_LAND).

Bars: cycles, ops and OPC of every cell and episode `==` (summary and per
epoch), every per-epoch timeline and integer field `==`, against both
references.  The learned lanes are `==` too on these grids: no float-order
near-tie flips an action here (the rule for one: equality up to that
epoch, and a top-two Q gap below 1e-4 relative there).
"""
import numpy as np
import pytest

from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp.scenarios import Scenario as JSc
from repro.nmp.scenarios import seed_variants as j_sv
from repro.nmp.sweep import run_grid as j_run_grid
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.scenarios import Scenario as TSc
from repro_torch.nmp.scenarios import seed_variants as t_sv
from repro_torch.nmp.sweep import lane_finite_mask, run_grid, run_grid_serial
from repro_torch.nmp.traces import make_trace as t_make_trace

KEYS = ("cycles", "ops", "opc", "migrations", "mean_hops", "compute_util",
        "frac_pages_migrated", "frac_access_migrated", "energy_nj")


def _grid(Sc, sv, mt):
    grid = []
    for app, n_ops in (("KM", 384), ("RBM", 512), ("MAC", 640)):
        tr = mt(app, n_ops=n_ops)
        for tech in ("bnmp", "pei"):
            for mapper in ("none", "tom"):
                grid += sv(Sc(name=f"{app}/{tech}/{mapper}", trace=tr,
                              technique=tech, mapper=mapper), seeds=(0, 1))
        grid.append(Sc(name=f"{app}/ldb/tom", trace=tr, technique="ldb",
                       mapper="tom"))
    km = grid[0].trace
    for a in range(8):
        grid += sv(Sc(name=f"KM/forced{a}", trace=km, mapper="aimm",
                      technique="ldb" if a % 2 else "pei", forced_action=a),
                   seeds=(0, 2, 3))
    # 3 training episodes of 16 epochs: past min_replay, so the agents take
    # TD steps (Adam, target sync) inside the grid
    grid += sv(Sc(name="SPMV/aimm", trace=mt("SPMV", n_ops=2048),
                  mapper="aimm", episodes=3, eval_episode=True),
               seeds=(0, 1, 2))
    rd = mt("RD", n_ops=448)
    for mapper, forced in (("none", -1), ("aimm", 1), ("aimm", 3)):
        grid.append(Sc(name=f"RD/ring/{forced}", trace=rd, mapper=mapper,
                       forced_action=forced, seed=4, topology="ring"))
    return grid


def _base(sc):
    """A scenario's name without its seed suffix."""
    return sc.name.rsplit("/s", 1)[0]


@pytest.fixture(scope="module")
def reference():
    grid = _grid(JSc, j_sv, j_make_trace)
    return grid, j_run_grid(grid, JCfg())


@pytest.fixture(scope="module")
def port_grid():
    return _grid(TSc, t_sv, t_make_trace)


def _same_as_reference(res, ref):
    assert res.n_episodes == ref.n_episodes
    assert set(res.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        got, want = res.metrics[k], np.asarray(v)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    for f in ("page_to_cube", "compute_remap", "rb_stamp", "page_access_ema",
              "cycles", "pending_mig_loads", "energy", "tom_active", "rng"):
        want = np.asarray(getattr(ref.final_env, f))
        got = getattr(res.final_env, f)
        if f == "rng":
            want = want.astype(np.int64)
        assert np.array_equal(got, want), f
    for i, sc in enumerate(ref.scenarios):
        for e in range(sc.total_episodes):
            a, b = res.episode_summary(i, e), ref.episode_summary(i, e)
            for k in KEYS:
                assert a[k] == b[k], (sc.name, e, k, a[k], b[k])
        assert np.array_equal(res.opc_timeline(i), ref.opc_timeline(i))
        assert res.invocations(i) == ref.invocations(i)
        assert res.seed_group(i) == ref.seed_group(i)
        assert res.variance_band(i) == ref.variance_band(i)
        for a, b in zip(res.opc_timeline_band(i), ref.opc_timeline_band(i)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("share,land", [("on", "async"), ("off", "sync")])
def test_grid_matches_reference_run_grid(reference, port_grid, share, land,
                                         monkeypatch):
    monkeypatch.setenv("REPRO_SEED_SHARE", share)
    monkeypatch.setenv("REPRO_SWEEP_LAND", land)
    _, ref = reference
    res = run_grid(port_grid, TCfg(), device="cpu")
    assert [g.n_seeds for g in res.plan.groups] == [
        g.n_seeds for g in ref.plan.groups]
    assert any(g.flags.share_seed_inv for g in res.plan.groups) == (
        share == "on")
    _same_as_reference(res, ref)
    # the forced-1/3 lanes' seeds matter (the env key drives the draw)
    cyc = {res.summary(i)["cycles"] for i, sc in enumerate(port_grid)
           if _base(sc) == "KM/forced1"}
    assert len(cyc) > 1


def test_grid_matches_port_serial_runs(port_grid):
    """Every cell against the port's own serial protocol, on a slice of the
    grid that still spans every group (learned, scripted, deterministic
    and the ring topology)."""
    pick = [sc for sc in port_grid
            if _base(sc) in ("KM/pei/tom", "MAC/bnmp/none", "RBM/ldb/tom",
                           "KM/forced1", "KM/forced3", "KM/forced6",
                           "SPMV/aimm") or sc.topology == "ring"]
    assert len(pick) == 20
    res = run_grid(pick, TCfg(), device="cpu")
    serial = run_grid_serial(pick, TCfg(), device="cpu")
    for i, sc in enumerate(pick):
        for k in KEYS:
            assert res.summary(i)[k] == serial[i][k], (sc.name, k)
    trained = [i for i, sc in enumerate(pick) if sc.forced_action < 0
               and sc.mapper == "aimm"]
    assert trained and all(res.invocations(i) > 32 for i in trained)
    # the learned lanes epoch by epoch: the grid's per-epoch actions (the
    # port's own `actions` field) and invoke flags == the serial episodes'
    from repro_torch.nmp.engine import run_episode, run_program
    for i in trained:
        sc = pick[i]
        runs = run_program(sc.trace, TCfg(), sc.technique, "aimm",
                           episodes=sc.episodes, seed=sc.seed, device="cpu")
        runs.append(run_episode(sc.trace, TCfg(), sc.technique, "aimm",
                                agent=runs[-1].agent, seed=sc.seed,
                                explore=False, device="cpu"))
        assert len(runs) == sc.total_episodes
        for e, r in enumerate(runs):
            act = r.metrics["action"].numpy()
            assert np.array_equal(res.actions[i, e, :len(act)], act), (
                sc.name, e)
            assert np.array_equal(res.metrics["invoke_t"][i, e, :len(act)],
                                  r.metrics["invoke"].numpy()), (sc.name, e)
            assert (act != 0).any(), (sc.name, e)


def test_lane_finite_mask_flags_divergent_lanes():
    import torch
    out = {"cycles": torch.ones(4, 2, 3), "ops": torch.ones(4, 2, 3,
                                                           dtype=torch.int32)}
    out["cycles"][2, 1, 0] = float("nan")
    assert lane_finite_mask(out, None, 3, 2).tolist() == [True, True, False]
    tr = t_make_trace("KM", n_ops=256)
    res = run_grid([TSc(name="a", trace=tr, mapper="aimm")], TCfg(),
                   device="cpu")
    m = {k: v[:, None] for k, v in res.metrics.items()}
    assert lane_finite_mask(m, None, 1).tolist() == [True]
