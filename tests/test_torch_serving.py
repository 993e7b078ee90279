"""The PyTorch port's multi-tenant `MappingServer` (`repro_torch/nmp/
serving.py`) on the CPU, against the reference server and the port's own
`solo_stream` runs.

The reference serves the same fleet in a module-scoped fixture.  Bars:
every served tenant phase's metric arrays `==` (dtype too) to the
reference server's and to the port's solo `run_stream`, and the server's
counters (`stats()` minus its wall-clock fields) `==` to the reference's.
Then the port alone: resident shapes never re-dispatch a new signature at
steady state (the recompiles statistic), churn, removal with a phase in
flight, duplicate ids, eviction with cold restart, submit validation, the
frozen envelope and a forced one.
"""
import dataclasses

import numpy as np
import pytest

from repro.nmp import NMPConfig as JCfg
from repro.nmp.scenarios import tenant_fleet as j_tenant_fleet
from repro.nmp.serving import MappingServer as JServer
from repro_torch.nmp import sweep
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.continual import run_stream
from repro_torch.nmp.plan import plan_envelope
from repro_torch.nmp.scenarios import Scenario, tenant_fleet, tenant_stream
from repro_torch.nmp.serving import MappingServer, solo_stream
from repro_torch.nmp.traces import make_trace

CFG = NMPConfig()
CPU = "cpu"
N_OPS = 384
CLOCK_FIELDS = ("phase_latency_p50_s", "phase_latency_p99_s", "compile_s",
                "steady_epochs_per_sec", "steady_ticks",
                "recompiles_total", "recompiles_after_first_tick")


def _fleet(n_tenants, n_phases=2, apps=("KM", "SC"), build=tenant_fleet):
    return build(n_tenants=n_tenants, apps=apps, n_phases=n_phases,
                 n_ops_per_app=N_OPS)


def _server(**kw):
    return MappingServer(CFG, device=CPU, **kw)


def _submit_all(srv, fleet):
    for tid, stream in fleet.items():
        srv.submit(tid, stream)


def _assert_tenant_matches_solo(srv, tid, stream):
    solo = run_stream(solo_stream(tid, stream), CFG, device=CPU)
    for pi in range(len(stream)):
        served = srv.tenant_metrics(tid, pi)
        want = solo.phases[pi].metrics
        assert set(served) == set(want)
        for k in sorted(want):
            assert served[k].dtype == want[k].dtype, (tid, pi, k)
            np.testing.assert_array_equal(served[k], want[k][0],
                                          err_msg=f"{tid} phase{pi} {k}")
        res, lane = srv.tenant(tid).results[pi]
        assert np.array_equal(res.actions[lane], solo.phases[pi].actions[0])


@pytest.fixture(scope="module")
def reference_server():
    fleet = _fleet(5, n_phases=3, build=j_tenant_fleet)
    srv = JServer(JCfg(), n_slots=2, store_capacity=3)
    _submit_all(srv, fleet)
    srv.run()
    return srv, fleet


def test_tenants_match_the_reference_server_and_solo_runs(reference_server):
    ref, jfleet = reference_server
    fleet = _fleet(5, n_phases=3)
    srv = _server(n_slots=2, store_capacity=3)
    _submit_all(srv, fleet)
    srv.run()
    assert all(srv.tenant(t).done for t in fleet)
    for tid in fleet:
        assert len(srv.tenant(tid).results) == 3
        for pi in range(3):
            got, want = srv.tenant_metrics(tid, pi), ref.tenant_metrics(tid,
                                                                        pi)
            assert set(got) == set(want)
            for k, w in want.items():
                w = np.asarray(w)
                assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (
                    tid, pi, k)
        _assert_tenant_matches_solo(srv, tid, fleet[tid])
    st, jst = srv.stats(), ref.stats()
    assert set(st) == set(jst)
    for k in set(st) - set(CLOCK_FIELDS):
        assert st[k] == jst[k], k
    assert st["store"]["evictions"] > 0 and st["tenants_done"] == 5
    assert srv.store.tags == ref.store.tags
    assert srv.store.meta == ref.store.meta


def test_no_new_dispatch_signature_at_steady_state():
    fleet = _fleet(4, n_phases=2)
    srv = _server(n_slots=2)
    _submit_all(srv, fleet)
    assert srv.tick() == 2
    n_sig = sweep.compiled_sweep_programs()
    while srv.tick():
        pass
    assert sweep.compiled_sweep_programs() == n_sig
    st = srv.stats()
    assert st["recompiles_after_first_tick"] == 0
    assert st["phases_served"] == 8 and st["tenants_done"] == 4
    assert st["steady_ticks"] == st["ticks"] - st["recompiles_total"] >= 3
    assert st["slot_occupancy"] == 1.0


def test_tenant_churn_arrive_depart_mid_stream():
    fleet = _fleet(2, n_phases=3)
    srv = _server(n_slots=2)
    _submit_all(srv, fleet)
    assert srv.tick() == 2
    srv.remove("t000")
    late = tenant_stream(apps=("KM",), n_phases=1, n_ops_per_app=N_OPS,
                         seed=9)
    srv.submit("late", late)
    srv.run()
    t0, t1 = srv.tenant("t000"), srv.tenant("t001")
    assert t0.removed and t0.done and len(t0.results) == 1
    assert t1.done and len(t1.results) == 3
    assert srv.tenant("late").done
    _assert_tenant_matches_solo(srv, "t001", fleet["t001"])
    _assert_tenant_matches_solo(srv, "late", late)
    srv2 = _server(n_slots=1)
    _submit_all(srv2, _fleet(2, n_phases=1))
    srv2.remove("t001")           # still queued: slot 0 holds t000
    srv2.run()
    assert srv2.tenant("t001").removed
    assert len(srv2.tenant("t001").results) == 0


def test_remove_while_phase_in_flight_drops_prepared_entry():
    fleet = _fleet(2, n_phases=3)
    srv = _server(n_slots=2)
    _submit_all(srv, fleet)
    srv.run(max_ticks=1)            # phase 0 served, phase 1 batch prepared
    assert srv._pending is not None
    v0 = srv.store.version("t000")
    srv.remove("t000")
    assert srv._pending is not None
    srv.run()
    t0 = srv.tenant("t000")
    assert t0.removed and len(t0.results) == 1
    assert srv.store.version("t000") == v0
    assert srv.stats()["faults"]["stale_dropped"] >= 1
    assert srv.tenant("t001").done
    _assert_tenant_matches_solo(srv, "t001", fleet["t001"])


def test_duplicate_tenant_ids_rejected_while_live():
    fleet = _fleet(1)
    srv = _server(n_slots=2)
    srv.submit("dup", fleet["t000"])
    with pytest.raises(ValueError, match="already live"):
        srv.submit("dup", fleet["t000"])
    srv.run()
    srv.submit("dup", fleet["t000"])
    srv.run()
    assert srv.stats()["phases_served"] == 4


def test_evicted_lineage_cold_restarts_transparently():
    tr = make_trace("KM", n_ops=N_OPS)
    phases = [Scenario(name=f"p{i}:KM/aimm", trace=tr, mapper="aimm",
                       seed=s) for i, s in ((0, 0), (1, 1))]
    srv = _server(n_slots=2, store_capacity=1)
    srv.submit("a", [[p] for p in phases])
    srv.submit("b", [[p] for p in phases])
    srv.run()
    assert srv.store.evictions > 0 and len(srv.store) == 1
    cold = sweep.run_grid([dataclasses.replace(phases[1], lineage="fresh")],
                          CFG, device=CPU)
    got = srv.tenant_metrics("a", 1)
    for k in ("cycles", "ops", "opc_t", "invoke_t"):
        np.testing.assert_array_equal(got[k], cold.metrics[k][0],
                                      err_msg=f"evicted a {k}")
    _assert_tenant_matches_solo(srv, "b", [[p] for p in phases])


def test_submit_validation():
    tr = make_trace("KM", n_ops=N_OPS)
    srv = _server(n_slots=2)
    with pytest.raises(ValueError, match="lineage tag"):
        srv.submit("a/b", [[Scenario(name="x", trace=tr, mapper="aimm")]])
    with pytest.raises(ValueError, match="empty stream"):
        srv.submit("a", [])
    with pytest.raises(ValueError, match="learned-AIMM"):
        srv.submit("a", [[Scenario(name="x", trace=tr, mapper="none")]])
    with pytest.raises(ValueError, match="single-lane"):
        srv.submit("a", [[Scenario(name="x", trace=tr, mapper="aimm")] * 2])
    srv.submit("a", [[Scenario(name="x", trace=tr, mapper="aimm",
                               episodes=2)]])
    with pytest.raises(ValueError, match="episode count"):
        srv.submit("b", [[Scenario(name="x", trace=tr, mapper="aimm",
                                   episodes=1)]])
    with pytest.raises(ValueError, match="topology"):
        srv.submit("c", [[Scenario(name="x", trace=tr, mapper="aimm",
                                   episodes=2, topology="ring")]])


def test_frozen_envelope_rejects_oversized_latecomer():
    srv = _server(n_slots=2)
    srv.submit("small", tenant_stream(apps=("KM",), n_phases=1,
                                      n_ops_per_app=N_OPS))
    srv.tick()
    with pytest.raises(ValueError, match="frozen"):
        srv.submit("big", tenant_stream(apps=("KM",), n_phases=1,
                                        n_ops_per_app=4 * N_OPS))


def test_forced_envelope_and_slot_rounding():
    big = tenant_stream(apps=("KM", "SC"), n_phases=2,
                        n_ops_per_app=2 * N_OPS)
    env = plan_envelope([sc for ph in big for sc in ph], CFG)
    srv = _server(n_slots=3, envelope=env)
    assert srv.n_slots == 3 and srv.stats()["n_devices"] == 1
    srv.submit("small", tenant_stream(apps=("KM",), n_phases=1,
                                      n_ops_per_app=N_OPS))
    srv.submit("big", big)
    srv.run()
    assert srv.tenant("small").done and srv.tenant("big").done
    _assert_tenant_matches_solo(srv, "big", big)


def test_server_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        assert MappingServer(CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            MappingServer(CFG)
