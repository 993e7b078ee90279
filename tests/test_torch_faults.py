"""The PyTorch port's fault-injection harness (`repro_torch/nmp/faults.py`)
and the recovery paths of its server and checkpoints, on the CPU, against
the reference.

Each serving drill runs on both packages with the same fault plan: a
poisoned warm agent, silent store poison with rollback, attributed
failures up to quarantine, an unattributed failed tick, a stall over the
deadline, and the shrink of a lone process (1 -> 1; the shrink over
process-group ranks, 2 -> 1, is in tests/test_torch_fleet.py).  Bars: every tenant's served
phases `==` to the reference server's (dtype too), the recovery counters
of `stats()["faults"]` and the tenants' health `==` to the reference's,
and the healthy tenants `==` to the port's fault-free solo runs.  The
reference's drills run in a module-scoped fixture.  Then the harness itself
(one-shot events, seeded byte flips equal to the reference's), submit
validation, a checkpoint corrupted by the stream hook, and a writer killed
mid-save restoring its newest committed step.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.nmp import NMPConfig as JCfg
from repro.nmp import faults as j_faults
from repro.nmp.scenarios import tenant_fleet as j_tenant_fleet
from repro.nmp.scenarios import tenant_stream as j_tenant_stream
from repro.nmp.serving import MappingServer as JServer
from repro_torch.core import agent as agent_mod
from repro_torch.nmp import faults, partition
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.continual import PolicyStore, run_stream
from repro_torch.nmp.engine import default_agent_cfg
from repro_torch.nmp.faults import FaultEvent, FaultPlan, InjectedFault
from repro_torch.nmp.scenarios import tenant_fleet, tenant_stream
from repro_torch.nmp.serving import MappingServer, solo_stream
from repro_torch.nmp.traces import make_trace
from repro_torch.train.checkpoint import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
CFG = NMPConfig()
CPU = "cpu"
N_OPS = 384

PORT = dict(server=lambda **kw: MappingServer(CFG, device=CPU, **kw),
            fleet=tenant_fleet, stream=tenant_stream, faults=faults)
REF = dict(server=lambda **kw: JServer(JCfg(), **kw),
           fleet=j_tenant_fleet, stream=j_tenant_stream, faults=j_faults)


def _fleet(pk, n_tenants, n_phases=2):
    return pk["fleet"](n_tenants=n_tenants, apps=("KM", "SC"),
                       n_phases=n_phases, n_ops_per_app=N_OPS)


def _serve(pk, fleet, **kw):
    srv = pk["server"](n_slots=2, **kw)
    for tid, stream in fleet.items():
        srv.submit(tid, stream)
    srv.run()
    return srv


def _plan(pk, *events, seed=0):
    f = pk["faults"]
    return f.FaultPlan([f.FaultEvent(**e) for e in events], seed=seed)


def drill_poison_warm_agent(pk):
    plan = _plan(pk, dict(kind="poison_agent", at=1, tenant="t001"))
    return _serve(pk, _fleet(pk, 3), faults=plan, backoff_base_s=0.001)


def drill_store_poison_rollback(pk):
    stream = pk["stream"](apps=("KM", "SC"), n_phases=3, n_ops_per_app=N_OPS)
    srv = pk["server"](n_slots=2, backoff_base_s=0.001)
    srv.submit("t", stream)
    srv.tick()
    srv.tick()                                   # two puts: _prev is armed
    pk["faults"].poison_store_agent(srv.store, "t")
    assert not pk["faults"].params_finite(srv.store.get("t"))
    srv.run()
    return srv


def drill_fail_tick_quarantine(pk):
    plan = _plan(pk, *(dict(kind="fail_tick", at=i, tenant="t000")
                       for i in range(10)))
    return _serve(pk, _fleet(pk, 3), faults=plan, max_phase_retries=1,
                  backoff_base_s=0.001)


def drill_unattributed_fail_tick(pk):
    plan = _plan(pk, dict(kind="fail_tick", at=0))
    return _serve(pk, _fleet(pk, 2, n_phases=1), faults=plan,
                  backoff_base_s=0.001)


def drill_stall_deadline(pk):
    stream = pk["stream"](apps=("KM",), n_phases=2, n_ops_per_app=N_OPS)
    warmup = pk["server"](n_slots=2, backoff_base_s=0.001)
    warmup.submit("warmup", stream)
    warmup.run()                        # the resident shapes are warm
    deadline = max(4 * warmup.stats()["phase_latency_p50_s"], 0.5)
    plan = _plan(pk, dict(kind="stall_tick", at=0, tenant="slow",
                          stall_s=2.5 * deadline))
    srv = pk["server"](n_slots=2, backoff_base_s=0.001, faults=plan,
                       phase_deadline_s=deadline)
    srv.submit("slow", stream)
    srv.run()
    return srv


def drill_shrink_devices(pk):
    plan = _plan(pk, dict(kind="shrink_devices", at=1, keep_devices=1))
    return _serve(pk, _fleet(pk, 2, n_phases=3), faults=plan)


DRILLS = {f.__name__[len("drill_"):]: f for f in (
    drill_poison_warm_agent, drill_store_poison_rollback,
    drill_fail_tick_quarantine, drill_unattributed_fail_tick,
    drill_stall_deadline, drill_shrink_devices)}


@pytest.fixture(scope="module")
def reference_drills():
    return {name: drill(REF) for name, drill in DRILLS.items()}


def _served_equal(srv, ref, tid):
    t, rt = srv.tenant(tid), ref.tenant(tid)
    assert len(t.results) == len(rt.results), tid
    for pi in range(len(t.results)):
        got, want = srv.tenant_metrics(tid, pi), ref.tenant_metrics(tid, pi)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (
                tid, pi, k)


def _matches_solo(srv, tid, stream):
    solo = run_stream(solo_stream(tid, stream), CFG, device=CPU)
    for pi in range(len(stream)):
        served = srv.tenant_metrics(tid, pi)
        for k, w in solo.phases[pi].metrics.items():
            np.testing.assert_array_equal(served[k], w[0],
                                          err_msg=f"{tid} phase{pi} {k}")


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_drill_matches_reference(reference_drills, name):
    ref = reference_drills[name]
    srv = DRILLS[name](PORT)
    st, jst = srv.stats()["faults"], ref.stats()["faults"]
    if name == "stall_deadline":         # a wall-clock counter: >= 1 each
        assert st.pop("deadline_misses") >= 1
        assert jst.pop("deadline_misses") >= 1
    assert st == jst
    for tid in ref._tenants:
        t, rt = srv.tenant(tid), ref.tenant(tid)
        assert (t.health, t.done, t.quarantined, t.retries) == (
            rt.health, rt.done, rt.quarantined, rt.retries), tid
        _served_equal(srv, ref, tid)
    assert srv.store.tags == ref.store.tags
    assert srv.store.rollbacks == ref.store.rollbacks


def test_poisoned_warm_agent_retries_and_stays_exact():
    srv = drill_poison_warm_agent(PORT)
    st = srv.stats()["faults"]
    assert st["injected"] == 1 and st["divergences"] >= 1
    assert st["retries"] >= 1 and st["quarantines"] == 0
    t = srv.tenant("t001")
    assert t.done and t.health == "healthy" and len(t.results) == 2
    for tid, stream in _fleet(PORT, 3).items():
        _matches_solo(srv, tid, stream)


def test_store_poison_rolls_back_to_the_last_good_version():
    srv = drill_store_poison_rollback(PORT)
    st = srv.stats()["faults"]
    assert st["divergences"] >= 1 and st["rollbacks"] >= 1
    t = srv.tenant("t")
    assert t.done and t.health == "healthy" and len(t.results) == 3
    stream = tenant_stream(apps=("KM", "SC"), n_phases=3, n_ops_per_app=N_OPS)
    solo3 = run_stream(solo_stream("t", stream), CFG, device=CPU)
    rolled = run_stream(solo_stream("t", [stream[0], stream[2]]), CFG,
                        device=CPU)
    for pi, want in ((0, solo3.phases[0]), (1, solo3.phases[1]),
                     (2, rolled.phases[1])):
        served = srv.tenant_metrics("t", pi)
        for k in sorted(want.metrics):
            np.testing.assert_array_equal(served[k], want.metrics[k][0],
                                          err_msg=f"phase{pi} {k}")


def test_fail_tick_quarantines_only_the_target_tenant():
    srv = drill_fail_tick_quarantine(PORT)
    st = srv.stats()
    bad = srv.tenant("t000")
    assert bad.quarantined and bad.health == "quarantined"
    assert "injected tick failure" in bad.last_error
    assert st["faults"]["quarantines"] == 1 and st["tenants_quarantined"] == 1
    fleet = _fleet(PORT, 3)
    for tid in ("t001", "t002"):
        assert srv.tenant(tid).done
        _matches_solo(srv, tid, fleet[tid])
    srv.faults = None
    srv.submit("t000", fleet["t000"])
    srv.run()
    assert srv.tenant("t000").done


def test_stall_over_the_deadline_retries_the_stalled_tenant():
    srv = drill_stall_deadline(PORT)
    st = srv.stats()["faults"]
    assert st["deadline_misses"] >= 1 and st["retries"] >= 1
    t = srv.tenant("slow")
    assert t.done and t.health == "healthy" and len(t.results) == 2
    _matches_solo(srv, "slow", tenant_stream(apps=("KM",), n_phases=2,
                                             n_ops_per_app=N_OPS))


def test_shrink_to_one_device_stays_exact_and_more_is_not_ported(
        monkeypatch):
    srv = drill_shrink_devices(PORT)
    st = srv.stats()
    assert st["faults"]["device_shrinks"] == 1 and st["n_devices"] == 1
    for tid, stream in _fleet(PORT, 2, n_phases=3).items():
        _matches_solo(srv, tid, stream)
    # a lone process on a host with two GPUs asked to keep both: its mesh
    # has one rank, so it keeps that one, as the reference on one device
    # (a mesh over several cards spans the ranks of a process group)
    two = [torch.device("cpu"), torch.device("cpu")]
    monkeypatch.setattr(partition, "visible_devices", lambda device: two)
    plan = FaultPlan([FaultEvent("shrink_devices", at=0, keep_devices=2)])
    srv2 = MappingServer(CFG, n_slots=2, faults=plan, device=CPU)
    srv2.submit("t", tenant_stream(apps=("KM",), n_phases=1,
                                   n_ops_per_app=N_OPS))
    assert srv2.tick() == 1
    st2 = srv2.stats()
    assert st2["faults"]["device_shrinks"] == 1 and st2["n_devices"] == 1
    _matches_solo(srv2, "t", tenant_stream(apps=("KM",), n_phases=1,
                                           n_ops_per_app=N_OPS))


# -- the harness ------------------------------------------------------------

def test_fault_plan_events_are_one_shot_and_deterministic():
    plan = FaultPlan([FaultEvent("fail_tick", at=1, tenant="x")], seed=7)
    assert plan.on_dispatch(0, ("x",)) == ()
    with pytest.raises(InjectedFault) as ei:
        plan.on_dispatch(1, ("x", "y"))
    assert ei.value.tenant == "x"
    plan.on_dispatch(1, ("x",))
    assert plan.injected == [("fail_tick", 1, "x")]
    plan2 = FaultPlan([FaultEvent("fail_tick", at=0, tenant="gone")])
    plan2.on_dispatch(0, ("other",))
    assert not plan2.events[0].fired
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("explode")


def test_corrupt_bytes_flips_the_references_bytes(tmp_path):
    payload = bytes(range(256)) * 8
    paths = [tmp_path / n for n in ("a.bin", "b.bin", "ref.bin")]
    for p in paths:
        p.write_bytes(payload)
    faults.corrupt_bytes(str(paths[0]), np.random.default_rng(3), n_bytes=16)
    faults.corrupt_bytes(str(paths[1]), np.random.default_rng(3), n_bytes=16)
    j_faults.corrupt_bytes(str(paths[2]), np.random.default_rng(3),
                           n_bytes=16)
    assert (paths[0].read_bytes() == paths[1].read_bytes()
            == paths[2].read_bytes() != payload)


def test_poison_warm_agents_fills_only_the_target_cells():
    acfg = default_agent_cfg(CFG)
    warm = agent_mod.cold_start(torch.tensor([0, 1, 2, 3]), acfg)
    before = {k: v.clone() for k, v in warm.params.items()}
    plan = FaultPlan([FaultEvent("poison_agent", at=0, tenant="b")])
    out = plan.poison_warm_agents(0, ["a", "b"], warm, n_seeds=2)
    for k, v in out.params.items():
        assert torch.isnan(v[2:]).all() and torch.equal(v[:2], before[k][:2])
        assert torch.equal(warm.params[k], before[k])     # out of place
    assert plan.poison_warm_agents(0, ["a", "b"], warm, 2) is warm


def test_submit_rejects_poisoned_traces():
    tr = make_trace("KM", n_ops=N_OPS)
    stream = tenant_stream(apps=("KM",), n_phases=2, n_ops_per_app=N_OPS)
    srv = MappingServer(CFG, n_slots=2, device=CPU)
    bad_neg = [dataclasses.replace(sc, trace=faults.poison_trace(tr,
                                                                 "negative"))
               for (sc,) in stream]
    with pytest.raises(ValueError, match=r"tenant 'evil' phase 0.*negative"):
        srv.submit("evil", [[sc] for sc in bad_neg])
    bad_nan = dataclasses.replace(stream[1][0],
                                  trace=faults.poison_trace(tr, "nan"))
    with pytest.raises(ValueError, match=r"tenant 'evil' phase 1.*NaN"):
        srv.submit("evil", [stream[0], [bad_nan]])
    out_of_range = dataclasses.replace(
        tr, dest=np.full_like(np.asarray(tr.dest), tr.n_pages + 5))
    with pytest.raises(ValueError, match="outside the .*-page space"):
        srv.submit("evil", [[dataclasses.replace(stream[0][0],
                                                 trace=out_of_range)]])
    assert srv.stats()["faults"]["validation_rejects"] == 3
    srv.submit("evil", stream)
    srv.run()
    assert srv.tenant("evil").done


def test_run_stream_checkpoint_corruption_hook(tmp_path):
    acfg = default_agent_cfg(CFG)
    stream = solo_stream("t", tenant_stream(apps=("KM",), n_phases=2,
                                            n_ops_per_app=N_OPS))
    plan = FaultPlan([FaultEvent("corrupt_checkpoint", at=1, n_bytes=64)],
                     seed=5)
    run_stream(stream, CFG, checkpoint_dir=str(tmp_path), faults=plan,
               device=CPU)
    assert plan.injected and all(k == "corrupt_checkpoint"
                                 for k, *_ in plan.injected)
    store = PolicyStore.restore(str(tmp_path), acfg)
    assert store.restored_step == 0 and store.restore_fallbacks == 1
    clean = run_stream(stream[:1], CFG, device=CPU)
    for (k, a), (_, b) in zip(leaf_paths(store.get("t")),
                              leaf_paths(clean.store.get("t"))):
        assert np.array_equal(a, b), k


def test_stream_phase_hooks_poison_and_fail():
    stream = solo_stream("t", tenant_stream(apps=("KM",), n_phases=2,
                                            n_ops_per_app=N_OPS))
    plan = FaultPlan([FaultEvent("poison_agent", at=1, tenant="t"),
                      FaultEvent("fail_tick", at=1)])
    store = PolicyStore()
    with pytest.raises(InjectedFault, match="phase 1"):
        run_stream(stream, CFG, store=store, faults=plan, device=CPU)
    assert not faults.params_finite(store.get("t"))
    assert store.version("t") == 1           # poisoned in place, no put


_KILL_CHILD = textwrap.dedent("""
    import sys
    from repro_torch.core.agent import cold_start
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.continual import PolicyStore
    from repro_torch.nmp.engine import default_agent_cfg

    directory = sys.argv[1]
    acfg = default_agent_cfg(NMPConfig())
    store = PolicyStore()
    for k in range(200):
        store.put("t", cold_start(k, acfg, device="cpu"))
        store.save(directory, step=k)
        print(k, flush=True)
""")


def test_kill_resume_restores_newest_intact_step(tmp_path):
    """SIGKILL a process in its save loop, then restore: the newest
    committed step restores bit-exactly (it is cold_start of its own step
    index), and every printed (committed) step is still there."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD,
                             str(tmp_path)], stdout=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))
    printed = []
    deadline = time.monotonic() + 120
    try:
        while len(printed) < 3 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.strip().isdigit():
                printed.append(int(line))
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert len(printed) >= 3, "child never completed 3 saves"
    acfg = default_agent_cfg(CFG)
    store = PolicyStore.restore(str(tmp_path), acfg)
    assert store.restored_step >= printed[-1]
    assert store.corrupt_tags == []
    want = agent_mod.export_agent(
        agent_mod.cold_start(store.restored_step, acfg, device=CPU))
    for (k, a), (_, b) in zip(leaf_paths(want), leaf_paths(store.get("t"))):
        assert np.array_equal(a, b), k
    older = PolicyStore.restore(str(tmp_path), acfg, step=printed[0])
    assert older.restored_step == printed[0]
