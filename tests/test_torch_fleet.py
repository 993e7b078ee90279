"""The port's partition layer over `torch.distributed` ranks (nmp/partition.py)
on the CPU, against one process and the live reference (the counterpart of
tests/test_fleet.py).

The mesh spans processes, one card each (here `gloo` ranks on the CPU): a
rank runs its (lane, seed) block of every group batch and `host_fetch`
all-gathers the blocks.  The bar is the reference's: every metric array,
the per-epoch actions, the final env and every `variance_band` `==` to the
one-process port run and to the reference's `run_grid`, for every mesh
shape (4x1, 2x2, 1x4, auto) including seed padding (S = 3 on seed dims 2
and 4), with ranks past a smaller mesh joining the gathers.  On 2 ranks:
`run_stream` with checkpoints written by rank 0 and restored by every
rank, the `MappingServer`, its shrink drill (2 -> 1) and two drills whose
retries read the agreed clock, every tenant `==` to one process.

One spawn per world size (4 ranks, then 2), every shape inside it; the
one-process runs and the reference's grid in module fixtures.  In-process:
the knobs' error paths against the reference's, a lone process asked for
several devices, and the block arithmetic of placement and gathering.
"""
import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp import partition as j_part
from repro.nmp.scenarios import Scenario as JSc
from repro.nmp.scenarios import seed_variants as j_sv
from repro.nmp.sweep import run_grid as j_run_grid
from repro_torch.nmp import partition
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.scenarios import Scenario, seed_variants
from repro_torch.nmp.traces import make_trace

CFG = NMPConfig()
CPU = "cpu"
SHAPES = ("4x1", "2x2", "1x4", "auto")
N_OPS = 384
KNOBS = ("REPRO_DIST_COORD", "REPRO_DIST_NPROCS", "REPRO_DIST_RANK",
         "REPRO_SWEEP_DEVICES", "REPRO_SWEEP_MESH", "REPRO_SWEEP_LAND")


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_grid(Sc=Scenario, sv=seed_variants, mt=make_trace):
    """tests/test_fleet.py's _MESH_SCRIPT grid."""
    grid = []
    for app in ("KM", "PR"):
        tr = mt(app, n_ops=256)
        # S=3 does not divide the 2- or 4-wide seed dims -> seed padding
        grid += sv(Sc(name=f"{app}/aimm", trace=tr, mapper="aimm",
                      episodes=2), seeds=(0, 1, 2))
        grid += [Sc(name=f"{app}/none", trace=tr, mapper="none")]
    return grid


def _record(res) -> dict:
    """What a rank sends back of a SweepResult."""
    return {"metrics": res.metrics, "actions": res.actions,
            "final_env": res.final_env, "n_devices": res.n_devices,
            "mesh_shape": res.mesh_shape,
            "bands": [res.variance_band(i)
                      for i in range(len(res.scenarios))]}


def _fleet(n_tenants, n_phases=2):
    from repro_torch.nmp.scenarios import tenant_fleet
    return tenant_fleet(n_tenants=n_tenants, apps=("KM", "SC"),
                        n_phases=n_phases, n_ops_per_app=N_OPS)


def _stream():
    from repro_torch.nmp.scenarios import continual_stream
    return continual_stream(n_ops_per_app=N_OPS, episodes=2,
                            technique="bnmp")


def _served(srv) -> dict:
    """Every tenant's served phases (metrics, actions), health and the
    server's counters."""
    tenants = {}
    for tid, t in srv._tenants.items():
        tenants[tid] = ([(srv.tenant_metrics(tid, pi), res.actions[lane])
                         for pi, (res, lane) in enumerate(t.results)],
                        (t.health, t.done, t.quarantined, t.retries))
    st = srv.stats()
    return {"tenants": tenants, "faults": st["faults"],
            "n_devices": st["n_devices"], "n_slots": st["n_slots"],
            "tags": srv.store.tags}


def _serve(fleet, faults=None, **kw):
    from repro_torch.nmp.serving import MappingServer
    srv = MappingServer(CFG, n_slots=2, backoff_base_s=0.001, faults=faults,
                        device=CPU, **kw)
    for tid, stream in fleet.items():
        srv.submit(tid, stream)
    srv.run()
    return _served(srv)


def _drills() -> dict:
    """The server runs held to one process: a clean fleet, the shrink
    drill (keep 1 at attempt 1), a poisoned warm agent and attributed
    failures up to quarantine (their retries wait out the agreed
    backoff)."""
    from repro_torch.nmp.faults import FaultEvent, FaultPlan
    return {
        "fleet": _serve(_fleet(4)),
        "shrink": _serve(_fleet(2, n_phases=3), FaultPlan(
            [FaultEvent("shrink_devices", at=1, keep_devices=1)])),
        "poison": _serve(_fleet(3), FaultPlan(
            [FaultEvent("poison_agent", at=1, tenant="t001")])),
        "quarantine": _serve(_fleet(3), FaultPlan(
            [FaultEvent("fail_tick", at=i, tenant="t000")
             for i in range(10)]), max_phase_retries=1),
    }


def _stream_runs(ck: str) -> dict:
    """`run_stream` with a checkpoint after every phase, the store restored
    from the last step, and a resume from step 0."""
    from repro_torch.core import agent as agent_mod
    from repro_torch.nmp.continual import PolicyStore, run_stream
    from repro_torch.nmp.engine import default_agent_cfg
    stream = _stream()
    full = run_stream(stream, CFG, checkpoint_dir=ck, device=CPU)
    acfg = default_agent_cfg(CFG)
    restored = PolicyStore.restore(ck, acfg)
    resumed = run_stream(stream[1:], CFG,
                         store=PolicyStore.restore(ck, acfg, step=0),
                         checkpoint_dir=ck, device=CPU)
    snap = lambda st: agent_mod.map_snapshot(np.asarray, st.get("stream"))
    return {"phases": [(r.metrics, r.actions) for r in full.phases],
            "resumed": [(r.metrics, r.actions) for r in resumed.phases],
            "store": snap(full.store), "restored": snap(restored),
            "steps": sorted(os.listdir(ck))}


def _join(rank, world, port):
    for k in KNOBS:
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    os.environ.update(REPRO_DIST_COORD=f"127.0.0.1:{port}",
                      REPRO_DIST_NPROCS=str(world),
                      REPRO_DIST_RANK=str(rank))
    assert partition.maybe_init_distributed() is True
    assert partition.maybe_init_distributed() is True        # idempotent
    assert partition.world() == (world, rank)


def _worker4(rank, port, out_dir):
    from repro_torch.nmp.sweep import run_grid
    _join(rank, 4, port)
    recs = {}
    for shape in SHAPES:
        os.environ["REPRO_SWEEP_MESH"] = shape
        recs[shape] = _record(run_grid(_mesh_grid(), CFG, device=CPU))
    # a 2-rank mesh inside the 4-rank group: ranks 2-3 hold no cells but
    # join every gather; landed in the loop this time
    os.environ.update(REPRO_SWEEP_MESH="auto", REPRO_SWEEP_DEVICES="2",
                      REPRO_SWEEP_LAND="sync")
    recs["devices2"] = _record(run_grid(_mesh_grid(), CFG, device=CPU))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)


def _worker2(rank, port, out_dir):
    _join(rank, 2, port)
    assert partition.mesh_signature(CPU) == "cpu:2:auto:1"
    mesh = partition.build_mesh(device=CPU)
    assert (mesh.shape, mesh.coord) == ((2, 1), (rank, 0))
    recs = {"stream": _stream_runs(os.path.join(out_dir, "ck")),
            **_drills()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)


def _spawn(worker, world, tmp_path):
    mp.spawn(worker, args=(_port(), str(tmp_path)), nprocs=world, join=True)
    recs = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    return recs


def _equal(got, want, what):
    """Two trees of arrays (dicts, lists, tuples, dataclasses) `==`, dtype
    too."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}/{i}")
    elif hasattr(want, "__dataclass_fields__"):
        for f in want.__dataclass_fields__:
            _equal(getattr(got, f), getattr(want, f), f"{what}.{f}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), what
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def one_process_grid():
    from repro_torch.nmp.sweep import run_grid
    return _record(run_grid(_mesh_grid(), CFG, device=CPU))


@pytest.fixture(scope="module")
def reference_grid():
    grid = _mesh_grid(JSc, j_sv, j_make_trace)
    return grid, j_run_grid(grid, JCfg())


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(_worker4, 4, tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(_worker2, 2, tmp_path_factory.mktemp("ranks2"))


# -- the grid on 4 ranks ------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES + ("devices2",))
def test_mesh_shape_equals_one_process(four_ranks, one_process_grid, shape):
    for rank, recs in enumerate(four_ranks):
        rec = recs[shape]
        want = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4),
                "auto": (2, 2), "devices2": (2, 1)}[shape]
        assert (rec["n_devices"], rec["mesh_shape"]) == (
            want[0] * want[1], want), (rank, shape)
        for k in ("metrics", "actions", "final_env", "bands"):
            _equal(rec[k], one_process_grid[k], f"rank{rank} {shape} {k}")


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shape_equals_reference(four_ranks, reference_grid, shape):
    grid, ref = reference_grid
    rec = four_ranks[0][shape]
    # the reference auto-factors the same plan the same way
    if shape == "auto":
        assert rec["mesh_shape"] == j_part.auto_mesh_shape(
            4, [(g.n_lanes, g.n_seeds, g.n_episodes)
                for g in ref.plan.groups])
    assert set(rec["metrics"]) == set(ref.metrics)
    for k, v in ref.metrics.items():
        want = np.asarray(v)
        got = rec["metrics"][k]
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    for lane in range(len(grid)):
        assert rec["bands"][lane] == ref.variance_band(lane), lane


# -- the stream, the server and the drills on 2 ranks ------------------------

@pytest.fixture(scope="module")
def one_process_runs(tmp_path_factory):
    return {"stream": _stream_runs(str(tmp_path_factory.mktemp("ck1"))),
            **_drills()}


def test_run_stream_on_two_ranks_equals_one(two_ranks, one_process_runs):
    want = one_process_runs["stream"]
    assert want["steps"] == ["step_000000000", "step_000000001",
                             "step_000000002"]
    for rank, recs in enumerate(two_ranks):
        got = recs["stream"]
        assert got["steps"] == want["steps"], rank
        for k in ("phases", "resumed", "store", "restored"):
            _equal(got[k], want[k], f"rank{rank} {k}")
        # every rank restored rank 0's checkpoint, the same store
        _equal(got["restored"], got["store"], f"rank{rank} restored")


@pytest.mark.parametrize("run", ["fleet", "shrink", "poison", "quarantine"])
def test_server_on_two_ranks_equals_one(two_ranks, one_process_runs, run):
    want = one_process_runs[run]
    for rank, recs in enumerate(two_ranks):
        got = recs[run]
        assert got["n_slots"] == want["n_slots"] == 2, rank
        _equal(got["tenants"], want["tenants"], f"rank{rank} {run}")
        assert got["faults"] == want["faults"], (rank, run)
        assert got["tags"] == want["tags"], (rank, run)
    if run == "shrink":
        assert want["faults"]["device_shrinks"] == 1
        assert [r[run]["n_devices"] for r in two_ranks] == [1, 1]
    else:
        assert [r[run]["n_devices"] for r in two_ranks] == [2, 2]
    if run == "quarantine":
        assert want["tenants"]["t000"][1][2]          # quarantined
    if run == "poison":
        assert want["faults"]["divergences"] >= 1


# -- in-process: the knobs, a lone process, the block arithmetic --------------

def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("env", [
    {"REPRO_DIST_COORD": "127.0.0.1:9999"},
    {"REPRO_DIST_COORD": "127.0.0.1:9999", "REPRO_DIST_NPROCS": "2"},
    {"REPRO_DIST_COORD": "127.0.0.1:9999", "REPRO_DIST_NPROCS": "two",
     "REPRO_DIST_RANK": "0"},
    {"REPRO_DIST_COORD": "127.0.0.1:9999", "REPRO_DIST_NPROCS": "2",
     "REPRO_DIST_RANK": "1.5"}], ids=["no-nprocs", "no-rank", "nprocs-word",
                                      "rank-float"])
def test_dist_knob_errors_equal_the_reference(monkeypatch, env):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    assert partition.maybe_init_distributed() is False
    assert j_part.maybe_init_distributed() is False
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _raised(partition.maybe_init_distributed) == _raised(
        j_part.maybe_init_distributed)


def test_dist_rank_outside_the_group_raises(monkeypatch):
    monkeypatch.setenv("REPRO_DIST_COORD", "127.0.0.1:9999")
    monkeypatch.setenv("REPRO_DIST_NPROCS", "2")
    monkeypatch.setenv("REPRO_DIST_RANK", "2")
    with pytest.raises(ValueError, match="REPRO_DIST_RANK=2 outside 0..1"):
        partition.maybe_init_distributed()


@pytest.mark.parametrize("knob,val", [("REPRO_SWEEP_DEVICES", "2"),
                                      ("REPRO_SWEEP_DEVICES", "4"),
                                      ("REPRO_SWEEP_MESH", "2x2"),
                                      ("REPRO_SWEEP_MESH", "1x2")])
def test_lone_process_asked_for_several_devices_raises(monkeypatch, knob,
                                                        val):
    """A lone process (no group) with four visible cards runs on one; a
    request for more raises a ValueError naming the REPRO_DIST_* knobs,
    from the sweep and the server alike, and never runs on one."""
    from repro_torch.nmp.serving import MappingServer
    from repro_torch.nmp.sweep import run_grid
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    four = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(partition, "visible_devices", lambda device: four)
    assert partition.sweep_devices(CPU) == [0]
    assert partition.placement(CPU) == torch.device(CPU)
    assert partition.build_mesh(device=CPU) is None
    monkeypatch.setenv(knob, val)
    for fn in (lambda: run_grid(_mesh_grid()[:1], CFG, device=CPU),
               lambda: MappingServer(CFG, n_slots=2, device=CPU),
               lambda: partition.placement(CPU)):
        msg = _raised(fn)
        assert knob in msg and "REPRO_DIST_COORD" in msg, msg
        assert "REPRO_DIST_NPROCS" in msg and "REPRO_DIST_RANK" in msg
    if knob == "REPRO_SWEEP_DEVICES":
        assert "outside 1..1" in _raised(lambda: partition.sweep_devices(CPU))


@pytest.mark.parametrize("shape,world", [((4, 1), 4), ((2, 2), 4),
                                         ((1, 4), 4), ((2, 1), 4),
                                         ((1, 1), 2)])
@pytest.mark.parametrize("n_lanes,n_seeds", [(4, 4), (8, 2), (4, 1)])
def test_blocks_cover_the_grid_and_gather_back(monkeypatch, shape, world,
                                               n_lanes, n_seeds):
    """Every rank's lane/seed block of a padded batch, its agent cells, and
    `host_fetch` of the blocks (grid and flat-cell leaves; ranks past the
    mesh send none) give back exactly the whole."""
    dl, ds = shape
    L = partition.padded_lane_count(n_lanes, _mesh(shape, 0, world))
    S = partition.padded_seed_count(n_seeds, _mesh(shape, 0, world))
    rng = np.random.default_rng(L * 10 + S)
    batch = {"dest": rng.integers(0, 99, (L, 5)).astype(np.int32),
             "ep_seed": rng.integers(0, 99, (L, S, 3)).astype(np.uint32)}
    cells = np.arange(L * S * 2, dtype=np.float32).reshape(L * S, 2)
    sent = {"grid": [], "flat": []}
    held = []
    for r in range(world):
        mesh = _mesh(shape, r, world)
        blk = partition.shard_group_batch(batch, mesh, torch.device(CPU))
        idx = partition.local_cells(mesh, L, S)
        agent = partition.shard_agent_batch(list(cells), mesh, L, S)
        if r >= dl * ds:
            assert blk is None and idx == [] and agent is None
            for k in sent:
                sent[k].append((None, None))
            continue
        pl, ps = mesh.coord
        assert blk["dest"].shape[0] == L // dl
        assert tuple(blk["ep_seed"].shape[:2]) == (L // dl, S // ds)
        assert np.array_equal(np.stack(agent), cells[idx])
        held += idx
        sent["grid"].append((mesh.coord, {"s": blk["ep_seed"].numpy()}))
        sent["flat"].append((mesh.coord, {"w": np.stack(agent)}))
    assert sorted(held) == list(range(L * S))
    # every rank reassembles the whole from the same gather
    for r in range(world):
        mesh = _mesh(shape, r, world)
        monkeypatch.setattr(partition, "_all_gather",
                            lambda obj: sent["grid"])
        got = partition.host_fetch(None, mesh)["s"]
        assert got.dtype == batch["ep_seed"].dtype
        assert np.array_equal(got, batch["ep_seed"])
        monkeypatch.setattr(partition, "_all_gather",
                            lambda obj: sent["flat"])
        assert np.array_equal(
            partition.host_fetch(None, mesh, seeds=S // ds)["w"], cells)


def _mesh(shape, rank, world):
    return partition.RankMesh(shape=shape, rank=rank, world=world,
                              device=torch.device(CPU), n_hosts=1)


_DIES = """
import os, sys
from repro_torch.nmp import partition
from repro_torch.nmp.config import NMPConfig
from repro_torch.nmp.scenarios import Scenario
from repro_torch.nmp.sweep import run_grid
from repro_torch.nmp.traces import make_trace
partition.maybe_init_distributed()
if os.environ["REPRO_DIST_RANK"] == "1":
    raise SystemExit("rank 1 fails before the sweep")
run_grid([Scenario(name="a", trace=make_trace("KM", n_ops=256))] * 2,
         NMPConfig(), device="cpu")
"""


def test_a_rank_that_fails_fails_every_rank():
    """Rank 1 exits before the sweep: rank 0's first gather raises (the
    peer's connection closes), so both processes exit non-zero, well inside
    the gather's timeout."""
    import subprocess
    import sys
    import time
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env.update(REPRO_DIST_COORD=f"127.0.0.1:{_port()}",
               REPRO_DIST_NPROCS="2",
               PYTHONPATH=os.pathsep.join([src, env.get("PYTHONPATH", "")]))
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", _DIES],
                              env=dict(env, REPRO_DIST_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode != 0 for p in procs] == [True, True]
    assert "Connection closed by peer" in outs[0][1], outs[0][1][-2000:]
    assert time.monotonic() - t0 < partition.DIST_TIMEOUT_S
