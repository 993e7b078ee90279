"""The port's fused epoch core (repro_torch.kernels.epoch_fused, CPU path =
plain torch) against the JAX reference's stage dispatchers, in all three
call shapes (shared only, route only, both fused) and the TOM scorer, alone
and folded into the shared stage (`tom_cands`).

The reference runs through its own CPU paths: `backend="jnp"` and the
Pallas kernel in interpret mode (`"pallas_interpret"`), under `jax.jit` as
the engine runs them.  Every output is held with `np.array_equal`: the
stage contract is exact (every reduction sums exact small integers in f32,
the EMA gets +1.0 one access at a time).  Inputs are numpy, made from a
seed, from real trace windows: BP (P = 4096, the largest page table) on the
jnp path, KM (P = 512) on the interpreted kernel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.epoch_fused import ops as j_ops
from repro.nmp.config import NMPConfig as JCfg
from repro.nmp.engine import pei_hot_index, pei_top_k
from repro.nmp.topology import get_topology
from repro.nmp.traces import make_trace
from repro_torch.kernels.epoch_fused import ops as t_ops
from repro_torch.nmp.baselines import tom_candidates
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.topology import topology_tensors

CPU = torch.device("cpu")
CFG = JCfg()
W = CFG.w_max
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
FLAG_IDS = ["plain", "pei", "aimm", "pei+aimm"]
BACKEND_APP = [("jnp", "BP", 16384), ("pallas_interpret", "KM", 2048)]


def _inputs(app: str, n_ops: int, seed: int, n_valid: int = W) -> dict:
    """One realistic epoch's inputs (numpy), window at a seeded offset."""
    rng = np.random.default_rng(seed)
    tr = make_trace(app, n_ops=n_ops)
    P, C, L = tr.n_pages, CFG.n_cubes, get_topology(CFG).n_links
    start = int(rng.integers(0, n_ops - W)) // W * W
    sl = slice(start, start + W)
    epochs = np.float32(start // W)
    # access EMAs with many exact ties (the top_k threshold must pick the
    # m-th largest counting duplicates)
    ema = rng.choice(np.array([0.0, 0.9, 1.0, 1.81, 2.0, 3.439], np.float32),
                     P) + (rng.random(P) < 0.2) * rng.random(P).astype(
                         np.float32)
    remap = np.where(rng.random(P) < 0.7, -1,
                     rng.integers(0, C + 1, P)).astype(np.int32)
    pending = np.where(rng.random(L) < 0.3, 256.0, 0.0).astype(np.float32)
    return dict(
        dest=tr.dest[sl], src1=tr.src1[sl], src2=tr.src2[sl],
        valid=(np.arange(W) < n_valid).astype(np.float32),
        epochs=epochs,
        rb_stamp=rng.integers(0, (int(epochs) + 1) * 3 * W, P + 1
                              ).astype(np.int32),
        page_ema=ema.astype(np.float32), n_pages=np.int32(P),
        pei_idx=np.int32(pei_hot_index(P, CFG)), pei_k=pei_top_k(P, CFG),
        eff_table=rng.integers(0, C, P).astype(np.int32),
        compute_remap=remap, pending=pending)


def _b(a, dtype=None):
    """numpy -> torch with a lane axis of 1."""
    t = torch.from_numpy(np.array(a, copy=True))[None]
    return t if dtype is None else t.to(dtype)


def _eq(got: torch.Tensor, want, name):
    want = np.asarray(want)
    got = got.numpy()[0]
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.array_equal(got.astype(want.dtype), want), name


def _shared_eq(got, want):
    """The port's SharedParts against the reference's, field by field.  The
    reference's has no tom_scores field (its SharedEpoch carries them); the
    port's is None where the call had no tom_cands."""
    assert got.tom_scores is None
    for f in want._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            _eq(getattr(got, f), getattr(want, f), f)


def _j_shared(x, pei, aimm, backend):
    fn = jax.jit(functools.partial(j_ops.shared_parts,
                                   pei_k=x["pei_k"] if pei else 0, aimm=aimm,
                                   backend=backend))
    return fn(x["dest"], x["src1"], x["src2"], x["valid"], x["epochs"],
              x["rb_stamp"], x["page_ema"], x["n_pages"], x["pei_idx"])


def _t_shared(x, pei, aimm, **tom):
    return t_ops.shared_parts(
        _b(x["dest"]), _b(x["src1"]), _b(x["src2"]), _b(x["valid"]),
        _b(x["epochs"]), _b(x["rb_stamp"]), _b(x["page_ema"]),
        _b(x["n_pages"]), _b(x["pei_idx"]), pei_k=x["pei_k"] if pei else 0,
        aimm=aimm, **tom)


def _t_fused(x, pei, aimm, tech, is_aimm, **tom):
    return t_ops.fused_parts(
        _b(x["dest"]), _b(x["src1"]), _b(x["src2"]), _b(x["valid"]),
        _b(x["epochs"]), _b(x["rb_stamp"]), _b(x["page_ema"]),
        _b(x["n_pages"]), _b(x["pei_idx"]), _b(x["eff_table"]),
        _b(x["compute_remap"]), _b(tech), _b(np.bool_(is_aimm)),
        _b(x["pending"]), topology_tensors(TCfg(), CPU),
        pei_k=x["pei_k"] if pei else 0, aimm=aimm, n_mcs=CFG.n_mcs,
        packet_flits=CFG.packet_flits, **tom)


@pytest.mark.parametrize("pei,aimm", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("backend,app,n_ops", BACKEND_APP,
                         ids=[b for b, _, _ in BACKEND_APP])
def test_shared_stage_equal(backend, app, n_ops, pei, aimm):
    x = _inputs(app, n_ops, seed=1)
    want = _j_shared(x, pei, aimm, backend)
    got = _t_shared(x, pei, aimm)
    _shared_eq(got, want)


def test_shared_stage_partial_window_and_threshold_ties():
    """A window with invalid tail ops and an EMA that is all ties."""
    x = _inputs("BP", 16384, seed=2, n_valid=37)
    x["page_ema"] = np.full_like(x["page_ema"], 0.9)
    want = _j_shared(x, True, True, "jnp")
    got = _t_shared(x, True, True)
    _shared_eq(got, want)


def _route_inputs(x, pei, aimm, backend):
    sp = _j_shared(x, pei, True, backend)
    return sp.rb_winner, sp.pei_hot1, sp.pei_hot2


@pytest.mark.parametrize("technique", [0, 1, 2], ids=["bnmp", "ldb", "pei"])
@pytest.mark.parametrize("pei,aimm", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("backend,app,n_ops", BACKEND_APP,
                         ids=[b for b, _, _ in BACKEND_APP])
def test_route_stage_equal(backend, app, n_ops, pei, aimm, technique):
    x = _inputs(app, n_ops, seed=3 + technique)
    win, h1, h2 = _route_inputs(x, pei, aimm, backend)
    topo = get_topology(CFG)
    fn = jax.jit(functools.partial(
        j_ops.route_parts, topo=topo, pei_k=x["pei_k"] if pei else 0,
        aimm=aimm, n_mcs=CFG.n_mcs, packet_flits=CFG.packet_flits,
        backend=backend))
    want = fn(x["dest"], x["src1"], x["src2"], x["valid"], win,
              h1 if pei else None, h2 if pei else None, x["eff_table"],
              x["compute_remap"], np.int32(technique), np.bool_(True),
              x["pending"])
    got = t_ops.route_parts(
        _b(x["dest"]), _b(x["src1"]), _b(x["src2"]), _b(x["valid"]),
        _b(np.asarray(win)), _b(np.asarray(h1)) if pei else None,
        _b(np.asarray(h2)) if pei else None, _b(x["eff_table"]),
        _b(x["compute_remap"]), _b(np.int32(technique)), _b(np.bool_(True)),
        _b(x["pending"]), topology_tensors(TCfg(), CPU),
        pei_k=x["pei_k"] if pei else 0, aimm=aimm, n_mcs=CFG.n_mcs,
        packet_flits=CFG.packet_flits)
    for f in got._fields:
        _eq(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("is_aimm", [False, True], ids=["lane-off", "lane-on"])
@pytest.mark.parametrize("pei,aimm", FLAGS, ids=FLAG_IDS)
def test_fused_call_equal(pei, aimm, is_aimm):
    """Both stages in one call, against the reference's fused Pallas call
    (interpret mode)."""
    x = _inputs("KM", 2048, seed=9)
    topo = get_topology(CFG)
    tech = np.int32(2 if pei else 0)
    fn = jax.jit(functools.partial(
        j_ops.fused_parts, topo=topo, pei_k=x["pei_k"] if pei else 0,
        aimm=aimm, n_mcs=CFG.n_mcs, packet_flits=CFG.packet_flits,
        backend="pallas_interpret"))
    wsp, wrp = fn(x["dest"], x["src1"], x["src2"], x["valid"], x["epochs"],
                  x["rb_stamp"], x["page_ema"], x["n_pages"], x["pei_idx"],
                  x["eff_table"], x["compute_remap"], tech,
                  np.bool_(is_aimm), x["pending"])
    gsp, grp = _t_fused(x, pei, aimm, tech, is_aimm)
    _shared_eq(gsp, wsp)
    for f in grp._fields:
        _eq(getattr(grp, f), getattr(wrp, f), f)


def test_three_call_shapes_agree():
    """fused == shared then route, inside the port (the TOM scores of the
    shared stage included)."""
    x = _inputs("BP", 16384, seed=5)
    topo = topology_tensors(TCfg(), CPU)
    cands = tom_candidates(int(x["n_pages"]), TCfg(), CPU)
    args = [_b(x[k]) for k in ("dest", "src1", "src2", "valid")]
    common = dict(pei_k=x["pei_k"], aimm=True)
    rt = dict(n_mcs=CFG.n_mcs, packet_flits=CFG.packet_flits)
    sp = t_ops.shared_parts(*args, _b(x["epochs"]), _b(x["rb_stamp"]),
                            _b(x["page_ema"]), _b(x["n_pages"]),
                            _b(x["pei_idx"]), **common, tom_cands=cands,
                            n_cubes=CFG.n_cubes)
    rest = (_b(x["eff_table"]), _b(x["compute_remap"]), _b(np.int32(2)),
            _b(np.bool_(True)), _b(x["pending"]), topo)
    rp = t_ops.route_parts(*args, sp.rb_winner, sp.pei_hot1, sp.pei_hot2,
                           *rest, **common, **rt)
    fsp, frp = t_ops.fused_parts(*args, _b(x["epochs"]), _b(x["rb_stamp"]),
                                 _b(x["page_ema"]), _b(x["n_pages"]),
                                 _b(x["pei_idx"]), *rest, **common, **rt,
                                 tom_cands=cands)
    for a, b in list(zip(sp, fsp)) + list(zip(rp, frp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_valid", [W, 50, 1], ids=["full", "partial",
                                                    "one"])
@pytest.mark.parametrize("backend,app,n_ops", BACKEND_APP,
                         ids=[b for b, _, _ in BACKEND_APP])
def test_tom_scores_equal(backend, app, n_ops, n_valid):
    from repro.nmp.baselines import tom_candidates
    x = _inputs(app, n_ops, seed=7, n_valid=n_valid)
    cands = np.asarray(tom_candidates(int(x["n_pages"]), CFG))
    fn = jax.jit(functools.partial(j_ops.tom_scores, n_cubes=CFG.n_cubes,
                                   backend=backend))
    want = fn(x["dest"], x["src1"], x["src2"], x["valid"], cands)
    got = t_ops.tom_scores(_b(x["dest"]), _b(x["src1"]), _b(x["src2"]),
                           _b(x["valid"]), torch.from_numpy(cands.copy()),
                           CFG.n_cubes)
    _eq(got, want, "tom_scores")


@pytest.mark.parametrize("call", ["shared", "fused"])
@pytest.mark.parametrize("n_valid", [W, 50, 1], ids=["full", "partial",
                                                    "one"])
@pytest.mark.parametrize("backend,app,n_ops", BACKEND_APP,
                         ids=[b for b, _, _ in BACKEND_APP])
def test_folded_tom_scores_equal(backend, app, n_ops, n_valid, call):
    """The TOM scores that the shared stage computes when it is given
    `tom_cands` (shared_parts or fused_parts) against the reference's
    tom_scores op, equal to the port's standalone op, with every other
    output of the stage as without TOM."""
    from repro.nmp.baselines import tom_candidates as j_tom_candidates
    x = _inputs(app, n_ops, seed=7, n_valid=n_valid)
    cands = np.asarray(j_tom_candidates(int(x["n_pages"]), CFG))
    fn = jax.jit(functools.partial(j_ops.tom_scores, n_cubes=CFG.n_cubes,
                                   backend=backend))
    want = fn(x["dest"], x["src1"], x["src2"], x["valid"], cands)
    tc = torch.from_numpy(cands.copy())
    if call == "shared":
        got = _t_shared(x, True, True, tom_cands=tc, n_cubes=CFG.n_cubes)
        base = _t_shared(x, True, True)
    else:
        tech = np.int32(2)
        got, grp = _t_fused(x, True, True, tech, True, tom_cands=tc)
        base, brp = _t_fused(x, True, True, tech, True)
        for a, b in zip(grp, brp):
            assert torch.equal(a, b)
    _eq(got.tom_scores, want, "tom_scores")
    alone = t_ops.tom_scores(_b(x["dest"]), _b(x["src1"]), _b(x["src2"]),
                             _b(x["valid"]), tc, CFG.n_cubes)
    assert torch.equal(got.tom_scores, alone)
    assert base.tom_scores is None
    for f in base._fields:
        if f != "tom_scores":
            assert torch.equal(getattr(got, f), getattr(base, f)), f


def test_folded_tom_needs_the_shared_stage_and_n_cubes():
    x = _inputs("KM", 2048, seed=3)
    cands = tom_candidates(int(x["n_pages"]), TCfg(), CPU)
    with pytest.raises(ValueError, match="n_cubes"):
        _t_shared(x, True, True, tom_cands=cands)
    with pytest.raises(ValueError, match="run_shared"):
        t_ops.fused_epoch_call(
            _b(x["dest"]), _b(x["src1"]), _b(x["src2"]), _b(x["valid"]),
            rb_winner=torch.zeros((1, 3 * W), dtype=torch.bool),
            eff_table=_b(x["eff_table"]), technique=_b(np.int32(0)),
            pending_mig_loads=_b(x["pending"]),
            topo=topology_tensors(TCfg(), CPU), run_shared=False,
            n_mcs=CFG.n_mcs, packet_flits=CFG.packet_flits, tom_cands=cands)
