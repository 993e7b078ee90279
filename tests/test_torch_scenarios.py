"""The batched engine's inputs in the PyTorch port (`nmp/scenarios.py`,
`configs/aimm_nmp.py`) and the single-lane helpers it adds
(`traces.merge_traces`/`program_of_page`/`analyze`,
`paging.hoard_alloc`/`random_alloc`, `stats.resample_opc`/`opc_timeline`,
`topology.hop_count`/`link_loads`) against the live JAX reference, on the
CPU.  Bar: `==` everywhere (host-side numpy, integer gathers, and link
loads of flit-count weights, which are exact in any summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import aimm_nmp as j_presets
from repro.nmp import NMPConfig as JCfg
from repro.nmp import paging as j_paging
from repro.nmp import scenarios as j_sc
from repro.nmp import stats as j_stats
from repro.nmp import topology as j_topo
from repro.nmp import traces as j_traces
from repro.nmp.engine import run_episode as j_run_episode
from repro_torch.configs import aimm_nmp as t_presets
from repro_torch.nmp import paging as t_paging
from repro_torch.nmp import scenarios as t_sc
from repro_torch.nmp import stats as t_stats
from repro_torch.nmp import topology as t_topo
from repro_torch.nmp import traces as t_traces
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.engine import run_episode

FIELDS = ("name", "technique", "mapper", "seed", "episodes", "eval_episode",
          "forced_action", "lineage", "topology")


def _same_trace(a, b):
    assert (a.name, a.n_pages, a.n_ops, a.iter_ops) == (b.name, b.n_pages,
                                                        b.n_ops, b.iter_ops)
    for k in ("dest", "src1", "src2", "read_write", "program_id"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def _same_grid(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        assert g.total_episodes == w.total_episodes
        assert (g.page_table is None) == (w.page_table is None)
        if w.page_table is not None:
            assert np.array_equal(g.page_table, w.page_table)
        _same_trace(g.trace, w.trace)
    # seed folding keys on trace identity: the same sharing pattern
    fold = lambda grid: [[j for j, o in enumerate(grid)
                          if o.fold_key()[1:] == s.fold_key()[1:]
                          and o.trace is s.trace] for s in grid]
    assert fold(got) == fold(want)


BUILDS = [
    ("single", dict(apps=("KM", "SPMV"), techniques=("bnmp", "pei"),
                    n_ops=512, seeds=(0, 1), aimm_episodes=3,
                    eval_episode=True)),
    ("multi", dict(n_ops_per_app=256, aimm_episodes=2, seeds=(0, 3))),
    ("ablation", dict(app="KM", n_ops=384, seeds=(0, 1))),
    ("topology", dict(apps=("KM", "RBM"), n_ops=256, aimm_episodes=2,
                      eval_episode=True)),
]


@pytest.mark.parametrize("name,kw", BUILDS, ids=[b[0] for b in BUILDS])
def test_grid_builders_match_reference(name, kw):
    _same_grid(t_sc.build(name, **kw), j_sc.build(name, **kw))


@pytest.mark.parametrize("name,kw", [
    ("switch", dict(n_ops_per_app=256, episodes=2)),
    ("switch", dict(n_ops_per_app=256, lineage=None,
                    include_baseline=False, interleave=7)),
    ("tenant", dict(apps=("KM", "SC", "PR"), n_phases=4, n_ops_per_app=128,
                    lineage="t0", seed=3))], ids=["switch", "switch-cold",
                                                  "tenant"])
def test_stream_builders_match_reference(name, kw):
    got, want = t_sc.build_stream(name, **kw), j_sc.build_stream(name, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_grid(g, w)


def test_tenant_fleet_and_seed_variants_match_reference():
    got = t_sc.tenant_fleet(n_tenants=3, n_phases=2, n_ops_per_app=128)
    want = j_sc.tenant_fleet(n_tenants=3, n_phases=2, n_ops_per_app=128)
    assert list(got) == list(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            _same_grid(g, w)
    tr, jtr = t_traces.make_trace("KM", 256), j_traces.make_trace("KM", 256)
    _same_grid(t_sc.seed_variants(t_sc.Scenario("a", tr, mapper="aimm"),
                                  (4, 1, 9)),
               j_sc.seed_variants(j_sc.Scenario("a", jtr, mapper="aimm"),
                                  (4, 1, 9)))
    assert set(t_sc.GRIDS) == set(j_sc.GRIDS)
    assert set(t_sc.STREAMS) == set(j_sc.STREAMS)


def test_presets_match_reference():
    for k in ("PAPER_4X4", "PAPER_8X8"):
        assert (str(getattr(t_presets, k)).replace("repro_torch", "repro")
                == str(getattr(j_presets, k)))
    assert t_presets.PAGE_CACHE_SWEEP == j_presets.PAGE_CACHE_SWEEP
    assert t_presets.NMP_TABLE_SWEEP == j_presets.NMP_TABLE_SWEEP


@pytest.mark.parametrize("apps,interleave", [(("KM", "SC"), 32),
                                             (("LUD", "RBM", "SPMV"), 7),
                                             (("MAC",), 32)])
def test_merge_traces_program_of_page_analyze(apps, interleave):
    n = (300, 512, 128)
    got = t_traces.merge_traces([t_traces.make_trace(a, n_ops=m)
                                 for a, m in zip(apps, n)], interleave)
    want = j_traces.merge_traces([j_traces.make_trace(a, n_ops=m)
                                  for a, m in zip(apps, n)], interleave)
    _same_trace(got, want)
    assert np.array_equal(t_traces.program_of_page(got),
                          j_traces.program_of_page(want))
    assert t_traces.analyze(got) == j_traces.analyze(want)
    assert t_traces.analyze(got, epoch=97) == j_traces.analyze(want, 97)


@pytest.mark.parametrize("n_cubes_cfg", [dict(), dict(mesh_x=8, mesh_y=8)],
                         ids=["4x4", "8x8"])
def test_allocators_match_reference(n_cubes_cfg):
    tcfg, jcfg = TCfg(**n_cubes_cfg), JCfg(**n_cubes_cfg)
    tr = t_traces.merge_traces([t_traces.make_trace(a, n_ops=256)
                                for a in ("KM", "SC", "RD")])
    owner = t_traces.program_of_page(tr)
    assert np.array_equal(t_paging.hoard_alloc(tr.n_pages, tcfg, owner),
                          j_paging.hoard_alloc(tr.n_pages, jcfg, owner))
    gap = np.where(owner == 1, 3, owner)           # a program id gap
    many = np.arange(tr.n_pages) % 40              # more programs than cubes
    for own in (gap, many):
        assert np.array_equal(t_paging.hoard_alloc(tr.n_pages, tcfg, own),
                              j_paging.hoard_alloc(tr.n_pages, jcfg, own))
    assert t_paging.hoard_alloc(0, tcfg, np.zeros(0, np.int32)).size == 0
    with pytest.raises(ValueError, match="one owner per page"):
        t_paging.hoard_alloc(5, tcfg, np.zeros(4, np.int32))
    for seed in (0, 7):
        assert np.array_equal(t_paging.random_alloc(300, tcfg, seed),
                              j_paging.random_alloc(300, jcfg, seed))


def test_resample_opc_and_opc_timeline_match_reference():
    rng = np.random.default_rng(1)
    opc = rng.random(40).astype(np.float32)
    valid = (rng.random(40) < 0.7).astype(np.float32)
    for samples in (8, 64):
        assert np.array_equal(
            t_stats.resample_opc(torch.from_numpy(opc),
                                 torch.from_numpy(valid), samples),
            j_stats.resample_opc(opc, valid, samples))
    assert np.array_equal(t_stats.resample_opc(opc, 0 * valid),
                          j_stats.resample_opc(opc, 0 * valid))
    tr, jtr = t_traces.make_trace("SPMV", 1024), j_traces.make_trace("SPMV",
                                                                     1024)
    got = t_stats.opc_timeline(run_episode(tr, TCfg(), "pei", "tom",
                                           device="cpu"), 32)
    want = j_stats.opc_timeline(j_run_episode(jtr, JCfg(), "pei", "tom"), 32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["mesh2d", "torus2d", "ring", "dragonfly"])
def test_hop_count_and_link_loads_match_reference(name):
    tt, jt = (t_topo.get_topology(TCfg(topology=name)),
              j_topo.get_topology(JCfg(topology=name)))
    rng = np.random.default_rng(len(name))
    C = jt.n_cubes
    a, b = (rng.integers(0, C, 200).astype(np.int32) for _ in range(2))
    w = rng.integers(0, 9, 200).astype(np.float32)
    assert np.array_equal(
        t_topo.hop_count(tt, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_topo.hop_count(jt, jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(
        t_topo.link_loads(tt, torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(w)).numpy(),
        np.asarray(j_topo.link_loads(jt, jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(w))))
