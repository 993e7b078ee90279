"""One AIMM episode of the PyTorch port (CPU, plain torch) against the live
JAX reference `repro.nmp.engine.run_episode`: the deterministic golden cells
of tests/test_engine_golden.py on the KM/384 trace at seed 2 (the
reference's GOLDEN table is not read: the live run is the bar), plus
learned-AIMM episodes.

Bars: `ops`, `mean_hops`, `migrations` and per-epoch `action`, `invoke`,
`valid`, `util` exact; `cycles` and `opc` (summary and per epoch) `==` as
well.  Eager torch does not contract a*b+c into an FMA as XLA's CPU backend
does; the one contraction on the cycles path is mirrored in the port
(engine `_fma`), which is what makes `==` hold.  The random streams are the
reference's threefry keys (core/prng.py), so forced actions 1 and 3 (the
NEAR actions' neighbour draw) and learned AIMM (exploration, replay
samples) are held `==` too; the bar is the reference's live output, not its
drifted GOLDEN table.  Regression cells: other topologies, the 8x8 mesh and
a 32-entry page cache here; the other apps and forced actions in
test_torch_episode_spmv.py, with the SPMV/2048 cells.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import agent as j_agent
from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp.engine import default_agent_cfg as j_default_agent_cfg
from repro.nmp.engine import run_episode as j_run_episode
from repro.nmp.stats import summarize as j_summarize
from repro_torch.core import agent as t_agent
from repro_torch.core.actions import N_ACTIONS
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.engine import run_episode, run_program
from repro_torch.nmp.stats import summarize
from repro_torch.nmp.traces import make_trace

APP, N_OPS = "KM", 384
CELLS = [(t, m, -1) for t in ("bnmp", "ldb", "pei") for m in ("none", "tom")]
CELLS.append(("pei", "aimm", 5))
# the two actions that draw a random neighbour from the env's key
NEAR_CELLS = [(t, "aimm", a) for t in ("bnmp", "ldb", "pei") for a in (1, 3)]
# regression configs: interconnects, the paper's 8x8 scalability mesh, and
# the smallest page-cache sensitivity point
CONFIGS = [dict(topology="torus2d"), dict(topology="ring"),
           dict(topology="dragonfly"), dict(mesh_x=8, mesh_y=8),
           dict(page_cache_entries=32)]


def _compare_cell(app, n_ops, tech, mapper, forced, seed=2, **cfg):
    ref = j_run_episode(j_make_trace(app, n_ops=n_ops), JCfg(**cfg), tech,
                        mapper, seed=seed, forced_action=forced)
    got = run_episode(make_trace(app, n_ops=n_ops), TCfg(**cfg), tech,
                      mapper, seed=seed, forced_action=forced, device="cpu")
    js, ts = j_summarize(ref), summarize(got)
    for k in ("ops", "mean_hops", "migrations", "cycles", "opc",
              "compute_util", "frac_pages_migrated"):
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert ts["ops"] == n_ops
    assert set(got.metrics) == set(ref.metrics)
    for k in ref.metrics:
        np.testing.assert_array_equal(got.metrics[k].numpy(),
                                      np.asarray(ref.metrics[k]), err_msg=k)


@pytest.mark.parametrize("tech,mapper,forced", CELLS,
                         ids=lambda v: str(v))
def test_deterministic_cell_matches_reference(tech, mapper, forced):
    _compare_cell(APP, N_OPS, tech, mapper, forced)


@pytest.mark.parametrize("tech,mapper,forced", NEAR_CELLS,
                         ids=lambda v: str(v))
def test_near_action_cell_matches_reference(tech, mapper, forced):
    _compare_cell(APP, N_OPS, tech, mapper, forced)


@pytest.mark.parametrize("cell", [("pei", "tom", -1), ("ldb", "aimm", 1)],
                         ids=lambda v: "/".join(map(str, v)))
@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in
                                                c.items()))
def test_regression_config_cell_matches_reference(cfg, cell):
    _compare_cell(APP, N_OPS, *cell, **cfg)


def test_learned_aimm_episode_runs_and_is_reproducible():
    tr = make_trace(APP, n_ops=N_OPS)
    a = run_episode(tr, TCfg(), "bnmp", "aimm", seed=5, device="cpu")
    b = run_episode(tr, TCfg(), "bnmp", "aimm", seed=5, device="cpu")
    s = summarize(a)
    assert s["ops"] == N_OPS and np.isfinite(s["cycles"])
    acts = a.metrics["action"]
    assert ((acts >= 0) & (acts < N_ACTIONS)).all()
    assert torch.equal(acts, b.metrics["action"])
    assert torch.equal(a.metrics["cycles"], b.metrics["cycles"])
    for k in a.agent.params:
        assert torch.equal(a.agent.params[k], b.agent.params[k])
    assert int(a.agent.step[0]) == int(a.metrics["invoke"].sum())


def test_run_program_keeps_the_dnn_between_episodes():
    res = run_program(make_trace("SPMV", n_ops=1024), TCfg(), "bnmp", "aimm",
                      episodes=3, seed=1, device="cpu")
    steps = [int(r.agent.global_step[0]) for r in res]
    assert steps == sorted(steps) and steps[0] > 0
    assert int(res[-1].agent.replay.size[0]) > int(res[0].agent.replay.size[0])
    assert all(summarize(r)["ops"] == 1024 for r in res)


def _learned_episode(app, n_ops, seed, explore):
    """Both packages start from the reference's cold-start agent (weights,
    moments, replay and key): every epoch's action, invoke, valid and util,
    and the episode's cycles, agree over the whole episode, NEAR actions
    included (the neighbour and exploration draws come from the same
    keys)."""
    jag = j_agent.cold_start(seed, j_default_agent_cfg(JCfg()))
    ref = j_run_episode(j_make_trace(app, n_ops=n_ops), JCfg(), "bnmp",
                        "aimm", agent=jag, seed=seed, explore=explore)
    tag = t_agent.import_agent(j_agent.export_agent(jag), device="cpu")
    got = run_episode(make_trace(app, n_ops=n_ops), TCfg(), "bnmp", "aimm",
                      agent=tag, seed=seed, explore=explore, device="cpu")
    assert int(got.agent.train_steps[0]) == int(ref.agent.train_steps)
    for k in ("action", "invoke", "valid", "util"):
        np.testing.assert_array_equal(got.metrics[k].numpy(),
                                      np.asarray(ref.metrics[k]), err_msg=k)
    assert float(got.env.cycles) == float(ref.env.cycles)
    assert np.array_equal(got.agent.rng[0].numpy(),
                          np.asarray(ref.agent.rng).astype(np.int64))


LEARNED = [("KM", 384, 0), ("KM", 2048, 5), ("SPMV", 2048, 1)]


@pytest.mark.parametrize("app,n_ops,seed", LEARNED)
def test_greedy_learned_episode_follows_reference_weights(app, n_ops, seed):
    """Teacher forcing, exploration off, over the whole episode."""
    _learned_episode(app, n_ops, seed, explore=False)


@pytest.mark.parametrize("app,n_ops,seed", LEARNED)
def test_exploring_learned_episode_follows_reference(app, n_ops, seed):
    """The same with exploration on: the epsilon draws and random actions
    are the reference's too."""
    _learned_episode(app, n_ops, seed, explore=True)
