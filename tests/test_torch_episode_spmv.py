"""The deterministic golden cells on the SPMV/2048 trace (16 epochs, long
enough for TOM to profile and commit), the NEAR-action cells, and the
regression cells of the other apps and forced actions: the PyTorch port
(CPU, plain torch) against the live JAX `run_episode` at seed 2.  Bars and
their reasons as in test_torch_episode_km.py.
"""
import numpy as np
import pytest

from repro.nmp import NMPConfig as JCfg
from repro.nmp import make_trace as j_make_trace
from repro.nmp.engine import run_episode as j_run_episode
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.engine import run_episode
from repro_torch.nmp.traces import make_trace

from tests.test_torch_episode_km import CELLS, NEAR_CELLS, _compare_cell

APP, N_OPS = "SPMV", 2048


@pytest.mark.parametrize("tech,mapper,forced", CELLS,
                         ids=lambda v: str(v))
def test_deterministic_cell_matches_reference(tech, mapper, forced):
    _compare_cell(APP, N_OPS, tech, mapper, forced)


@pytest.mark.parametrize("tech,mapper,forced", NEAR_CELLS,
                         ids=lambda v: str(v))
def test_near_action_cell_matches_reference(tech, mapper, forced):
    _compare_cell(APP, N_OPS, tech, mapper, forced)


@pytest.mark.parametrize("app", ["BP", "LUD", "MAC", "PR", "RBM", "RD",
                                 "SC"])
def test_other_app_cell_matches_reference(app):
    """The apps the KM and SPMV cells do not cover, at 1024 ops."""
    _compare_cell(app, 1024, "pei", "tom", -1)


@pytest.mark.parametrize("action", [0, 2, 4, 6, 7])
def test_forced_action_cell_matches_reference(action):
    """The scripted actions without a random draw, on the KM/384 trace."""
    _compare_cell("KM", 384, ("bnmp", "ldb", "pei")[action % 3], "aimm",
                  action)


def test_tom_commits_the_reference_mapping():
    ref = j_run_episode(j_make_trace(APP, n_ops=N_OPS), JCfg(), "bnmp", "tom",
                        seed=2)
    got = run_episode(make_trace(APP, n_ops=N_OPS), TCfg(), "bnmp", "tom",
                      seed=2, device="cpu")
    assert int(got.env.tom_active) == int(ref.env.tom_active) >= 0
    np.testing.assert_array_equal(got.env.tom_scores.numpy(),
                                  np.asarray(ref.env.tom_scores))


def test_final_state_tables_match_reference():
    """The scripted-AIMM cell's final page table, compute-remap table,
    row-buffer stamps, access EMA and page-info cache tags."""
    ref = j_run_episode(j_make_trace(APP, n_ops=N_OPS), JCfg(), "pei", "aimm",
                        seed=2, forced_action=5)
    got = run_episode(make_trace(APP, n_ops=N_OPS), TCfg(), "pei", "aimm",
                      seed=2, forced_action=5, device="cpu")
    for k in ("page_to_cube", "compute_remap", "rb_stamp", "page_access_ema",
              "remap_age", "recent_pages", "mig_page_mask", "energy"):
        np.testing.assert_array_equal(getattr(got.env, k).numpy(),
                                      np.asarray(getattr(ref.env, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(got.env.cache.tag.numpy(),
                                  np.asarray(ref.env.cache.tag))
    np.testing.assert_array_equal(got.env.cache.freq.numpy(),
                                  np.asarray(ref.env.cache.freq))
