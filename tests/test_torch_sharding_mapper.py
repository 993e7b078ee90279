"""The port's AIMM sharding mapper (`repro_torch/core/sharding_mapper.py`)
on the CPU against the live JAX reference.

The reference's peaks and per-chip memory are passed in as the port's
`Chip` record, built here from the reference's constants, so the port
carries only the H100's.  Bars:
  * every `CostModel` term, `step_s`, `objective` and the state vector
    `==` for every arch x the 144 knob settings x three meshes;
    `exhaustive_best` `==`;
  * `search` (60 steps, seed 0) for jamba-1.5-large-398b and qwen3-32b:
    every step's knobs and step time `==`.  Both start from the
    reference's initial agent, carried across (`import_agent`), as
    tests/test_torch_episode_km.py carries agents: the port's `normal`
    init is within 3 ulp of the reference's, and that stays out of the
    comparison;
  * the reference tests' bars with the H100 record; jamba's OOM escape
    on (8, 8), since its starting mapping fits 80 GB on (16, 16).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import agent as j_agent
from repro.core import sharding_mapper as j_sm
from repro.launch import roofline as j_rf
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import agent as t_agent
from repro_torch.core import sharding_mapper as sm
from repro_torch.launch.roofline import H100, Chip

REF = Chip(name="reference", peak_flops=j_rf.PEAK_FLOPS, hbm_bw=j_rf.HBM_BW,
           hbm_bytes=j_sm.HBM_PER_CHIP, link_bw=j_rf.ICI_BW)
MESHES = [(16, 16), (8, 8), (1, 8)]
TERMS = ("hbm_per_chip", "compute_s", "memory_s", "collective_s", "step_s",
         "objective")
TRAIN = "train_4k"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small eager ops: one intra-op thread takes the
    same wall time here and leaves the other cores to the other test
    workers, where more threads only spin on such small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knobs():
    return list(itertools.product(sm.MB_LADDER, sm.REMAT_LADDER,
                                  (False, True), (False, True),
                                  (False, True)))


def test_constants_match():
    assert (sm.MB_LADDER, sm.REMAT_LADDER, sm.REMAT_FLOPS, sm.REMAT_ACT_MEM,
            sm.ACT_IO_PASSES, sm.N_ACTIONS, sm.STATE_DIM) == (
        j_sm.MB_LADDER, j_sm.REMAT_LADDER, j_sm.REMAT_FLOPS,
        j_sm.REMAT_ACT_MEM, j_sm.ACT_IO_PASSES, j_sm.N_ACTIONS,
        j_sm.STATE_DIM)
    assert sm.Knobs().__dict__ == j_sm.Knobs().__dict__
    assert len(_knobs()) == 144


@pytest.mark.parametrize("arch", J_ARCHS)
def test_cost_model_terms_and_exhaustive_equal(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh in MESHES:
        cm = sm.CostModel(cfg, SHAPES[TRAIN], mesh, REF)
        jcm = j_sm.CostModel(jcfg, J_SHAPES[TRAIN], mesh)
        assert (cm.chips, cm.model_par, cm.data_par, cm.N, cm.Na, cm.mf) == (
            jcm.chips, jcm.model_par, jcm.data_par, jcm.N, jcm.Na, jcm.mf)
        for kn in _knobs():
            k, jk = sm.Knobs(*kn), j_sm.Knobs(*kn)
            for term in TERMS:
                assert getattr(cm, term)(k) == getattr(jcm, term)(jk), (
                    mesh, kn, term)
            np.testing.assert_array_equal(
                sm._state_vec(cm, k, "cpu")[0].numpy(),
                np.asarray(j_sm._state_vec(jcm, jk)))
            for a in range(sm.N_ACTIONS):
                assert (sm._apply_action(k, a).__dict__
                        == j_sm._apply_action(jk, a).__dict__)
        best, t = sm.exhaustive_best(cfg, SHAPES[TRAIN], mesh, REF)
        jbest, jt = j_sm.exhaustive_best(jcfg, J_SHAPES[TRAIN], mesh)
        assert t == jt, (mesh, t, jt)
        if jbest is None:       # nothing fits the mesh
            assert best is None and t == float("inf")
        else:
            assert best.__dict__ == jbest.__dict__, (mesh, best, jbest)


def _reference_initial_agent(monkeypatch):
    """Make the port's search start from the reference's initial agent:
    `init_agent(PRNGKey(seed))` of the reference, imported."""
    def init_agent(key, acfg, n_agents=1, device="cuda"):
        assert n_agents == 1
        jcfg = j_agent.AgentConfig(
            dqn=j_sm.DQNConfig(state_dim=acfg.dqn.state_dim,
                               n_actions=acfg.dqn.n_actions,
                               gamma=acfg.dqn.gamma),
            eps_start=acfg.eps_start, eps_decay=acfg.eps_decay,
            min_replay=acfg.min_replay)
        assert jcfg == j_agent.AgentConfig(
            dqn=j_sm.DQNConfig(state_dim=24, n_actions=8, gamma=0.0),
            eps_start=0.5, eps_decay=80, min_replay=16)
        seed = int(key.cpu()[1])
        jag = j_agent.init_agent(jax.random.PRNGKey(seed), jcfg)
        return t_agent.import_agent(j_agent.export_agent(jag),
                                    device=device)
    monkeypatch.setattr(sm.agent_mod, "init_agent", init_agent)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen3-32b"])
def test_search_trajectory_equal(arch, monkeypatch):
    _reference_initial_agent(monkeypatch)
    want = j_sm.search(j_get_config(arch), J_SHAPES[TRAIN], steps=60, seed=0)
    got = sm.search(get_config(arch), SHAPES[TRAIN], steps=60, seed=0,
                    chip=REF, device="cpu")
    assert len(got.trajectory) == len(want.trajectory) == 61
    for i, ((k, t), (jk, jt)) in enumerate(zip(got.trajectory,
                                               want.trajectory)):
        assert k.__dict__ == jk.__dict__ and t == jt, i
    assert got.best.__dict__ == want.best.__dict__
    assert (got.best_step_s, got.baseline_step_s) == (want.best_step_s,
                                                      want.baseline_step_s)


def test_search_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        sm.search(get_config("qwen3-32b"), SHAPES[TRAIN], steps=1)


# ---- the reference tests' bars, with the H100 record ----

def test_cost_model_feasibility_on_the_card():
    """At 80 GB a card the naive jamba mapping still fits on (16, 16); on
    (8, 8) it cannot, and the fitted one can."""
    cfg = get_config("jamba-1.5-large-398b")
    naive = sm.Knobs(microbatches=8, remat="full", fsdp=False,
                     quant_opt=False)
    fitted = sm.Knobs(microbatches=16, remat="full", fsdp=True,
                      quant_opt=True)
    wide = sm.CostModel(cfg, SHAPES[TRAIN])
    assert wide.chip == H100 and wide.step_s(naive) < float("inf")
    cm = sm.CostModel(cfg, SHAPES[TRAIN], (8, 8))
    assert cm.hbm_per_chip(naive) > H100.hbm_bytes
    assert cm.step_s(naive) == float("inf")
    assert cm.step_s(fitted) < float("inf")


def test_tp_in_expert_penalty_on_the_card():
    cm = sm.CostModel(get_config("deepseek-moe-16b"), SHAPES[TRAIN])
    assert cm.collective_s(sm.Knobs(moe_ep=False)) > 3 * cm.collective_s(
        sm.Knobs(moe_ep=True))


def test_exhaustive_respects_the_card_memory():
    for arch in ("qwen3-32b", "mixtral-8x22b"):
        for mesh in ((16, 16), (8, 8)):
            cm = sm.CostModel(get_config(arch), SHAPES[TRAIN], mesh)
            best, t = sm.exhaustive_best(get_config(arch), SHAPES[TRAIN],
                                         mesh)
            assert t < float("inf")
            assert cm.hbm_per_chip(best) <= H100.hbm_bytes


def test_search_on_the_card_record_meets_the_reference_bars():
    """qwen3-32b within 1.3x of its optimum (250 steps, the reference
    test's); jamba on (8, 8) leaves the OOM plateau with FSDP and int8
    moments (150 steps, the reference test's)."""
    cfg = get_config("qwen3-32b")
    gt, gt_t = sm.exhaustive_best(cfg, SHAPES[TRAIN])
    res = sm.search(cfg, SHAPES[TRAIN], steps=250, seed=0, device="cpu")
    assert res.best_step_s <= gt_t * 1.3, (res.best, gt)
    res = sm.search(get_config("jamba-1.5-large-398b"), SHAPES[TRAIN],
                    (8, 8), steps=150, seed=0, device="cpu")
    assert res.baseline_step_s == float("inf")
    assert res.best_step_s < float("inf")
    assert res.best.fsdp and res.best.quant_opt
