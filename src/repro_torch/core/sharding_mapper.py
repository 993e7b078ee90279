"""AIMM retargeted at a training run's mapping knobs (port of
`repro/core/sharding_mapper.py`).

The paper's core idea, a continual dueling-DQN plugin that remaps data and
computation rewarded by system throughput, applied to the mapping problem
of a training run over a mesh of cards.  The environment is the analytic
roofline cost model over the knob space:

  state   : workload descriptors (params, tokens, arithmetic intensity) +
            current knob settings + the three roofline terms (normalized),
            the Fig.-3 analogue (system info + "page" info = mapping info)
  actions : (i) keep mapping, (ii/iii) microbatch up/down, (iv/v) remat
            up/down, (vi) toggle FSDP param sharding, (vii) toggle int8
            optimizer moments, (viii) toggle MoE expert parallelism
  reward  : +-1 on estimated-step-time improvement, with an HBM-capacity
            barrier (a mapping that doesn't fit is an immediate -1)

The cost model takes the card's peaks and memory from a `Chip` record
(`launch/roofline.py`, the H100 by default).  The same agent as the NMP
plugin (`core/agent.py`: dueling double DQN + replay) drives the search,
with one agent (G = 1): its Q inference is the `dueling_qnet` kernel, its
TD step the `batched_linear` kernels and every draw a `threefry` launch on
the card.  `search` reads the action back once a step, as the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core import agent as agent_mod
from repro_torch.core import prng
from repro_torch.core.agent import AgentConfig
from repro_torch.core.dqn import DQNConfig
from repro_torch.launch.memory_model import memory_bytes
from repro_torch.launch.roofline import H100, Chip
from repro_torch.models.model import count_params, model_flops

MB_LADDER = (1, 2, 4, 8, 16, 32)
REMAT_LADDER = ("none", "block", "full")
REMAT_FLOPS = {"none": 1.0, "block": 1.15, "full": 4.0 / 3.0}
# activation-residency fractions, the reference's calibration against its
# dry run's memory analysis (the original guesses made remat='none' look
# free at 398B)
REMAT_ACT_MEM = {"none": 1.0, "block": 0.3, "full": 0.12}
ACT_IO_PASSES = 16.0        # tensors/layer kept live without remat


@dataclasses.dataclass(frozen=True)
class Knobs:
    microbatches: int = 8
    remat: str = "full"
    fsdp: bool = False
    quant_opt: bool = False
    moe_ep: bool = True


class CostModel:
    """Analytic step-time estimate for (cfg, shape, mesh_shape) on `chip`."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg,
                 mesh_shape=(16, 16), chip: Chip = H100):
        self.cfg = cfg
        self.shape = shape
        self.chip = chip
        self.chips = int(np.prod(mesh_shape))
        self.model_par = mesh_shape[-1]
        self.data_par = self.chips // self.model_par
        self.N = count_params(cfg)
        self.Na = count_params(cfg, active_only=True)
        self.mf = model_flops(cfg, shape)

    def hbm_per_chip(self, k: Knobs) -> float:
        param_shards = self.model_par * (self.data_par if k.fsdp else 1)
        params = 2.0 * self.N / param_shards
        grads = 4.0 * self.N / self.chips           # ZeRO-sharded fp32
        opt = (2.0 if k.quant_opt else 8.0) * self.N / self.chips
        T = self.shape.global_batch * self.shape.seq
        act = (REMAT_ACT_MEM[k.remat] * T * self.cfg.d_model * 2.0
               * self.cfg.n_layers / max(k.microbatches, 1) / self.chips
               * ACT_IO_PASSES)
        return params + grads + opt + act

    def compute_s(self, k: Knobs) -> float:
        return (self.mf * REMAT_FLOPS[k.remat]) / (self.chips
                                                   * self.chip.peak_flops)

    def memory_s(self, k: Knobs) -> float:
        b = memory_bytes(self.cfg, self.shape, mb=k.microbatches,
                         quantized_opt=k.quant_opt)
        return b / (self.chips * self.chip.hbm_bw)

    def collective_s(self, k: Knobs) -> float:
        T = self.shape.global_batch * self.shape.seq
        D = self.cfg.d_model
        L = self.cfg.n_layers
        # Megatron TP: ~4 all-reduces of the hidden per layer per microbatch
        # pass (fwd+bwd), traffic ~ 2x payload
        tp = 4.0 * L * T * D * 2.0 * 2.0 * 2.0
        # DP gradient reduce-scatter+all-gather ~ 2 x params (bf16 wire)
        dp = 4.0 * self.N
        # FSDP param all-gather per microbatch (fwd+bwd)
        fsdp = (2.0 * self.N * 2.0 * k.microbatches) if k.fsdp else 0.0
        # MoE: EP moves ~2 x token payload x top_k per MoE layer; TP-in-expert
        # with capacity dispatch moves the whole (E, C, D) dispatch buffer
        # through the mesh every pass (the reference measured it
        # pathological)
        moe = 0.0
        if self.cfg.moe is not None:
            n_moe = self.cfg.n_super * sum(
                1 for _, f in self.cfg.pattern if f == "E")
            kk = self.cfg.moe.top_k
            if k.moe_ep:
                moe = n_moe * T * D * 2.0 * kk * 2.0
            else:
                # the dispatch buffers replicated across the data axis
                # instead of payloads exchanged
                cf = self.cfg.moe.capacity_factor
                moe = (n_moe * T * kk * cf * D * 4.0 * 3.0
                       * max(self.data_par, 1))
        return (tp + dp + fsdp + moe) / (self.chips * self.chip.link_bw)

    def step_s(self, k: Knobs) -> float:
        if self.hbm_per_chip(k) > self.chip.hbm_bytes:
            return float("inf")
        return max(self.compute_s(k), self.memory_s(k), self.collective_s(k))

    def objective(self, k: Knobs) -> float:
        """Finite shaped objective: infeasible mappings are scored by how far
        over HBM they are, so the agent gets a gradient toward feasibility
        (a bare `inf` gives no learning signal on the OOM plateau)."""
        t = max(self.compute_s(k), self.memory_s(k), self.collective_s(k))
        over = self.hbm_per_chip(k) / self.chip.hbm_bytes
        if over > 1.0:
            return 1e3 * over
        return t


# ---------------------------------------------------------------------------
# RL search over the knob space (the AIMM loop, environment = cost model)
# ---------------------------------------------------------------------------

N_ACTIONS = 8
STATE_DIM = 24


def _state_vec(cm: CostModel, k: Knobs,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """The state (1, STATE_DIM) float32 on `device` (one agent): the
    features in float64, cast once."""
    c, m, co = cm.compute_s(k), cm.memory_s(k), cm.collective_s(k)
    tot = max(c + m + co, 1e-12)
    hbm = cm.hbm_per_chip(k) / cm.chip.hbm_bytes
    feats = [
        np.log10(max(cm.N, 1)) / 12.0,
        np.log10(max(cm.mf, 1)) / 20.0,
        cm.Na / max(cm.N, 1),
        MB_LADDER.index(k.microbatches) / len(MB_LADDER),
        REMAT_LADDER.index(k.remat) / len(REMAT_LADDER),
        float(k.fsdp), float(k.quant_opt), float(k.moe_ep),
        min(c / tot, 1.0), min(m / tot, 1.0), min(co / tot, 1.0),
        min(hbm, 4.0) / 4.0,
        float(cm.cfg.moe is not None),
        float(cm.shape.kind == "train"),
        cm.shape.seq / 1e6, cm.shape.global_batch / 512.0,
    ]
    feats += [0.0] * (STATE_DIM - len(feats))
    return torch.from_numpy(np.asarray([feats], np.float32)).to(device)


def _apply_action(k: Knobs, a: int) -> Knobs:
    if a == 1:
        i = MB_LADDER.index(k.microbatches)
        return dataclasses.replace(k, microbatches=MB_LADDER[
            min(i + 1, len(MB_LADDER) - 1)])
    if a == 2:
        i = MB_LADDER.index(k.microbatches)
        return dataclasses.replace(k, microbatches=MB_LADDER[max(i - 1, 0)])
    if a == 3:
        i = REMAT_LADDER.index(k.remat)
        return dataclasses.replace(k, remat=REMAT_LADDER[
            min(i + 1, len(REMAT_LADDER) - 1)])
    if a == 4:
        i = REMAT_LADDER.index(k.remat)
        return dataclasses.replace(k, remat=REMAT_LADDER[max(i - 1, 0)])
    if a == 5:
        return dataclasses.replace(k, fsdp=not k.fsdp)
    if a == 6:
        return dataclasses.replace(k, quant_opt=not k.quant_opt)
    if a == 7:
        return dataclasses.replace(k, moe_ep=not k.moe_ep)
    return k


class SearchResult(NamedTuple):
    best: Knobs
    best_step_s: float
    baseline_step_s: float
    trajectory: list


def search_agent_cfg() -> AgentConfig:
    """The mapper's agent: DQN 24 -> 128/128 -> 8, no bootstrap (gamma 0),
    exploring from 0.5 over 80 invocations, training from 16 samples."""
    return AgentConfig(dqn=DQNConfig(state_dim=STATE_DIM,
                                     n_actions=N_ACTIONS, gamma=0.0),
                       eps_start=0.5, eps_decay=80, min_replay=16)


def search(cfg: ModelConfig, shape: ShapeCfg, mesh_shape=(16, 16),
           steps: int = 300, seed: int = 0, start: Knobs = Knobs(),
           chip: Chip = H100,
           device: str | torch.device = "cuda") -> SearchResult:
    """Continual-learning mapping search; returns best mapping + trajectory."""
    dev = resolve_device(device)
    cm = CostModel(cfg, shape, mesh_shape, chip)
    acfg = search_agent_cfg()
    ag = agent_mod.init_agent(prng.PRNGKey(seed, dev), acfg, n_agents=1,
                              device=dev)

    k = start
    baseline = cm.step_s(k)
    best, best_t = k, baseline
    prev_s = _state_vec(cm, k, dev)
    prev_a = torch.zeros((1,), dtype=torch.int32, device=dev)
    prev_t = cm.objective(k)
    traj = [(k, baseline)]
    for i in range(steps):
        s = _state_vec(cm, k, dev)
        t = cm.objective(k)
        if cm.step_s(k) < best_t:
            best, best_t = k, cm.step_s(k)
        r = 0.0 if i == 0 else (1.0 if t < prev_t * 0.999 else
                                (-1.0 if t > prev_t * 1.001 else 0.0))
        ag = agent_mod.observe(ag, prev_s, prev_a,
                               torch.full((1,), r, device=dev), s)
        ag = agent_mod.train(ag, acfg)
        a, ag = agent_mod.act(ag, acfg, s)
        prev_s, prev_a, prev_t = s, a, t
        k = _apply_action(k, int(a[0]))
        traj.append((k, cm.step_s(k)))
    return SearchResult(best, best_t, baseline, traj)


def exhaustive_best(cfg: ModelConfig, shape: ShapeCfg, mesh_shape=(16, 16),
                    chip: Chip = H100) -> tuple[Knobs, float]:
    """Ground-truth optimum over the knob lattice (small enough to sweep)."""
    cm = CostModel(cfg, shape, mesh_shape, chip)
    best, best_t = None, float("inf")
    for mb, rm, fs, qo, ep in itertools.product(
            MB_LADDER, REMAT_LADDER, (False, True), (False, True),
            (False, True)):
        k = Knobs(mb, rm, fs, qo, ep)
        t = cm.step_s(k)
        if t < best_t:
            best, best_t = k, t
    return best, best_t
