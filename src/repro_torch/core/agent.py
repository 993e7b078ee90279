"""Continual epsilon-greedy Q-learning agent (port of `repro.core.agent`,
paper §4.3, §5.2).

Per invocation: `observe` appends (s, a, r, s') to the replay ring, then
`train_step` takes one minibatch TD step (Adam, periodic hard target sync),
then `act` picks an epsilon-greedy action from the online dueling network.
The DNN persists across episode resets (continual learning); only the
environment is cleared between runs (nmp.engine.run_program).

Every tensor of `AgentState` carries a leading agent axis G (the engine's
lanes); `run_episode` uses G = 1.

Random numbers: each agent carries the reference's threefry key in its
state (`rng`, (G, 2) int64, core/prng.py), and every draw is the
reference's, split for split: `init_agent(key)` splits it into the weight
key and the agent's stream, `cold_start(seed)` is `init_agent(PRNGKey(seed
+ 1))`, `act` splits the stream in three (next stream, exploration
uniform, random action) and the TD step samples its minibatch from a key
the caller splits off (`train` splits the agent's own).  Weights drawn by
`init_agent` are `prng.normal`'s, within 3 ulp of the reference's; every
other draw is the reference's bit for bit.  `agent_from_numpy` imports the
reference's weights, Adam moments, replay, counters and key, so both
packages compute with the same state and stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dqn, prng
from repro_torch.core.dqn import DQNConfig
from repro_torch.core.replay import ReplayBuffer, init_replay, push, sample
from repro_torch.train.optimizer import adamw


@dataclasses.dataclass
class AgentState:
    params: dict[str, torch.Tensor]
    target_params: dict[str, torch.Tensor]
    opt_state: dict[str, dict[str, torch.Tensor]]   # {"m": {...}, "v": {...}}
    replay: ReplayBuffer
    step: torch.Tensor          # (G,) i32 env interactions in this scenario
    train_steps: torch.Tensor   # (G,) i32 gradient updates taken (lifetime)
    loss_ema: torch.Tensor      # (G,) f32
    global_step: torch.Tensor   # (G,) i32 lifetime env interactions
    rng: torch.Tensor           # (G, 2) int64 threefry key (see module doc)

    def replace(self, **kw) -> "AgentState":
        return dataclasses.replace(self, **kw)


class AgentConfig(NamedTuple):
    dqn: DQNConfig
    replay_capacity: int = 4096
    eps_start: float = 0.3
    eps_end: float = 0.02
    eps_decay: int = 120       # interactions to decay over
    train_every: int = 1
    min_replay: int = 32


def _optimizer(cfg: AgentConfig):
    return adamw(cfg.dqn.lr, grad_clip=cfg.dqn.grad_clip)


def init_agent(rng, cfg: AgentConfig, n_agents: int = 1,
               device: str | torch.device = "cuda") -> AgentState:
    """Fresh agents from a key (2,) shared by all, a key per agent (G, 2),
    or an integer seed (`PRNGKey(seed)`): the key splits into the weights'
    key and the agent's stream, as the reference's `init_agent`."""
    dev = resolve_device(device)
    if not isinstance(rng, torch.Tensor):
        rng = prng.PRNGKey(int(rng), dev)
    rng = rng.to(dev)
    keys = prng.split(rng.expand(n_agents, 2) if rng.dim() == 1 else rng)
    params = dqn.init_params(keys[:, 0], cfg.dqn, n_agents, dev)
    zi = lambda: torch.zeros((n_agents,), dtype=torch.int32, device=dev)
    return AgentState(
        params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=_optimizer(cfg).init(params),
        replay=init_replay(cfg.replay_capacity, cfg.dqn.state_dim, n_agents,
                           dev),
        step=zi(), train_steps=zi(),
        loss_ema=torch.zeros((n_agents,), dtype=torch.float32, device=dev),
        global_step=zi(), rng=keys[:, 1].contiguous())


def cold_start(seed, cfg: AgentConfig, n_agents: int = 1,
               device: str | torch.device = "cuda") -> AgentState:
    """The engine's fresh-agent convention: `init_agent(PRNGKey(seed + 1))`,
    as the reference.  `seed` is an int (every agent the same) or an int
    tensor (G,) of per-agent seeds (the sweep's cells)."""
    if isinstance(seed, torch.Tensor):
        keys = prng.PRNGKey(seed.to(torch.int64) + 1)
        return init_agent(keys, cfg, int(seed.shape[0]), keys.device)
    dev = resolve_device(device)
    return init_agent(prng.PRNGKey(int(seed) + 1, dev), cfg, n_agents, dev)


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def agent_from_numpy(snapshot: Any,
                     device: str | torch.device = "cuda") -> AgentState:
    """One agent (G = 1) from a numpy snapshot of the reference's AgentState
    (`repro.core.agent.export_agent`, or this module's `export_agent`),
    read by field name: params, target_params, opt_state m/v, replay,
    step, train_steps, loss_ema, global_step and the key `rng` (its two
    uint32 words, taken as they are)."""
    dev = resolve_device(device)
    on = lambda a: torch.from_numpy(np.array(a, copy=True))[None].to(dev)
    tree = lambda d: {k: on(v).to(torch.float32) for k, v in d.items()}
    opt = _field(snapshot, "opt_state")
    rp = _field(snapshot, "replay")
    i32 = lambda a: on(a).to(torch.int32)
    return AgentState(
        params=tree(_field(snapshot, "params")),
        target_params=tree(_field(snapshot, "target_params")),
        opt_state={"m": tree(_field(opt, "m")), "v": tree(_field(opt, "v"))},
        replay=ReplayBuffer(
            s=on(_field(rp, "s")).float(), a=i32(_field(rp, "a")),
            r=on(_field(rp, "r")).float(), s2=on(_field(rp, "s2")).float(),
            done=on(_field(rp, "done")).float(), ptr=i32(_field(rp, "ptr")),
            size=i32(_field(rp, "size"))),
        step=i32(_field(snapshot, "step")),
        train_steps=i32(_field(snapshot, "train_steps")),
        loss_ema=on(_field(snapshot, "loss_ema")).float(),
        global_step=i32(_field(snapshot, "global_step")),
        rng=on(np.asarray(_field(snapshot, "rng"), np.uint32).astype(
            np.int64)))


def export_agent(agent: AgentState) -> dict:
    """Host-side numpy snapshot of a one-agent state (G = 1), with the
    reference's field names (no agent axis; the key as two uint32 words)."""
    if agent.step.shape[0] != 1:
        raise ValueError(f"export_agent: expected one agent, got "
                         f"{agent.step.shape[0]}")
    np_ = lambda t: t[0].detach().cpu().numpy()
    tree = lambda d: {k: np_(v) for k, v in d.items()}
    rp = agent.replay
    return {
        "params": tree(agent.params),
        "target_params": tree(agent.target_params),
        "opt_state": {"m": tree(agent.opt_state["m"]),
                      "v": tree(agent.opt_state["v"])},
        "replay": {"s": np_(rp.s), "a": np_(rp.a), "r": np_(rp.r),
                   "s2": np_(rp.s2), "done": np_(rp.done),
                   "ptr": np_(rp.ptr), "size": np_(rp.size)},
        "step": np_(agent.step), "train_steps": np_(agent.train_steps),
        "loss_ema": np_(agent.loss_ema),
        "global_step": np_(agent.global_step),
        "rng": np_(agent.rng).astype(np.uint32),
    }


def epsilon(cfg: AgentConfig, step: torch.Tensor) -> torch.Tensor:
    inv_decay = float(np.float32(1.0) / np.float32(cfg.eps_decay))
    frac = torch.exp(-step.to(torch.float32) * inv_decay)
    return cfg.eps_end + (cfg.eps_start - cfg.eps_end) * frac


def act(agent: AgentState, cfg: AgentConfig, state_vec: torch.Tensor,
        explore: torch.Tensor | bool = True
        ) -> tuple[torch.Tensor, AgentState]:
    """Epsilon-greedy action per agent; returns ((G,) i32 action, agent).
    The stream splits in three every call (next stream, the exploration
    uniform, the random action), whatever `explore` says, so greedy
    evaluation consumes it the same way."""
    dev = state_vec.device
    keys = prng.split(agent.rng, 3)                               # (G, 3, 2)
    q = dqn.q_values_infer(agent.params, state_vec, cfg.dqn)      # (G, A)
    greedy = torch.argmax(q, dim=-1).to(torch.int32)
    eps = epsilon(cfg, agent.global_step)
    rand_a = prng.randint(keys[:, 2], (), 0, cfg.dqn.n_actions)
    u = prng.uniform(keys[:, 1], ())
    explore = torch.as_tensor(explore, dtype=torch.bool, device=dev)
    action = torch.where(explore & (u < eps), rand_a, greedy)
    return action, agent.replace(rng=keys[:, 0], step=agent.step + 1,
                                 global_step=agent.global_step + 1)


def observe(agent: AgentState, s, a, r, s2, done=0.0,
            mask: torch.Tensor | None = None) -> AgentState:
    """Push (s, a, r, s2, done) into each agent's replay ring where `mask`."""
    return agent.replace(replay=push(agent.replay, s, a, r, s2, done, mask))


def replay_ready(agent: AgentState, cfg: AgentConfig) -> torch.Tensor:
    """(G,) True once the replay holds `min_replay` samples.  While False,
    `train_step` is an exact no-op (masked batch, zero grads onto zero Adam
    moments, no step count)."""
    return agent.replay.size >= cfg.min_replay


def train(agent: AgentState, cfg: AgentConfig) -> AgentState:
    """One TD minibatch step, its sample key split off the agent's stream."""
    keys = prng.split(agent.rng)
    return train_step(agent.replace(rng=keys[:, 0]), cfg, keys[:, 1])


def train_step(agent: AgentState, cfg: AgentConfig,
               rng: torch.Tensor) -> AgentState:
    """One TD minibatch step per agent, the minibatch sampled with `rng`
    (G, 2) drawn by the caller (the agent's stream is not consumed here, as
    in the reference, so the engine splits it off every committing agent
    whether or not it trains)."""
    opt = _optimizer(cfg)
    batch = sample(agent.replay, rng, cfg.dqn.batch_size)
    ready = replay_ready(agent, cfg)
    ready_f = ready.to(torch.float32)
    batch = dict(batch, w=batch["w"] * ready_f[:, None])

    keys = list(agent.params)
    with torch.enable_grad():
        leaves = {k: agent.params[k].detach().requires_grad_(True)
                  for k in keys}
        loss = dqn.td_loss(leaves, agent.target_params, batch, cfg.dqn)
        grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in keys])
    loss = loss.detach()
    shape = lambda g: (-1,) + (1,) * (g.dim() - 1)
    grads = {k: g * ready_f.reshape(shape(g)) for k, g in zip(keys, grads)}
    new_params, new_opt = opt.update(grads, agent.opt_state, agent.params,
                                     agent.train_steps)
    train_steps = agent.train_steps + ready.to(torch.int32)

    # periodic hard target sync
    sync = (train_steps % cfg.dqn.target_sync == 0) & (train_steps > 0)
    new_target = {k: torch.where(sync.reshape(shape(t)), new_params[k], t)
                  for k, t in agent.target_params.items()}
    return agent.replace(params=new_params, target_params=new_target,
                         opt_state=new_opt, train_steps=train_steps,
                         loss_ema=0.99 * agent.loss_ema + 0.01 * loss)
