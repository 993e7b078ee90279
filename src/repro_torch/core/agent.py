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
other draw is the reference's bit for bit.  `import_agent` imports the
reference's weights, Adam moments, replay, counters and key, so both
packages compute with the same state and stream.

Lifecycle API (the continual layer, nmp.continual, builds on these):

  cold_start     : the fresh-agent convention (PRNGKey(seed + 1))
  hand_off       : scenario-boundary handoff: the per-scenario counter
                   resets; DNN, replay, key and global_step carry over
  export_agent / import_agent : a host numpy snapshot (the reference's
                   AgentState layout and field names, the key as two uint32
                   words; `core.tree.Fields` dicts) <-> a one-agent
                   state; `export_agents` / `import_agents` the same for a
                   stacked G-agent batch (one copy per leaf)
  agent_template : the key-free snapshot skeleton (checkpoint restore)
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
from repro_torch.core.tree import Fields
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


# The reference's AgentState and ReplayBuffer fields, in their order: the
# layout of every host snapshot (and of a checkpoint's leaf keys).
AGENT_FIELDS = ("params", "target_params", "opt_state", "replay", "step",
                "train_steps", "rng", "loss_ema", "global_step")
REPLAY_FIELDS = ("s", "a", "r", "s2", "done", "ptr", "size")


def import_agents(stacked: Any, device: str | torch.device = "cuda"
                  ) -> AgentState:
    """G agents from a host snapshot whose leaves carry a leading agent
    axis G (the reference's field names, read by name from a dict or a
    NamedTuple; the key as two uint32 words per agent): one host->device
    copy per leaf."""
    dev = resolve_device(device)
    on = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    f32 = lambda a: on(a).to(torch.float32)
    i32 = lambda a: on(a).to(torch.int32)
    tree = lambda d: {k: f32(v) for k, v in d.items()}
    opt = _field(stacked, "opt_state")
    rp = _field(stacked, "replay")
    return AgentState(
        params=tree(_field(stacked, "params")),
        target_params=tree(_field(stacked, "target_params")),
        opt_state={"m": tree(_field(opt, "m")), "v": tree(_field(opt, "v"))},
        replay=ReplayBuffer(
            s=f32(_field(rp, "s")), a=i32(_field(rp, "a")),
            r=f32(_field(rp, "r")), s2=f32(_field(rp, "s2")),
            done=f32(_field(rp, "done")), ptr=i32(_field(rp, "ptr")),
            size=i32(_field(rp, "size"))),
        step=i32(_field(stacked, "step")),
        train_steps=i32(_field(stacked, "train_steps")),
        loss_ema=f32(_field(stacked, "loss_ema")),
        global_step=i32(_field(stacked, "global_step")),
        rng=on(np.asarray(_field(stacked, "rng"), np.uint32).astype(
            np.int64)))


def map_snapshot(fn, snap: Any) -> Fields:
    """`fn` over every leaf of a snapshot, rebuilt in the reference layout
    (a `Fields` agent and replay, plain dicts for the parameter trees)."""
    tree = lambda d: {k: fn(v) for k, v in d.items()}
    opt = _field(snap, "opt_state")
    rp = _field(snap, "replay")
    out = {"params": tree(_field(snap, "params")),
           "target_params": tree(_field(snap, "target_params")),
           "opt_state": {"m": tree(_field(opt, "m")),
                         "v": tree(_field(opt, "v"))},
           "replay": Fields({f: fn(_field(rp, f)) for f in REPLAY_FIELDS})}
    return Fields({f: out[f] if f in out else fn(_field(snap, f))
                   for f in AGENT_FIELDS})


def import_agent(snapshot: Any,
                 device: str | torch.device = "cuda") -> AgentState:
    """One agent (G = 1) on `device` from a numpy snapshot of the
    reference's AgentState (`repro.core.agent.export_agent`, or this
    module's `export_agent`), read by field name: params, target_params,
    opt_state m/v, replay, step, train_steps, loss_ema, global_step and the
    key `rng` (its two uint32 words, taken as they are)."""
    return import_agents(map_snapshot(lambda a: np.asarray(a)[None],
                                      snapshot), device)


def export_agents(agent: AgentState) -> Fields:
    """Host snapshot of a G-agent state, every leaf with its leading agent
    axis (one device->host copy per leaf; the keys as uint32 words)."""
    rp = agent.replay
    np_ = lambda t: t.detach().cpu().numpy()
    tree = lambda d: {k: np_(v) for k, v in d.items()}
    return Fields(
        params=tree(agent.params), target_params=tree(agent.target_params),
        opt_state={"m": tree(agent.opt_state["m"]),
                   "v": tree(agent.opt_state["v"])},
        replay=Fields({f: np_(getattr(rp, f)) for f in REPLAY_FIELDS}),
        step=np_(agent.step), train_steps=np_(agent.train_steps),
        rng=np_(agent.rng).astype(np.uint32), loss_ema=np_(agent.loss_ema),
        global_step=np_(agent.global_step))


def snapshot_cell(stacked: Fields, cell: int) -> Fields:
    """Agent `cell` of a stacked host snapshot (`export_agents`), as a
    one-agent snapshot of its own arrays (a store that keeps it does not
    keep the whole batch alive)."""
    return map_snapshot(lambda a: np.array(a[cell]), stacked)


def export_agent(agent: AgentState, cell: int = 0) -> Fields:
    """Host-side numpy snapshot of agent `cell` of a G-agent state, in the
    reference's layout and with its field names (no agent axis; the key as
    two uint32 words)."""
    G = agent.step.shape[0]
    if not 0 <= cell < G:
        raise ValueError(f"export_agent: cell {cell} outside 0..{G - 1}")
    return snapshot_cell(export_agents(agent), cell)


def cat_agents(agents: list[AgentState]) -> AgentState:
    """The agents of several states stacked along the agent axis, in order,
    on their device (the tests' per-cell reference for the warm agent
    batch that `sweep.AgentStaging` stacks on the host)."""
    cat = lambda *ts: torch.cat(ts)
    tree = lambda name: {k: cat(*(getattr(a, name)[k] for a in agents))
                         for k in agents[0].params}
    return AgentState(
        params=tree("params"), target_params=tree("target_params"),
        opt_state={mv: {k: cat(*(a.opt_state[mv][k] for a in agents))
                        for k in agents[0].params} for mv in ("m", "v")},
        replay=ReplayBuffer(**{f: cat(*(getattr(a.replay, f)
                                        for a in agents))
                               for f in REPLAY_FIELDS}),
        **{f: cat(*(getattr(a, f) for a in agents))
           for f in ("step", "train_steps", "loss_ema", "global_step",
                     "rng")})


def hand_off(agent: AgentState) -> AgentState:
    """Scenario-boundary handoff (program switch, co-runner churn): the
    agent continues its lifetime (DNN weights, target net, Adam moments,
    replay, key and `global_step` carry over) while the per-scenario
    interaction counter resets.  Epsilon keys on `global_step`, so
    exploration keeps decaying across the boundary."""
    return agent.replace(step=torch.zeros_like(agent.step))


def agent_template(cfg: AgentConfig) -> Fields:
    """Key-free host snapshot of one agent: every leaf with the reference
    snapshot's shape and dtype, all zeros (the key too).  Checkpoint
    restores map saved leaves onto it, so a fresh process restores an agent
    without replaying the init key."""
    params = dqn.zeros_params(cfg.dqn)
    zeros = lambda: {k: np.zeros_like(v) for k, v in params.items()}
    cap, sd = cfg.replay_capacity, cfg.dqn.state_dim
    i32 = lambda: np.zeros((), np.int32)
    return Fields(
        params=params, target_params=zeros(),
        opt_state={"m": zeros(), "v": zeros()},
        replay=Fields(s=np.zeros((cap, sd), np.float32),
                      a=np.zeros((cap,), np.int32),
                      r=np.zeros((cap,), np.float32),
                      s2=np.zeros((cap, sd), np.float32),
                      done=np.zeros((cap,), np.float32), ptr=i32(),
                      size=i32()),
        step=i32(), train_steps=i32(), rng=np.zeros((2,), np.uint32),
        loss_ema=np.zeros((), np.float32), global_step=i32())


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


def step_agent(agent: AgentState, cfg: AgentConfig, prev_s, prev_a, reward,
               new_s) -> tuple[torch.Tensor, AgentState]:
    """One continual-learning invocation: observe -> train -> act (the
    hardware flow of the paper's Fig. 4-2)."""
    agent = observe(agent, prev_s, prev_a, reward, new_s)
    agent = train(agent, cfg)
    return act(agent, cfg, new_s)
