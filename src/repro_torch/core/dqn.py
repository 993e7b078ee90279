"""Dueling (double) deep Q-network in plain torch (port of `repro.core.dqn`,
paper §4.3, Fig. 4-3): Q(s, a) = V(s) + A(s, a) - mean_a A(s, a).

Parameters are a dict of tensors with a leading agent axis G (the
reference's per-lane vmap written out): w0 (G, S, H1), b0 (G, H1), ...
`q_values` (the gradient path) is torch.matmul on the CPU, as the reference
leaves it to XLA, and on the card the batch-invariant products of
`kernels/batched_linear` (an agent's gradients the same bits at any agent
count G); `q_values_infer` (act and TD targets, no gradient) goes through
the fused dueling-qnet kernel on the card.  TF32 is kept off for those
matmuls (`torch.backends.cuda.matmul.allow_tf32 = False`, set by
`repro_torch.nmp.engine.run_episode` on entry), so they are full float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.batched_linear.ops import linear
from repro_torch.kernels.dueling_qnet.ops import qnet_forward


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    state_dim: int
    n_actions: int = 8
    hidden: tuple[int, ...] = (128, 128)
    dueling: bool = True
    double: bool = True           # double-DQN target
    gamma: float = 0.95
    lr: float = 1e-3
    grad_clip: float = 1.0
    target_sync: int = 64         # train steps between target-network syncs
    batch_size: int = 64


def init_params(key: torch.Tensor, cfg: DQNConfig, n_agents: int,
                device: torch.device) -> dict[str, torch.Tensor]:
    """He-scaled normal weights and zero biases, as the reference draws
    them: `key` (2,) or (G, 2) splits into one key per weight matrix, each
    drawn by `prng.normal` (within 3 ulp of `jax.random.normal`)."""
    dims = (cfg.state_dim,) + cfg.hidden
    G = n_agents
    key = key.to(device)
    keys = prng.split(key.expand(G, 2) if key.dim() == 1 else key,
                      len(dims) + 2)                       # (G, n, 2)
    # scales are float32 square roots, as jnp.sqrt of a Python float
    scale = lambda v: float(np.sqrt(np.float32(v)))
    normal = lambda k, *s: prng.normal(keys[:, k], s)
    zeros = lambda *s: torch.zeros((G,) + s, dtype=torch.float32,
                                   device=device)
    params = {}
    for i in range(len(dims) - 1):
        params[f"w{i}"] = normal(i, dims[i], dims[i + 1]) * scale(
            2.0 / dims[i])
        params[f"b{i}"] = zeros(dims[i + 1])
    h = dims[-1]
    if cfg.dueling:
        params["w_v"] = normal(-2, h, 1) * scale(1.0 / h)
        params["b_v"] = zeros(1)
        params["w_a"] = normal(-1, h, cfg.n_actions) * scale(1.0 / h)
        params["b_a"] = zeros(cfg.n_actions)
    else:
        params["w_q"] = normal(-1, h, cfg.n_actions) * scale(1.0 / h)
        params["b_q"] = zeros(cfg.n_actions)
    return params


def zeros_params(cfg: DQNConfig) -> dict[str, np.ndarray]:
    """Host-side zero parameters of one agent with `init_params`' keys,
    shapes and dtypes (no agent axis), built without a key: the restore
    template of a checkpointed agent, as the reference's `zeros_params`."""
    dims = (cfg.state_dim,) + cfg.hidden
    z = lambda *s: np.zeros(s, np.float32)
    params = {}
    for i in range(len(dims) - 1):
        params[f"w{i}"] = z(dims[i], dims[i + 1])
        params[f"b{i}"] = z(dims[i + 1])
    h = dims[-1]
    if cfg.dueling:
        params.update(w_v=z(h, 1), b_v=z(1), w_a=z(h, cfg.n_actions),
                      b_a=z(cfg.n_actions))
    else:
        params.update(w_q=z(h, cfg.n_actions), b_q=z(cfg.n_actions))
    return params


def q_values(params: dict, state: torch.Tensor,
             cfg: DQNConfig) -> torch.Tensor:
    """Q for states (G, S) -> (G, A) or (G, N, S) -> (G, N, A)."""
    squeeze = state.dim() == 2
    x = state.to(torch.float32)
    if squeeze:
        x = x[:, None, :]
    i = 0
    while f"w{i}" in params:
        x = torch.clamp(linear(x, params[f"w{i}"], params[f"b{i}"]), min=0.0)
        i += 1
    if cfg.dueling:
        v = linear(x, params["w_v"], params["b_v"])               # (G, N, 1)
        a = linear(x, params["w_a"], params["b_a"])               # (G, N, A)
        q = v + a - a.mean(dim=-1, keepdim=True)
    else:
        q = linear(x, params["w_q"], params["b_q"])
    return q[:, 0] if squeeze else q


def fused_kernel_compatible(params: dict) -> bool:
    """The fused kernel covers the production shape: dueling head over
    exactly two hidden layers."""
    return "w_v" in params and "w1" in params and "w2" not in params


@torch.no_grad()
def q_values_infer(params: dict, state: torch.Tensor,
                   cfg: DQNConfig) -> torch.Tensor:
    """Q for inference-only consumers (action selection, TD targets): the
    fused dueling-qnet kernel where the shape allows (the plain version on
    the CPU), else `q_values`.  No gradient flows through it."""
    if not fused_kernel_compatible(params):
        return q_values(params, state, cfg)
    squeeze = state.dim() == 2
    x = state.to(torch.float32)
    q = qnet_forward(params, x[:, None, :] if squeeze else x)
    return q[:, 0] if squeeze else q


def td_loss(params: dict, target_params: dict, batch: dict,
            cfg: DQNConfig) -> torch.Tensor:
    """(G,) squared TD error per agent (paper eq. 3), double-DQN target if
    cfg.double.  Only Q(s, a) carries gradients; the target values and the
    double-DQN argmax go through `q_values_infer`."""
    q = q_values(params, batch["s"], cfg)                        # (G, N, A)
    q_sa = q.gather(2, batch["a"].long()[:, :, None])[:, :, 0]
    q_next_t = q_values_infer(target_params, batch["s2"], cfg)
    if cfg.double:
        q_next_o = q_values_infer(params, batch["s2"], cfg)
        a_star = torch.argmax(q_next_o, dim=-1)
        q_next = q_next_t.gather(2, a_star[:, :, None])[:, :, 0]
    else:
        q_next = q_next_t.max(dim=-1).values
    y = batch["r"] + cfg.gamma * (1.0 - batch["done"]) * q_next
    err = (y - q_sa) * batch["w"]      # `w` masks invalid (not-yet-filled) rows
    return (torch.square(err).sum(dim=1)
            / torch.clamp(batch["w"].sum(dim=1), min=1.0))
