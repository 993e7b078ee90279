"""Weights and optimizer state carried across from the reference: the
pytree of `repro.models.model.build_model(cfg).init(key)[0]`, after
`jax.tree.map(np.asarray, ...)`, into the port's parameter layout, and the
optimizers' states (`opt_state_from_numpy`); `to_reference_layout` and
`opt_state_to_reference` go the other way, so a state from either side
trains on in the other (and the training checkpoints are written in the
reference's layout).

The reference stacks each pattern position's block parameters over the
super-blocks (a leading n_super axis under params["decoder"]["supers"],
and n_layers of the encoder under params["encoder"]["supers"]); the port
keeps one dict per super-block, so that axis is unstacked; every
leaf under it is cut the same way, the MoE block's float32 `router` and its
(E, ...) stacks `w_gate`/`w_up`/`w_down` included (each super-block keeps
its own (E, ...) stack), and the leading dense blocks (`first`, a list of
unstacked blocks in both packages) carry across as they are.  bf16
arrays arrive as `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses:
their bits go through int16 and are viewed as torch.bfloat16, so every
weight is bit-equal to the reference's (no round trip through float32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def to_tensor(a, device) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on `device`, bit-equal."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _stack(items: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, list):
        return [_stack([it[i] for it in items]) for i in range(len(first))]
    return torch.stack(items)


def from_reference_layout(cfg: ModelConfig, tree: dict, leaf=lambda a: a
                          ) -> dict:
    """A tree in the reference's parameter layout (the parameters, one
    adamw moment, or quantized_adamw's per-leaf state) in the port's: each
    stack's super-block axis unstacked, `leaf` applied to every leaf."""
    def unstack(st: dict, n_super: int) -> dict:
        return {"first": _map(st["first"], leaf),
                "supers": [{key: _map(sub, lambda a, i=i: leaf(a[i]))
                            for key, sub in st["supers"].items()}
                           for i in range(n_super)]}

    out = {k: _map(v, leaf) for k, v in tree.items()
           if k not in ("decoder", "encoder")}
    out["decoder"] = unstack(tree["decoder"], cfg.n_super)
    if cfg.encoder is not None:
        out["encoder"] = unstack(tree["encoder"], cfg.encoder.n_layers)
    return out


def to_reference_layout(cfg: ModelConfig, tree: dict) -> dict:
    """The reverse of `from_reference_layout` on tensors: each stack's
    super-blocks stacked on a leading axis under supers[str(i)]."""
    def stack(st: dict) -> dict:
        supers = st["supers"]
        return {"first": st["first"],
                "supers": {key: _stack([s[key] for s in supers])
                           for key in supers[0]}}

    out = dict(tree)
    out["decoder"] = stack(tree["decoder"])
    if cfg.encoder is not None:
        out["encoder"] = stack(tree["encoder"])
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return from_reference_layout(cfg, tree, lambda a: to_tensor(a, dev))


def _is_moments(state: dict) -> bool:
    return set(state) == {"m", "v"}


def opt_state_from_reference(cfg: ModelConfig, state: dict,
                             leaf=lambda a: a) -> dict:
    """An optimizer state in the reference's layout, in the port's:
    adamw's {"m", "v"} (each a parameter tree), quantized_adamw's per-leaf
    {mq, ms, vq, v_lo, v_sc} or {m, v} dicts (a parameter tree with dict
    leaves), sgd's {}; `leaf` applied to every leaf."""
    if not state:
        return {}
    if _is_moments(state):
        return {k: from_reference_layout(cfg, state[k], leaf) for k in state}
    return from_reference_layout(cfg, state, leaf)


def opt_state_from_numpy(cfg: ModelConfig, state: dict,
                         device: str | torch.device = "cuda") -> dict:
    """The reference's optimizer state (numpy leaves) as tensors on
    `device`, in the port's layout."""
    dev = resolve_device(device)
    return opt_state_from_reference(cfg, state, lambda a: to_tensor(a, dev))


def opt_state_to_reference(cfg: ModelConfig, state: dict) -> dict:
    """The port's optimizer state in the reference's layout (tensors)."""
    if not state:
        return {}
    if _is_moments(state):
        return {k: to_reference_layout(cfg, state[k]) for k in state}
    return to_reference_layout(cfg, state)
