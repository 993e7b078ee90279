"""Weights carried across from the reference: the pytree of
`repro.models.model.build_model(cfg).init(key)[0]`, after
`jax.tree.map(np.asarray, ...)`, into the port's parameter layout.

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


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    conv = lambda t: _map(t, lambda a: to_tensor(a, dev))

    def stack(st: dict, n_super: int) -> dict:
        supers = [{key: _map(sub, lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                           dev))
                   for key, sub in st["supers"].items()}
                  for i in range(n_super)]
        return {"first": conv(st["first"]), "supers": supers}

    out = {"embed": conv(tree["embed"]),
           "decoder": stack(tree["decoder"], cfg.n_super),
           "ln_f": conv(tree["ln_f"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    if cfg.encoder is not None:
        out["encoder"] = stack(tree["encoder"], cfg.encoder.n_layers)
        out["ln_enc"] = conv(tree["ln_enc"])
    return out
