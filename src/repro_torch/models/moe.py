"""Mixture-of-experts FFN (port of `repro/models/moe.py`): top-k
token-choice routing with capacity-bounded sort-based dispatch (gather ->
per-expert dense matmul -> weighted combine).

The "dropping" MoE: capacity C per expert is static (C = ceil(T_group * k /
E * capacity_factor), rounded up to 8), tokens beyond capacity are dropped.
Expert weights are stacked (E, ...).  Dispatch carries a leading group axis
G (cfg.dispatch_groups): routing, capacity and dispatch run per group of
T / G tokens, and the aux metrics are averaged over the groups.  The
reference pins that axis to the data axis of its mesh; one card has none.

Router styles:
  mixtral/jamba : top-k over logits, softmax over the selected k
  deepseek      : softmax over all experts, top-k, renormalize
Shared experts (deepseek) run densely on every token.

The expert products are plain batched matmuls (the reference leaves them to
XLA, outside any Pallas kernel).  The combine is deterministic on the card:
each token sums its kept slots in the reference's scatter order (ascending
expert, then rank), gathered from the slot outputs, instead of an
`index_add_` whose CUDA atomics land a bf16 sum in a different order from
run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.models.layers import _normal, gelu


def init_moe(gen, d_model: int, cfg: MoECfg, swiglu: bool = True) -> dict:
    """The reference's leaves whatever `swiglu` (without it the gates
    `w_gate`/`ws_gate` are drawn and never read, as there)."""
    E, Fe = cfg.n_routed, cfg.d_expert
    s_in, s_out = d_model ** -0.5, Fe ** -0.5
    params = {
        "router": _normal(gen, (d_model, E), s_in).float(),
        "w_gate": _normal(gen, (E, d_model, Fe), s_in),
        "w_up": _normal(gen, (E, d_model, Fe), s_in),
        "w_down": _normal(gen, (E, Fe, d_model), s_out),
    }
    if cfg.n_shared:
        Fs = cfg.n_shared * Fe
        params["ws_gate"] = _normal(gen, (d_model, Fs), s_in)
        params["ws_up"] = _normal(gen, (d_model, Fs), s_in)
        params["ws_down"] = _normal(gen, (Fs, d_model), Fs ** -0.5)
    return params


def _capacity(n_tokens: int, cfg: MoECfg) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_routed * cfg.capacity_factor)
    return max((c + 7) // 8 * 8, 8)


def moe_ffn(params, x, cfg: MoECfg, swiglu: bool = True):
    """x: (B, S, D) -> (B, S, D), plus aux metrics dict.  swiglu False:
    GELU experts (and shared experts), gelu(x w_up) w_down."""
    B, S, D = x.shape
    T = B * S
    G = max(cfg.dispatch_groups, 1)
    if T % G or (T // G) * cfg.top_k < cfg.n_routed:
        G = 1
    if G > 1:
        outs, auxs = zip(*(_moe_dispatch(params, xg, cfg, swiglu)
                           for xg in x.reshape(G, T // G, 1, D)))
        aux = {k: torch.stack([a[k] for a in auxs]).mean()
               for k in auxs[0]}
        return torch.stack(outs).reshape(B, S, D), aux
    return _moe_dispatch(params, x, cfg, swiglu)


def select_experts(logits, cfg: MoECfg):
    """The router's choice: (gates (T, K), expert_idx (T, K)) from the
    logits (T, E): the top-k of the softmax (deepseek) or of the logits."""
    score = (torch.softmax(logits, dim=-1) if cfg.router_pre_softmax
             else logits)
    expert_idx = torch.topk(score, cfg.top_k, dim=-1).indices
    return gates_for(logits, expert_idx, cfg), expert_idx


def gates_for(logits, expert_idx, cfg: MoECfg):
    """The gates (T, K) of the chosen experts: their softmax probabilities
    renormalised (deepseek), or the softmax over their logits."""
    if cfg.router_pre_softmax:
        gate_vals = torch.softmax(logits, dim=-1).gather(1, expert_idx)
        return gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return torch.softmax(logits.gather(1, expert_idx), dim=-1)


def route(params, xf, cfg: MoECfg) -> dict:
    """The routing of T tokens xf (T, D): logits, per-slot token, gate and
    validity (E, C), and each token's kept slots in scatter order."""
    T = xf.shape[0]
    E, K = cfg.n_routed, cfg.top_k
    C = _capacity(T, cfg)
    dev = xf.device
    logits = xf.float() @ params["router"]                        # (T, E)
    gates, expert_idx = select_experts(logits, cfg)

    # --- sort-based dispatch with static capacity ---
    flat_e = expert_idx.reshape(T * K)                            # (TK,)
    flat_g = gates.reshape(T * K)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_tok[order], flat_g[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[se]            # rank in expert
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)                 # overflow slot
    # the overflow slot E*C is a discarded row, as in the reference's
    # .at[slot].set(...)[:-1]; kept slots are distinct, so set order is moot
    tok_of_slot = torch.zeros(E * C + 1, dtype=torch.int32, device=dev)
    tok_of_slot[slot] = st.to(torch.int32)
    gate_of_slot = torch.zeros(E * C + 1, device=dev)
    gate_of_slot[slot] = sg
    valid_slot = torch.zeros(E * C + 1, device=dev)
    valid_slot[slot] = keep.float()
    # each token's kept slots, in the order the sorted assignments visit
    # them (ascending expert, then rank): (T, K) slot ids, E*C where dropped
    tok_slots = torch.full((T, K), E * C, dtype=torch.long, device=dev)
    k_of = torch.arange(T * K, device=dev) % K
    tok_slots[st, k_of[order]] = slot
    tok_slots = torch.sort(tok_slots, dim=1).values
    return dict(logits=logits, flat_e=flat_e, C=C,
                tok_of_slot=tok_of_slot[:-1].reshape(E, C),
                gate_of_slot=gate_of_slot[:-1].reshape(E, C),
                valid_slot=valid_slot[:-1].reshape(E, C),
                tok_slots=tok_slots)


def _moe_dispatch(params, x, cfg: MoECfg, swiglu: bool = True):
    """Single-group dispatch (the reference's `_moe_dispatch`)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_routed, cfg.top_k
    xf = x.reshape(T, D)
    r = route(params, xf, cfg)
    C, tok_of_slot, valid_slot = r["C"], r["tok_of_slot"], r["valid_slot"]

    xe = xf[tok_of_slot.long()] * valid_slot[..., None].to(x.dtype)  # (E,C,D)
    if swiglu:
        h = F.silu(torch.bmm(xe, params["w_gate"]))
        h = h * torch.bmm(xe, params["w_up"])
    else:
        h = gelu(torch.bmm(xe, params["w_up"]))
    ye = torch.bmm(h, params["w_down"])                           # (E, C, D)

    w = (r["gate_of_slot"] * valid_slot)[..., None].to(x.dtype)
    yw = torch.cat([(ye * w).reshape(E * C, D),
                    torch.zeros((1, D), dtype=x.dtype, device=x.device)])
    # the combine: token t's kept slots summed one at a time, in scatter
    # order, starting from 0 in x's dtype (the reference's
    # zeros(...).at[tok].add(...)); a dropped slot adds the zero row
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + yw[r["tok_slots"][:, j]]

    if cfg.n_shared and swiglu:
        g = F.silu(xf @ params["ws_gate"])
        out = out + (g * (xf @ params["ws_up"])) @ params["ws_down"]
    elif cfg.n_shared:
        out = out + gelu(xf @ params["ws_up"]) @ params["ws_down"]

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = torch.softmax(r["logits"], dim=-1).mean(dim=0)
    fe = torch.bincount(r["flat_e"], minlength=E).float() / (T * K)
    aux = {"lb_loss": E * (me * fe).sum(),
           "drop_frac": 1.0 - valid_slot.sum() / (T * K)}
    return out.reshape(B, S, D), aux
