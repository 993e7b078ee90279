"""Mixture-of-experts FFN (port of `repro/models/moe.py`): top-k
token-choice routing with capacity-bounded sort-based dispatch (gather ->
per-expert dense matmul -> weighted combine).

The "dropping" MoE: capacity C per expert is static (C = ceil(T_group * k /
E * capacity_factor), rounded up to 8), tokens beyond capacity are dropped.
Expert weights are stacked (E, ...).  Dispatch carries a leading group axis
G (cfg.dispatch_groups): routing, capacity and dispatch run per group of
T / G tokens, and the aux metrics are averaged over the groups; on a mesh
the group axis is constrained to the data axes, as the reference pins it
(`sharding.context.constrain`).  On DTensors (`_moe_dispatch_sharded`)
the routing runs on every token of the group, gathered to each rank, and
the expert products take the experts' placements (EP or TP-in-expert),
their capacity slots cut over the data axes.

Router styles:
  mixtral/jamba : top-k over logits, softmax over the selected k
  deepseek      : softmax over all experts, top-k, renormalize
Shared experts (deepseek) run densely on every token.

The expert products are plain batched matmuls (the reference leaves them to
XLA, outside any Pallas kernel).  The combine is deterministic on the card:
each token sums its kept slots in the reference's scatter order (ascending
expert, then rank), gathered from the slot outputs, instead of an
`index_add_` whose CUDA atomics land a bf16 sum in a different order from
run to run.  Training differentiates the same ops: the backward of each
gather is an accumulating `index_put_`, which PyTorch runs on the card by
sorting the indices and summing each row's contributions in that fixed
order (no atomics), and the router's `gather`s pick distinct experts per
token, so no two of their scattered gradients meet; two card steps are
`torch.equal` (chip_smoke.py `[train-cpu]`).  The load-balancing term
reaches the loss through `train_step.make_loss_fn`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.models.layers import _normal, gelu, linear
from repro_torch.sharding.context import (constrain, is_dtensor,
                                          on_local_shards)


def init_moe(gen, d_model: int, cfg: MoECfg, swiglu: bool = True):
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
    roles = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }
    if cfg.n_shared:
        Fs = cfg.n_shared * Fe
        params["ws_gate"] = _normal(gen, (d_model, Fs), s_in)
        params["ws_up"] = _normal(gen, (d_model, Fs), s_in)
        params["ws_down"] = _normal(gen, (Fs, d_model), Fs ** -0.5)
        roles["ws_gate"] = ("embed", "ff")
        roles["ws_up"] = ("embed", "ff")
        roles["ws_down"] = ("ff", "embed")
    return params, roles


def _bincount(idx, n: int):
    """torch.bincount(idx, minlength=n) for ids below n; on `meta` (the
    dry run, which has no values) an empty (n,) of its dtype."""
    if idx.device.type == "meta":
        return torch.empty(n, dtype=torch.long, device="meta")
    return torch.bincount(idx, minlength=n)


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
        xg = constrain(x.reshape(G, T // G, 1, D), ("data", None, None, None))
        outs, auxs = zip(*(_moe_dispatch(params, xg[g], cfg, swiglu)
                           for g in range(G)))
        aux = {k: torch.stack([a[k] for a in auxs]).mean()
               for k in auxs[0]}
        yg = constrain(torch.stack(outs), ("data", None, None, None))
        return yg.reshape(B, S, D), aux
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


def route(params, xf, cfg: MoECfg, logits=None) -> dict:
    """The routing of T tokens xf (T, D): logits, per-slot token, gate and
    validity (E, C), and each token's kept slots in scatter order.
    `logits`: the router's (T, E) where taken already (the sharded path)."""
    T = xf.shape[0]
    E, K = cfg.n_routed, cfg.top_k
    C = _capacity(T, cfg)
    dev = xf.device
    if logits is None:
        logits = linear(xf.float(), params["router"])            # (T, E)
    gates, expert_idx = select_experts(logits, cfg)

    # --- sort-based dispatch with static capacity ---
    flat_e = expert_idx.reshape(T * K)                            # (TK,)
    flat_g = gates.reshape(T * K)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_tok[order], flat_g[order]
    counts = _bincount(flat_e, E)
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
    if is_dtensor(x):
        return _moe_dispatch_sharded(params, x, cfg, swiglu)
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_routed, cfg.top_k
    xf = x.reshape(T, D)
    # the routing and the gather read xf through one view, so their
    # gradients meet before the shared experts' (as in
    # `_moe_dispatch_sharded`: the same sums in the same order)
    xd = xf.view(T, D)
    r = route(params, xd, cfg)
    C, tok_of_slot, valid_slot = r["C"], r["tok_of_slot"], r["valid_slot"]

    xe = xd[tok_of_slot.long()] * valid_slot[..., None].to(x.dtype)  # (E,C,D)
    ye = _experts(params, xe, swiglu)                             # (E, C, D)

    w = (r["gate_of_slot"] * valid_slot)[..., None].to(x.dtype)
    yw = torch.cat([(ye * w).reshape(E * C, D),
                    torch.zeros((1, D), dtype=x.dtype, device=x.device)])
    # the combine: token t's kept slots summed one at a time, in scatter
    # order, starting from 0 in x's dtype (the reference's
    # zeros(...).at[tok].add(...)); a dropped slot adds the zero row
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + yw[r["tok_slots"][:, j]]

    if cfg.n_shared:
        out = out + _shared(params, xf, swiglu)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = torch.softmax(r["logits"], dim=-1).mean(dim=0)
    fe = _bincount(r["flat_e"], E).float() / (T * K)
    aux = {"lb_loss": E * (me * fe).sum(),
           "drop_frac": 1.0 - valid_slot.sum() / (T * K)}
    return out.reshape(B, S, D), aux


def _shared(params, xf, swiglu: bool):
    """The shared experts on every token xf (T, D)."""
    if swiglu:
        g = F.silu(linear(xf, params["ws_gate"]))
        return linear(g * linear(xf, params["ws_up"]), params["ws_down"])
    return linear(gelu(linear(xf, params["ws_up"])), params["ws_down"])


def _experts(params, xe, swiglu: bool):
    """The batched expert products of the dispatched tokens xe (E, C, D)."""
    if swiglu:
        h = F.silu(torch.bmm(xe, params["w_gate"]))
        h = h * torch.bmm(xe, params["w_up"])
    else:
        h = gelu(torch.bmm(xe, params["w_up"]))
    return torch.bmm(h, params["w_down"])                         # (E, C, D)


def _rows_over_mesh(xf):
    """The tokens xf (T, D) cut over every mesh dim (of size > 1) where
    they divide T: each rank takes the router's product of its own rows."""
    from torch.distributed.tensor import Shard
    mesh = xf.device_mesh
    cut = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    n = 1
    for i in cut:
        n *= mesh.size(i)
    if not cut or xf.shape[0] % n:
        return xf
    pl = tuple(Shard(0) if i in cut else p
               for i, p in enumerate(xf.placements))
    return xf.redistribute(mesh, pl)


def _slots_over_data(xe, w):
    """The dispatched tokens xe (E, C, D), replicated, cut over the data
    axes along the capacity slots where they divide C: each data rank runs
    the expert products of its own slots (on the replicated xe every data
    rank would repeat all of them).  Not over an axis that the expert
    weights w are sharded over (FSDP): their products already split the
    work there, by the contraction, and cutting the slots too would
    gather the weights whole."""
    from torch.distributed.tensor import Shard
    mesh = xe.device_mesh
    data = [i for i, a in enumerate(mesh.mesh_dim_names)
            if a != "model" and mesh.size(i) > 1
            and not w.placements[i].is_shard()]
    n = 1
    for i in data:
        n *= mesh.size(i)
    if not data or xe.shape[1] % n:
        return xe
    pl = tuple(Shard(1) if i in data else p
               for i, p in enumerate(xe.placements))
    return xe.redistribute(mesh, pl)


def _moe_dispatch_sharded(params, x, cfg: MoECfg, swiglu: bool = True):
    """`_moe_dispatch` on DTensors.  The routing covers every token of the
    group, as the reference's (capacity and ranks are global), so it runs
    on the tokens gathered to every rank, on the local tensors, from the
    router's logits taken on the tokens cut over every mesh dim; the
    expert products are DTensor batched matmuls of the slots cut over the
    data axes (`_slots_over_data`) that take the experts' placements (the
    expert dim over 'model' with EP, expert_ff with TP-in-expert, and the
    data axes under FSDP); the combine runs on the slot outputs gathered
    back."""
    from torch.distributed.tensor import Replicate
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_routed, cfg.top_k
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim

    def dispatch(xl, logits):
        r = route({}, xl, cfg, logits)
        valid = r["valid_slot"]
        xe = xl[r["tok_of_slot"].long()] * valid[..., None].to(xl.dtype)
        w = (r["gate_of_slot"] * valid)[..., None].to(xl.dtype)
        me = torch.softmax(r["logits"], dim=-1).mean(dim=0)
        fe = _bincount(r["flat_e"], E).float() / (T * K)
        return (xe, w, r["tok_slots"], E * (me * fe).sum(),
                1.0 - valid.sum() / (T * K))

    xf = x.reshape(T, D)
    # its gradient held to its own placements: the rows may come back cut
    # over more ranks than the batch dim, which the fold's backward (a
    # view to (B, S, D)) cannot express
    pl = tuple(xf.placements)
    xf = on_local_shards(lambda t: t, (xf,), (pl,), pl)
    # the router and the gather read xf through one view, as in
    # `_moe_dispatch`: their gradients meet there before the shared
    # experts' (the same sums in the same order)
    xd = xf.view(T, D)
    logits = linear(_rows_over_mesh(xd).float(), params["router"])
    xe, w, tok_slots, lb, drop = on_local_shards(
        dispatch, (xd, logits), (rep, rep), (rep,) * 5)
    ye = _experts(params, _slots_over_data(xe, params["w_up"]),
                  swiglu).redistribute(mesh, rep)

    def combine(yel, wl, slots):
        C = yel.shape[1]
        yw = torch.cat([(yel * wl).reshape(E * C, D),
                        torch.zeros((1, D), dtype=yel.dtype,
                                    device=yel.device)])
        out = torch.zeros((T, D), dtype=yel.dtype, device=yel.device)
        for j in range(K):
            out = out + yw[slots[:, j]]
        return out

    out = on_local_shards(combine, (ye, w, tok_slots), (rep, rep, rep), rep)
    if cfg.n_shared:
        shared = _shared(params, xf, swiglu)
        # gathered to the combine's placement: DTensor may leave the sum's
        # rows cut over more ranks than the batch dim, which the view
        # back to (B, S, D) cannot express
        out = out + shared.redistribute(mesh, rep)
    back = [Replicate() if p.is_partial() else p for p in x.placements]
    out = out.reshape(B, S, D).redistribute(mesh, back)
    return out, {"lb_loss": lb, "drop_frac": drop}
