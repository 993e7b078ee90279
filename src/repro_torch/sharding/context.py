"""Activation-sharding context (port of `repro/sharding/context.py`): models
stay mesh-agnostic, launchers install a policy that turns logical axis tags
into redistributions of DTensors.

    with sharding_ctx(mesh, policy):
        ...  # model code calls constrain(x, ("data", None, "model"))

Outside a context, or on a plain tensor (unit tests, single-device runs),
`constrain` is identity.  Logical axes: 'data' -> the policy's data axes
(('pod', 'data') on multi-pod), 'model' -> the model axis.  Dims that do
not divide by their mesh axes are left unsharded.  The reference's
`with_sharding_constraint` becomes `DTensor.redistribute`.

Also the model's helpers for DTensors: `is_dtensor`; `replicate_like` (a
plain tensor made on every rank, wrapped as a replicated DTensor on
another's mesh, so that the two mix); `on_local_shards` (a function, a
hand-written kernel's wrapper among them, run on each rank's local
shards: `local_map`); `split_heads` / `merge_heads` / `evenly` (views of
merged head dims that DTensor's view rules cannot take as they are).
"""
from __future__ import annotations

import contextlib
import math

import torch

_STATE: dict = {"mesh": None, "dp": None}


@contextlib.contextmanager
def sharding_ctx(mesh, policy):
    old = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["dp"] = policy.dp
    try:
        yield
    finally:
        _STATE.update(old)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axis_size(mesh, ax) -> int:
    from repro_torch.launch.mesh import axis_sizes
    if ax is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                        else (ax,)))


def constrain(x, axes: tuple):
    """axes: logical tags per dim ('data' | 'model' | None)."""
    mesh = _STATE["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    from repro_torch.sharding.policies import placements_for
    spec = []
    for d, tag in zip(x.shape, axes):
        ax = _STATE["dp"] if tag == "data" else ("model" if tag == "model"
                                                 else None)
        if ax is not None and d % _axis_size(mesh, ax) != 0:
            ax = None
        spec.append(ax)
    placements = placements_for(tuple(spec), x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def replicate_like(ref, t: torch.Tensor):
    """`t` as it is where `ref` is a plain tensor; where `ref` is a DTensor,
    `t` (the same on every rank) as a replicated DTensor on its mesh."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t.to(ref.device), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def split_heads(t, shape: tuple):
    """t.reshape(shape), t's last dim (n * hd, merged heads) split into (n,
    hd).  A DTensor whose last dim is sharded mid-head (the reference's
    kvheads: K * hd = 8 * 128 over 16 ranks is half a head each) is first
    gathered over the mesh dims that cut the heads, so each rank holds
    whole heads (GSPMD's implicit regather, made explicit)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        d = t.ndim - 1
        cut = [i for i, p in enumerate(t.placements) if p.is_shard(d)]
        if cut and shape[-2] % math.prod(t.device_mesh.size(i)
                                         for i in cut):
            pl = [Replicate() if i in cut else p
                  for i, p in enumerate(t.placements)]
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(shape)


def evenly(t):
    """A DTensor with any dim sharded unevenly (a size its mesh dim does
    not divide, which DTensor's sharding rules may leave behind) gathered
    over that mesh dim: a view cannot merge or split such a dim."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and t.shape[p.dim]
          % t.device_mesh.size(i) else p for i, p in enumerate(t.placements)]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def merge_heads(t, shape: tuple):
    """t.reshape(shape), t's last two dims (n, hd) merged.  On a DTensor
    whose heads are not sharded, the merged tensor's gradient is held to
    the same placements, so that autograd's split of it (the view's
    backward) never meets a merged dim sharded mid-head."""
    if is_dtensor(t):
        t = evenly(t)
    out = t.reshape(shape)
    if not is_dtensor(out) or any(p.is_shard(out.ndim - 1)
                                  for p in out.placements):
        return out
    pl = tuple(out.placements)
    return on_local_shards(lambda x: x, (out,), (pl,), pl)


def batch_heads_placements(mesh, batch: int, head_dim: int | None = None):
    """Placements of an activation with a batch dim 0: the batch over
    every data axis where it divides, dim `head_dim` over 'model' (None:
    replicated there); an axis of size 1 replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    data = [a for a in mesh.mesh_dim_names if a != "model"]
    b_ok = batch % math.prod(sizes[a] for a in data) == 0
    out = []
    for a in mesh.mesh_dim_names:
        if sizes[a] == 1:
            out.append(Replicate())
        elif a == "model":
            out.append(Replicate() if head_dim is None else Shard(head_dim))
        else:
            out.append(Shard(0) if b_ok else Replicate())
    return tuple(out)


def row_block(mesh, placements) -> tuple[int, int]:
    """(this rank's block, blocks) of a tensor's rows (dim 0) under
    `placements` on `mesh`: the mesh dims that shard dim 0, major to minor
    (ranks apart along the others hold the same rows)."""
    index, n = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(0):
            index = index * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return index, n


def on_local_shards(fn, args: tuple, in_placements: tuple, out_placements,
                    grad_placements: tuple | None = None):
    """fn over the local shards of DTensor `args`, each first redistributed
    to its placements (None: a non-tensor argument), the result wrapped
    back as DTensor(s) of `out_placements` (`local_map`): how a
    hand-written kernel runs under a DTensor.  `grad_placements`: those of
    each argument's gradient where they differ from its own (Partial for
    an input replicated over an axis whose ranks each use it for their
    shard of the work)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    moved = tuple(a.redistribute(mesh, pl) if pl is not None
                  and tuple(a.placements) != tuple(pl) else a
                  for a, pl in zip(args, in_placements))
    # local_map reads a list as one output's placements, a tuple as one
    # entry per output
    if all(isinstance(p, Placement) for p in out_placements):
        out = list(out_placements)
    else:
        out = tuple(list(p) for p in out_placements)
    ins = tuple(None if p is None else list(p) for p in in_placements)
    grads = None if grad_placements is None else tuple(
        None if p is None else list(p) for p in grad_placements)
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*moved)
