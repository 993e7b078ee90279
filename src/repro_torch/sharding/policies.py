"""Sharding policies: semantic axis roles -> mesh specs and DTensor
placements (port of `repro/sharding/policies.py`).

Model init returns a `roles` tree mirroring params, each leaf a tuple of
axis-role names (`models/layers.py`).  The policy maps roles onto the mesh,
driven by divisibility, with the reference's decisions:

  - Megatron TP on 'model': vocab, ff, merged q/kv head dims, MoE expert_ff
    or expert axis (EP when n_routed % model == 0), mamba inner dims; one
    model axis per tensor.
  - FSDP: when params x 2 bytes / model > FSDP_THRESHOLD_BYTES, the largest
    remaining divisible dim also takes the data axes.
  - ZeRO: optimizer moments (and the float32 gradient accumulator) take the
    param spec plus the data axes on the largest remaining divisible dim.
  - Decode caches: sequence-sharded over 'model' (flash-decoding); with
    batch 1 (long_500k) the sequence takes every axis.

The reference stacks each pattern position's parameters over the
super-blocks, (n_super, ...), and its decisions read that leading dim (a
ZeRO dim may be it).  The port keeps one tensor per super-block, so every
function here folds the port's trees into the reference's stacked layout
(`stack`), decides there, and unfolds (`unstack`): a super-block's tensor
takes the stacked spec less its leading dim.  Each leaf's result is a
`Sharding`: `spec`, the mesh axes per tensor dim (None, a name, or a tuple
of names sharded major to minor: the `PartitionSpec` form), `placements`,
the DTensor placements it implies (one per mesh dim), and for a
super-block leaf `layer_axis`, what the stacked form puts on the layer dim.
A stacked spec that shards the layer dim (the reference's ZeRO of
mamba2-370m's per-head vectors and conv leaves on (16, 16), 48 layers over
16) has no per-tensor placement: the port's per-layer tensors stay
replicated over that axis (ROADMAP.md queue 3).

`mesh` is a `DeviceMesh` or a `launch.mesh.AbstractMesh`: only its axis
names and sizes are read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.launch.mesh import axis_sizes

Tree = Any


@dataclasses.dataclass(frozen=True)
class Policy:
    model_axis: str = "model"
    data_axes: tuple = ("data",)
    moe_ep: bool = True
    attn_tp: bool = True          # informational (activation-level choice)
    zero_opt: bool = True
    fsdp_params: bool = False     # shard params over data too (ZeRO-3 style)

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


# Param bytes per card above which TP-only param residency can't fit and
# the policy adds data-axis (FSDP) param sharding.
FSDP_THRESHOLD_BYTES = 8e9


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's placement: `spec` per tensor dim (PartitionSpec form),
    `placements` per mesh dim (DTensor), `layer_axis` the stacked form's
    axis on the layer dim of a super-block leaf (else None)."""
    spec: tuple
    placements: tuple
    layer_axis: Any = None

    @property
    def stacked_spec(self) -> tuple:
        return (self.layer_axis,) + self.spec


def _names(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec: mesh dim `a` -> Shard(d) where the
    spec's dim d names `a`, else Replicate().  A dim over several axes is
    sharded major to minor in the spec's order, which must follow the
    mesh's.  An axis of size 1 shards nothing: Replicate() there (DTensor
    will not reshape a dim sharded over it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        axes = _names(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must follow "
                             f"the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def sharding(spec, mesh, layer_axis=None) -> Sharding:
    spec = tuple(spec)
    return Sharding(spec, placements_for(spec, mesh), layer_axis)


def _size(mesh, ax) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _names(ax))


def _data_size(pol: Policy, mesh) -> int:
    return _size(mesh, pol.data_axes)


# ---------------------------------------------------------------------------
# The port's layout <-> the reference's stacked layout
# ---------------------------------------------------------------------------

def _walk(fn, tree, *rest, path=()):
    """fn(path, leaf, *matching leaves) over a tree of dicts and lists whose
    leaves are tensors, role tuples, spec tuples or `Sharding`s."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _leaves(tree) -> list:
    out = []
    _walk(lambda p, x: out.append(x), tree)
    return out


def _stack_leaf(items: list):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.empty((len(items),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
    if isinstance(first, Sharding):
        if any(s != first for s in items):
            raise ValueError("stack: super-blocks with different shardings")
        return first.stacked_spec
    if any(r != first for r in items):
        raise ValueError("stack: super-blocks with different roles")
    return ("layers",) + first


def _stack_list(supers: list):
    """[tree per super-block] -> {"i": stacked leaf} (the reference's
    `supers` dict of position keys, each leaf with a leading layer dim)."""
    def stack(path, first, *others):
        return _stack_leaf([first, *others])
    return _walk(stack, supers[0], *supers[1:])


def stack(tree):
    """The port's tree -> the reference's stacked layout: every `supers`
    list of per-super-block trees becomes one tree whose leaves have a
    leading layer dim (tensors as meta tensors of the stacked shape, roles
    with "layers" in front, `Sharding`s as their stacked spec tuples)."""
    if isinstance(tree, dict):
        return {k: (_stack_list(v) if k == "supers" and isinstance(v, list)
                    else stack(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stack(v) for v in tree]
    if isinstance(tree, Sharding):
        return tree.spec
    return tree


def unstack(spec_tree, mesh, n_supers: dict, path=()):
    """The reference's layout of spec tuples -> the port's tree of
    `Sharding`s: each stacked `supers` leaf becomes one per super-block,
    its spec less the leading dim.  `n_supers` maps the path of each
    `supers` node to its number of super-blocks."""
    if isinstance(spec_tree, dict):
        out = {}
        for k, v in spec_tree.items():
            p = path + (k,)
            if k == "supers" and p in n_supers:
                one = _walk(lambda _, s: sharding(s[1:], mesh, s[0]), v)
                out[k] = [one for _ in range(n_supers[p])]
            else:
                out[k] = unstack(v, mesh, n_supers, p)
        return out
    if isinstance(spec_tree, list):
        return [unstack(v, mesh, n_supers, path + (i,))
                for i, v in enumerate(spec_tree)]
    return sharding(spec_tree, mesh)


def _supers_counts(tree, path=(), out=None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "supers" and isinstance(v, list):
                out[path + (k,)] = len(v)
            else:
                _supers_counts(v, path + (k,), out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _supers_counts(v, path + (i,), out)
    return out


def _map_stacked(fn, port_tree, *rest):
    """fn over the reference's layout of the port's trees; the result
    unfolded back to the port's layout as `Sharding`s."""
    mesh = fn.mesh
    counts = _supers_counts(port_tree)
    out = fn(stack(port_tree), *(stack(r) for r in rest))
    return unstack(out, mesh, counts)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

def resolve_policy(cfg: ModelConfig, mesh) -> Policy:
    from repro_torch.models.model import count_params
    sizes = axis_sizes(mesh)
    model_size = sizes["model"]
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    moe_ep = bool(cfg.moe and cfg.moe.n_routed % model_size == 0
                  and not cfg.moe.prefer_tp)
    attn_tp = cfg.attn.n_heads % model_size == 0
    fsdp = count_params(cfg) * 2 / model_size > FSDP_THRESHOLD_BYTES
    return Policy(data_axes=data_axes, moe_ep=moe_ep, attn_tp=attn_tp,
                  fsdp_params=fsdp)


def _role_axis(role: str | None, pol: Policy, cfg: ModelConfig, dim: int,
               model_size: int):
    if role is None:
        return None
    table = {
        "vocab": "model",
        "ff": "model",
        "qheads": "model",
        "kvheads": "model",
        "inner": "model",
        "inner_proj": "model",
        "conv_ch": "model",
        "expert_ff": None if pol.moe_ep else "model",
        "experts": "model" if pol.moe_ep else None,
        "embed": None,
        "heads": None,
        "layers": None,
    }
    axis = table.get(role)
    if axis == "model" and dim % model_size != 0:
        return None                      # divisibility guard
    return axis


def _largest_free(dims, spec, size):
    """Index of the largest dim still unsharded that divides by `size` (the
    last of equals, as the reference's max over (dim, index)), or None."""
    cands = [(d, i) for i, (d, s) in enumerate(zip(dims, spec))
             if s is None and d % size == 0 and d >= size]
    return max(cands)[1] if cands else None


def _param_specs_stacked(roles_s, shapes_s, cfg, mesh, policy=None):
    pol = policy or resolve_policy(cfg, mesh)
    model_size = axis_sizes(mesh)["model"]
    data_size = _data_size(pol, mesh)

    def one(path, role_tuple, shp):
        dims = tuple(shp.shape)
        spec = []
        used_model = False
        for role, d in zip(role_tuple, dims):
            ax = _role_axis(role, pol, cfg, d, model_size)
            if ax == "model" and used_model:
                ax = None                # one model axis per tensor
            if ax == "model":
                used_model = True
            spec.append(ax)
        if pol.fsdp_params:
            idx = _largest_free(dims, spec, data_size)
            if idx is not None:
                spec[idx] = pol.dp
        return tuple(spec)

    return _walk(one, roles_s, shapes_s)


def param_specs(roles: Tree, shapes: Tree, cfg: ModelConfig, mesh,
                policy: Policy | None = None) -> Tree:
    """A `Sharding` per param leaf from its role tuple and shape.  Every
    function here takes `policy` (default: `resolve_policy(cfg, mesh)`):
    the dry run's cut configs are placed by their full config's."""
    def fn(r, s):
        return _param_specs_stacked(r, s, cfg, mesh, policy)
    fn.mesh = mesh
    return _map_stacked(fn, roles, shapes)


def _zero_stacked(specs_s, shapes_s, mesh, cfg, policy=None):
    pol = policy or resolve_policy(cfg, mesh)
    data_size = _data_size(pol, mesh)

    def one(path, spec, shp):
        spec = list(spec) + [None] * (len(shp.shape) - len(spec))
        if any("data" in _names(s) for s in spec):
            return tuple(spec)              # already data-sharded
        idx = _largest_free(tuple(shp.shape), spec, data_size)
        if idx is not None:
            spec[idx] = pol.dp
        return tuple(spec)

    return _walk(one, specs_s, shapes_s)


def zero_shard_specs(specs: Tree, shapes: Tree, mesh,
                     cfg: ModelConfig, policy: Policy | None = None) -> Tree:
    """Optimizer-state (and gradient-accumulator) shardings: the param
    spec plus the data axes on the largest remaining divisible dim (ZeRO-1
    partitioning of the moments)."""
    def fn(sp, sh):
        return _zero_stacked(sp, sh, mesh, cfg, policy)
    fn.mesh = mesh
    return _map_stacked(fn, specs, shapes)


def opt_state_specs(param_sharding: Tree, param_shapes: Tree, mesh,
                    cfg: ModelConfig, quantized: bool = False,
                    policy: Policy | None = None) -> Tree:
    """Shardings of the optimizer state tree.

    Plain: {'m', 'v'} fp32, ZeRO-sharded (param spec + data axis).
    Quantized: per leaf {'mq', 'ms', 'vq', 'v_lo', 'v_sc'}: the payload
    (..., F/256, 256) inherits the param's sharding with the last dim's
    axis moved to the F/256 dim (dropped where F/256 does not divide by
    it); leaves whose last dim does not divide by 256 keep fp32 {'m', 'v'},
    ZeRO-sharded."""
    from repro_torch.train.optimizer import quantizable
    z = zero_shard_specs(param_sharding, param_shapes, mesh, cfg, policy)
    if not quantized:
        return {"m": z, "v": z}
    sizes = axis_sizes(mesh)

    def one_stacked(path, spec, zspec, shp):
        if not quantizable(shp.shape):
            return {"m": zspec, "v": zspec}
        spec = list(spec) + [None] * (len(shp.shape) - len(spec))
        last = spec[-1]
        nb = shp.shape[-1] // 256
        last_ok = last is None or nb % math.prod(
            sizes[a] for a in _names(last)) == 0
        keep = last if last_ok else None
        q = tuple(spec[:-1]) + (keep, None)
        s = tuple(spec[:-1]) + (keep,)
        return {"mq": q, "ms": s, "vq": q, "v_lo": s, "v_sc": s}

    def fn(p, zz, sh):
        return _walk(one_stacked, p, zz, sh)
    fn.mesh = mesh
    return _map_stacked(fn, param_sharding, z, param_shapes)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                specs_tree: Tree, policy: Policy | None = None) -> Tree:
    """Shardings matching `model.input_specs(shape)`."""
    pol = policy or resolve_policy(cfg, mesh)
    B = shape.global_batch
    bspec = pol.dp if B % _data_size(pol, mesh) == 0 else None

    def spec_for(key: str, t):
        nd = len(t.shape)
        if key in ("tokens", "labels", "token", "enc_frames", "img_embed"):
            return sharding((bspec,) + (None,) * (nd - 1), mesh)
        return sharding((), mesh)

    out = {}
    for k, v in specs_tree.items():
        if k == "caches":
            out[k] = cache_specs(cfg, shape, mesh, v, pol)
        else:
            out[k] = spec_for(k, v)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                caches: Tree, policy: Policy | None = None) -> Tree:
    """Decode-cache shardings.

    Attention k/v (n_super, B, S, K, hd) in the stacked form: sequence
    over 'model' (flash-decoding); batch over the data axes.  With batch 1
    (long_500k) the sequence takes every axis.  Mamba ssm (n_super, B, H,
    N, P): heads over 'model'.  Conv (n_super, B, K-1, CH): channels over
    'model'."""
    pol = policy or resolve_policy(cfg, mesh)
    model_size = axis_sizes(mesh)["model"]
    dp_size = _data_size(pol, mesh)
    all_axes = pol.data_axes + ("model",)
    all_size = dp_size * model_size

    def one_leaf(path, t):
        dims = tuple(t.shape)
        nd = len(dims)
        name = str(path[-1])
        if name == "ssm":
            lead = nd - 4
            B, H = dims[lead], dims[lead + 1]
            b = pol.dp if B % dp_size == 0 and B > 1 else None
            h = "model" if H % model_size == 0 else None
            return (None,) * lead + (b, h, None, None)
        if name == "conv":
            lead = nd - 3
            B, CH = dims[lead], dims[lead + 2]
            b = pol.dp if B % dp_size == 0 and B > 1 else None
            c = "model" if CH % model_size == 0 else None
            return (None,) * lead + (b, None, c)
        # attention caches k/v/xk/xv: (..., B, S, K, hd)
        lead = nd - 4
        B, S = dims[lead], dims[lead + 1]
        if B % dp_size == 0 and B > 1:
            b = pol.dp
            s = "model" if S % model_size == 0 else None
        else:
            b = None
            s = all_axes if S % all_size == 0 else (
                "model" if S % model_size == 0 else None)
        return (None,) * lead + (b, s, None, None)

    def fn(c):
        return _walk(one_leaf, c)
    fn.mesh = mesh
    return _map_stacked(fn, caches)


def count_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of `shape` under `spec`
    (every sharded dim divides by its axes, as the policies guarantee)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _size(mesh, ax) for d, ax in zip(shape, spec))


# ---------------------------------------------------------------------------
# Trees of DTensors
# ---------------------------------------------------------------------------

def distribute(tree: Tree, shardings: Tree, mesh) -> Tree:
    """Each leaf (the whole tensor, the same on every rank) as a DTensor of
    its `Sharding`'s placements: every rank keeps only its shard."""
    from torch.distributed.tensor import distribute_tensor
    return _walk(lambda _, t, s: distribute_tensor(t, mesh, s.placements),
                 tree, shardings)


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of `full` (the whole tensor, held by this rank)
    under `placements` on `mesh`, as `distribute` would keep it, taken
    without a collective: each mesh dim that shards a tensor dim splits it
    in its turn, major to minor (a view of `full`)."""
    out = full
    for i, p in enumerate(placements):
        if p.is_shard():
            parts = torch.chunk(out, mesh.size(i), dim=p.dim)
            k = mesh.get_local_rank(i)
            out = parts[k] if k < len(parts) else out.narrow(p.dim, 0, 0)
    return out


def meta_dtensors(shapes: Tree, shardings: Tree, mesh) -> Tree:
    """Each leaf of a tree of meta tensors as a DTensor whose local shard
    is a meta tensor of the shard's shape (nothing allocated): the dry
    run's params, optimizer state and batch."""
    from torch.distributed.tensor import DTensor

    def one(_, t, s):
        local = torch.empty(local_shape(tuple(t.shape), s.spec, mesh),
                            dtype=t.dtype, device="meta")
        full = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, s.placements, run_check=False,
                                  shape=full.shape, stride=full.stride())
    return _walk(one, shapes, shardings)


def local_bytes(tree: Tree) -> int:
    """Bytes of this rank's shards of the tree's DTensor leaves (a plain
    tensor counts whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total
