"""Host trees with the reference's leaf keys.

The reference names a leaf by its `jax.tree_util` path, each part joined
with "/": a dict key as itself (dicts flatten in sorted key order), a
NamedTuple field as ".<name>" (in field order), a list or tuple item as
its index.  The port's trees are dicts
(and lists) of arrays or tensors; a `Fields` dict stands for a NamedTuple, so
`leaf_paths` emits the reference's keys for the same tree (an agent
snapshot's `stream/.params/w0`, `stream/.opt_state/m/w0`,
`stream/.replay/.s`, `stream/.rng`, ...) and `unflatten` maps them back.
The agent's snapshots (`core.agent`) and the checkpoints
(`train.checkpoint`) both build on it.

`tree_map`, `tree_leaves` and `tree_unflatten` walk the
model's trees (nested dicts and lists of tensors) for the optimizers and
the train step, in `jax.tree.leaves` order (dict keys sorted, lists in
order).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = Any


class Fields(dict):
    """A dict that stands for a NamedTuple in a checkpointed tree: its keys
    are field names, kept in insertion (field) order, and each names its
    leaves ".<field>" as `jax.tree_util` names a NamedTuple's fields."""

    def replace(self, **kw) -> "Fields":
        return Fields({**self, **kw})


def _is_leaf(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor))


def leaf_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) for every leaf of `tree`, in the reference's flatten
    order and with its key strings (see module docstring)."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    join = lambda part: f"{prefix}/{part}" if prefix else part
    if isinstance(tree, Fields):
        items = [(f".{k}", v) for k, v in tree.items()]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list) or type(tree) is tuple:
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        raise TypeError(f"checkpoint tree: unsupported node {type(tree)!r}")
    return [kv for part, v in items for kv in leaf_paths(v, join(part))]


def unflatten(template: Tree, leaves: dict[str, Any], prefix: str = ""):
    """`template`'s structure with each leaf replaced by `leaves[key]` (the
    reverse of `leaf_paths`)."""
    if _is_leaf(template):
        return leaves[prefix]
    join = lambda part: f"{prefix}/{part}" if prefix else part
    if isinstance(template, Fields):
        return Fields({k: unflatten(v, leaves, join(f".{k}"))
                       for k, v in template.items()})
    if isinstance(template, dict):
        return {k: unflatten(v, leaves, join(str(k)))
                for k, v in template.items()}
    if isinstance(template, list) or type(template) is tuple:
        return [unflatten(v, leaves, join(str(i)))
                for i, v in enumerate(template)]
    raise TypeError(f"checkpoint tree: unsupported node {type(template)!r}")


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of a tree of dicts and lists (and the matching
    subtrees of `rest`, passed whole wherever `tree` has a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in `jax.tree.leaves` order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Tree, leaves: list) -> Tree:
    """`template`'s structure with its leaves, in `tree_leaves` order,
    replaced by `leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)
