"""Minimal tree utilities over NamedTuples, dataclasses, tuples, lists and
dicts of tensors — the port's stand-in for ``jax.tree.map``.

Dataclass fields declared with :func:`static_field` are metadata (dims,
manifolds, constraint sets) and are never mapped over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def static_field(**kwargs):
    """A dataclass field that tree functions leave alone (the counterpart
    of ``flax.struct.field(pytree_node=False)``)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static", False))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of ``tree`` (and the matching
    leaves of ``rest``); non-tensor leaves are returned unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {
            f.name: tree_map(
                fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
            )
            for f in dataclasses.fields(tree)
            if not _is_static(f)
        }
        return dataclasses.replace(tree, **changes)
    return tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def visit(a):
        out.append(a)
        return a

    tree_map(visit, tree)
    return out


def tree_unflatten(template: Any, leaves) -> Any:
    """Rebuild ``template``'s structure with ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def shared(tree: Any) -> Any:
    """``tree`` with a leading batch axis of 1 on every tensor leaf: one
    object shared by every element of a batch (see ``problem``)."""
    return tree_map(lambda a: a.unsqueeze(0), tree)


def detached(tree: Any) -> Any:
    """``tree`` with every tensor leaf detached: no tangent flows through
    it under forward-mode AD."""
    return tree_map(lambda a: a.detach(), tree)


def tree_where(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-batch-element select: every leaf carries the batch as its
    leading axis, ``mask`` is (B,) bool. The port's counterpart of the
    select ``jax.vmap`` inserts around a batched ``while_loop``/``cond``."""

    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)), n, o)

    return tree_map(sel, new, old)
