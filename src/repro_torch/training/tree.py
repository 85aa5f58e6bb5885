"""Nested dict/list trees of tensors (parameters, gradients, optimizer
state): the port's stand-in for ``jax.tree``.  Leaves are visited in the
tree's own order (dict insertion order, list order); trees are zipped by
key and index, so two trees with one structure pair up whatever the order
their dicts were built in."""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from repro_torch.models.registry import leaves  # noqa: F401  (the tree's leaves, in order)


def map_(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the leaves at the same place in
    ``rest`` -> a tree of ``tree``'s structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return [map_(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]


def zip_leaves(tree, *rest) -> list[tuple]:
    """(leaf of tree, leaf of each of rest at the same place), in tree's order."""
    out: list[tuple] = []
    map_(lambda *ts: out.append(ts), tree, *rest)
    return out


def unflatten(like, flat: list):
    """The leaves ``flat`` (in ``leaves(like)``'s order) in ``like``'s structure."""
    it: Iterator = iter(flat)
    out = map_(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path of keys and indices, leaf) for every leaf, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pl for k, v in items for pl in with_paths(v, prefix + (k,))]
