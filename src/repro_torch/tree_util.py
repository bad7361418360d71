"""Pytree helpers that treat ``None`` as the JAX package does: an empty
node, not a leaf.

``torch.utils._pytree`` counts ``None`` as a leaf (``tree_flatten((x, None,
x))`` gives three leaves), and ``torch.func``'s transforms refuse a
``None`` among their inputs or outputs. JAX flattens the same tree to two
leaves and maps around the ``None``. A state such as the CNF's
``(z, logdet, kinetic, None)`` under the exact trace estimator must pack,
map and differentiate the same way in both packages, so the port's core
and kernel ops flatten, map and transform trees through these helpers:

* :func:`tree_flatten` / :func:`tree_unflatten` / :func:`tree_leaves` /
  :func:`tree_leaves_with_keys` / :func:`tree_map` —
  ``torch.utils._pytree``'s, with every ``None`` kept in place and never
  passed to a mapped function or counted as a leaf;
* :func:`vjp` / :func:`vmap` — ``torch.func``'s, over the ``None``-free
  leaves of their arguments and results;
* :func:`rows_like` — a per-row (B,) tensor shaped to broadcast against a
  leaf with the batch axis in front (the ``PerSample`` step sizes and
  masks).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as _pt

Pytree = Any


def _is_none(x) -> bool:
    return x is None


class TreeSpec(NamedTuple):
    """A tree's structure: torch's spec with every ``None`` flattened as a
    leaf, and the positions of those ``None`` leaves."""
    spec: _pt.TreeSpec
    holes: Tuple[int, ...]


def tree_flatten(tree: Pytree) -> Tuple[List[Any], TreeSpec]:
    """The tree's leaves, ``None`` left out, and its :class:`TreeSpec`."""
    leaves, spec = _pt.tree_flatten(tree, is_leaf=_is_none)
    holes = tuple(i for i, leaf in enumerate(leaves) if leaf is None)
    if holes:
        leaves = [leaf for leaf in leaves if leaf is not None]
    return leaves, TreeSpec(spec, holes)


def tree_unflatten(leaves, spec: TreeSpec) -> Pytree:
    """Inverse of :func:`tree_flatten`: the ``None`` nodes come back at
    their places."""
    leaves = list(leaves)
    for i in spec.holes:
        leaves.insert(i, None)
    return _pt.tree_unflatten(leaves, spec.spec)


def tree_leaves(tree: Pytree) -> List[Any]:
    return [leaf for leaf in _pt.tree_leaves(tree, is_leaf=_is_none)
            if leaf is not None]


def tree_leaves_with_keys(tree: Pytree) -> List[Tuple[str, Any]]:
    """``(key string, leaf)`` pairs, ``None`` left out; the key is the
    leaf's path as ``torch.utils._pytree.keystr`` writes it."""
    flat, _ = _pt.tree_flatten_with_path(tree, is_leaf=_is_none)
    return [(_pt.keystr(path), leaf) for path, leaf in flat
            if leaf is not None]


def tree_map(fn: Callable, tree: Pytree, *rests: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rests``); a ``None`` of ``tree`` stays ``None``."""
    return _pt.tree_map(lambda x, *r: None if x is None else fn(x, *r),
                        tree, *rests, is_leaf=_is_none)


def _flat_fn(fn: Callable, in_spec: TreeSpec, out_specs: list) -> Callable:
    """``fn`` over a flat tuple of leaves, returning its result's leaves
    and recording the result's spec."""
    def flat(*leaves):
        out_leaves, out_spec = tree_flatten(
            fn(*tree_unflatten(leaves, in_spec)))
        out_specs.append(out_spec)
        return tuple(out_leaves)

    return flat


def vjp(fn: Callable, *primals: Pytree):
    """``torch.func.vjp`` over trees that may hold ``None``: returns
    ``(fn(*primals), pullback)``, where ``pullback(cotangent)`` gives one
    cotangent tree per primal."""
    leaves, in_spec = tree_flatten(primals)
    out_specs: list = []
    out, pull = torch.func.vjp(_flat_fn(fn, in_spec, out_specs), *leaves)
    out_spec = out_specs[-1]

    def pullback(cotangent: Pytree):
        return tree_unflatten(pull(tuple(tree_leaves(cotangent))), in_spec)

    return tree_unflatten(out, out_spec), pullback


def vmap(fn: Callable, in_dims=0) -> Callable:
    """``torch.func.vmap`` over the leading axis of every tensor of every
    argument; ``None`` arguments and results pass through unmapped.
    ``in_dims`` is 0, or one entry per argument: 0 maps every tensor of
    that argument, None passes it whole to every call."""
    def mapped(*args: Pytree):
        leaves, in_spec = tree_flatten(args)
        dims = 0
        if in_dims != 0:
            dims = tuple(d for a, d in zip(args, in_dims)
                         for _ in tree_leaves(a))
        out_specs: list = []
        out = torch.func.vmap(_flat_fn(fn, in_spec, out_specs),
                              in_dims=dims)(*leaves)
        return tree_unflatten(out, out_specs[-1])

    return mapped


def rows_like(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a`` as it is when 0-d; a (B,) ``a`` shaped (B, 1, ..., 1) to
    broadcast against ``x``, a leaf with the batch axis in front."""
    if a.dim() == 0:
        return a
    return a.reshape(a.shape + (1,) * (x.dim() - 1))
