"""Interpolant cache: dense solutions as a serving-layer cache line.

A ``SaveAt(dense=True)`` solve returns a :class:`~repro_torch.core.Solution`
whose cubic-Hermite interpolant answers ``evaluate(t)`` for ANY ``t`` in
the span from recorded knots alone — zero further dynamics evaluations.
That makes a dense solution the natural cache value for serving: the first
request for a trajectory pays the solve, every subsequent ``evaluate``
query on the same (vector field, config, z0) is a pure table read.

Keys are content hashes over the triple the trajectory is a function of:

* ``vf_id`` — caller-supplied identity of (vector field, params). The
  cache cannot see through a Python callable or a params tree, so the
  engine owns naming them; stale params under a reused id is the caller's
  bug, exactly like any externally-keyed cache.
* ``RequestConfig`` — span, tolerances, budget (different tolerances are
  different trajectories; hashed by value).
* ``z0`` bytes + shape + dtype per leaf, plus the tree structure. Dicts
  are hashed with their keys sorted: torch's pytree flattens a dict in
  insertion order, so ``{"y", "lam"}`` and ``{"lam", "y"}`` (the same
  state) must not land in two entries.

Eviction is pluggable via the registered :class:`CachePolicy` hierarchy:
:class:`LRU` with a bounded capacity, or :class:`NoCache` to turn the
layer off without touching engine code. Hit/miss/eviction counters feed
the serve report's ``cache_hit_rate``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree_util as pytree

from .scheduler import RequestConfig

Pytree = Any


def _sorted_keys(tree: Pytree) -> Pytree:
    """``tree`` with every dict rebuilt in sorted key order (the order
    the JAX package flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_sorted_keys(x) for x in tree)
    return tree


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CachePolicy:
    """Admission + eviction strategy for the interpolant cache."""

    name: str = "?"

    def admit(self, key: str) -> bool:
        """Whether to store a freshly solved entry at all."""
        raise NotImplementedError

    def victim(self, store: "OrderedDict[str, Any]") -> Optional[str]:
        """Key to evict when the store is over capacity (None = stop)."""
        raise NotImplementedError

    @property
    def capacity(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LRU(CachePolicy):
    """Least-recently-used eviction over a bounded store; ``get`` hits
    refresh recency."""

    max_entries: int = 64

    name = "lru"

    def __post_init__(self):
        if not isinstance(self.max_entries, int) or self.max_entries < 1:
            raise ValueError(
                f"LRU: max_entries must be a positive integer, got "
                f"{self.max_entries!r}")

    def admit(self, key: str) -> bool:
        return True

    def victim(self, store: "OrderedDict[str, Any]") -> Optional[str]:
        if len(store) <= self.max_entries:
            return None
        return next(iter(store))    # oldest = least recently used

    @property
    def capacity(self) -> int:
        return self.max_entries


@dataclasses.dataclass(frozen=True)
class NoCache(CachePolicy):
    """Caching disabled: admit nothing, every lookup misses. Lets load
    tests measure the uncached baseline through the identical engine
    path."""

    name = "none"

    def admit(self, key: str) -> bool:
        return False

    def victim(self, store: "OrderedDict[str, Any]") -> Optional[str]:
        return None

    @property
    def capacity(self) -> int:
        return 0


CACHE_POLICIES: Dict[str, CachePolicy] = {
    "lru": LRU(),
    "none": NoCache(),
}


class InterpolantCache:
    """Bounded store of dense solutions, keyed by content hash.

    The stored value is whatever the engine puts in — in practice a dense
    :class:`~repro_torch.core.Solution` whose ``evaluate(t)`` reads
    interpolant knots (0 f-evals). ``hits``/``misses``/``evictions`` are
    cumulative over the cache's lifetime and feed
    ``ServeReport.cache_hit_rate``.
    """

    def __init__(self, policy: Optional[CachePolicy] = None):
        self.policy = policy if policy is not None else LRU()
        if not isinstance(self.policy, CachePolicy):
            raise TypeError(
                f"policy must be a CachePolicy, got {self.policy!r}")
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def key(vf_id: str, config: RequestConfig, z0: Pytree) -> str:
        """Content hash of (vector-field id, request config, z0 bytes),
        dict keys taken in sorted order."""
        if not isinstance(config, RequestConfig):
            raise TypeError(
                f"config must be a RequestConfig, got {config!r}")
        h = hashlib.sha1()
        h.update(repr(vf_id).encode())
        h.update(repr(dataclasses.astuple(config)).encode())
        leaves, spec = pytree.tree_flatten(_sorted_keys(z0))
        h.update(repr(spec).encode())
        for leaf in leaves:
            arr = _host_array(leaf)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def get(self, key: str) -> Optional[Any]:
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)     # refresh recency
        self.hits += 1
        return entry

    def put(self, key: str, value: Any) -> None:
        if not self.policy.admit(key):
            return
        self._store[key] = value
        self._store.move_to_end(key)
        while True:
            victim = self.policy.victim(self._store)
            if victim is None:
                return
            del self._store[victim]
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
