"""Carry parameter trees between numpy (the JAX package's host form) and
the port's tensors, keeping the structure: nested dicts, lists and tuples.

Tests and ``chip_smoke.py`` make parameters once with numpy from a seed and
hand the same arrays to both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree_util as pytree

from .device import resolve_device

Pytree = Any


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, float, int))


def params_from_numpy(tree: Pytree, device=None, dtype=None) -> Pytree:
    """Numpy leaves -> tensors on ``device`` (default: the CUDA card),
    optionally cast to ``dtype``. Non-array leaves are refused."""
    dev = resolve_device(device)

    def leaf(x):
        if not _is_array(x):
            raise TypeError(f"params_from_numpy: leaf {x!r} is not a numpy "
                            "array or Python number")
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return pytree.tree_map(leaf, tree)


def params_to_numpy(tree: Pytree) -> Pytree:
    """Tensors -> numpy arrays on the host. bfloat16 leaves come back as
    float32 (numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return pytree.tree_map(leaf, tree)
