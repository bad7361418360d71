"""The JAX examples' hand-written Adam, in place on the tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree_util import tree_leaves, tree_map


_F32_09, _F32_0999 = float(np.float32(0.9)), float(np.float32(0.999))


class Adam:
    """The JAX examples' Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
    over a copy of ``params`` whose leaves require grad: the JAX updates
    are functional, so the caller's tree stays as it was. ``step(grads,
    i)`` writes step ``i`` (0-based) into :attr:`params`."""

    def __init__(self, params, lr: float):
        self.params = tree_map(
            lambda a: a.detach().clone().requires_grad_(True), params)
        self.leaves = tree_leaves(self.params)
        self.m = [torch.zeros_like(leaf) for leaf in self.leaves]
        self.v = [torch.zeros_like(leaf) for leaf in self.leaves]
        self.lr = lr

    def grads(self, loss):
        return torch.autograd.grad(loss, self.leaves)

    @torch.no_grad()
    def step(self, grads, i: int) -> None:
        # the bias corrections in float32, as the JAX examples' traced
        # step count takes them: the float32 decay rates raised to t, and
        # 1 - 0.999 ** t cancels, so the float64 rates would move the
        # update by ~2e-5 relative
        t = i + 1.0
        bc1 = float(np.float32(1.0) - np.float32(_F32_09 ** t))
        bc2 = float(np.float32(1.0) - np.float32(_F32_0999 ** t))
        for leaf, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            leaf.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8))
