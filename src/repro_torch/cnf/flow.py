"""FFJORD-class continuous normalizing flow on top of ``solve()``.

A :class:`CNF` turns a vector field ``f(params, z, t)`` into a density
model through the instantaneous change of variables (Chen et al. 2018)::

    d z / dt      = f(z, t)
    d logdet / dt = +tr(df/dz)         (log p(x) = log N(z_T; 0, I)
    d kinetic/ dt = |f|^2                          + logdet_T)
    d eps / dt    = 0                  (the fixed trace probe)

The augmented state goes through the ordinary ``solve()`` front door, so
every axis composes: MALI keeps its O(T * N_z) residuals over the
augmented state, ``ALF(backend="cuda")`` runs the step algebra of the
whole state (packed into one buffer) in the ALF kernels, and
``diff_bounds=True`` makes the span trainable. Under :class:`Exact` the
probe is ``None``, an empty node of the state tree
(:mod:`repro_torch.tree_util`).

``log_prob`` integrates data -> base over [t0, t1] accumulating ``+tr``;
``sample`` runs the same dynamics in reverse time (t1 -> t0) from base
noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import Solution, solve
from repro_torch.core.interface import Batching, SaveAt
from repro_torch.tree_util import vmap

from .estimators import Hutchinson, TraceEstimator, get_estimator

Pytree = Any
VectorField = Callable[[Pytree, torch.Tensor, torch.Tensor], torch.Tensor]


class CNFResult(NamedTuple):
    """``log_prob``'s output: per-sample log density (nats), the logdet
    and kinetic-energy integrals, and the underlying :class:`Solution`."""
    logp: torch.Tensor
    logdet: torch.Tensor
    kinetic: torch.Tensor
    solution: Solution


@dataclasses.dataclass(frozen=True)
class CNF:
    """A continuous normalizing flow: a vector field, a trace estimator
    and a default span.

    ``vfield(params, z, t)`` maps a single state of shape (dim,) to its
    velocity; a batch-shaped state is vmapped per sample inside the
    augmented dynamics, so one field serves unbatched and ``Lockstep``
    solves.
    """

    vfield: VectorField
    dim: int
    estimator: TraceEstimator = Hutchinson()
    t0: float = 0.0
    t1: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "estimator", get_estimator(self.estimator))

    # -- augmented dynamics -------------------------------------------------

    def _aug(self, params, state, t):
        z, _, _, eps = state

        def one(zi, ei):
            fz, tr = self.estimator.value_and_trace(
                lambda zz: self.vfield(params, zz, t), zi, ei)
            return fz, tr, torch.sum(fz ** 2)

        if z.dim() == 1:
            dz, dld, dk = one(z, eps)
        else:
            dz, dld, dk = vmap(one)(z, eps)
        d_eps = None if eps is None else torch.zeros_like(eps)
        return (dz, dld, dk, d_eps)

    def _state0(self, x, generator):
        bshape = x.shape[:-1]
        return (x, x.new_zeros(bshape), x.new_zeros(bshape),
                self.estimator.init_noise(generator, x))

    def _base_logp(self, z):
        return (-0.5 * torch.sum(z ** 2, -1)
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    # -- densities & sampling ----------------------------------------------

    def log_prob(self, params: Pytree, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 solver=None, controller=None, gradient=None,
                 t0=None, t1=None, diff_bounds: bool = False,
                 batching: Optional[Batching] = None) -> CNFResult:
        """Per-sample ``log p(x)`` in nats for ``x`` of shape (..., dim).

        ``generator`` draws the per-solve trace probe (required by
        Hutchinson, ignored by Exact). ``t0``/``t1`` override the span;
        pass tensors with ``diff_bounds=True`` to train them. The solve
        axes pass straight through.
        """
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        sol = solve(self._aug, params, self._state0(x, generator), t0, t1,
                    solver=solver, controller=controller, gradient=gradient,
                    batching=batching, diff_bounds=diff_bounds)
        z_t, logdet, kinetic, _ = sol.ys
        return CNFResult(self._base_logp(z_t) + logdet, logdet, kinetic,
                         sol)

    def sample(self, params: Pytree, generator: torch.Generator, n: int, *,
               solver=None, controller=None, gradient=None,
               saveat: Optional[SaveAt] = None,
               batching: Optional[Batching] = None) -> Solution:
        """Draw ``n`` samples on the generator's device: z ~ N(0, I), then
        the same augmented dynamics integrated in reverse time t1 -> t0.
        Returns the :class:`Solution`: ``ys[0]`` is the (n, dim) sample
        batch, or the (T, n, dim) flow path under
        ``saveat=SaveAt(ts=descending_grid)``."""
        z = torch.randn((n, self.dim), generator=generator,
                        device=generator.device)
        return solve(self._aug, params, self._state0(z, generator),
                     self.t1, self.t0, solver=solver, controller=controller,
                     gradient=gradient, saveat=saveat, batching=batching)
