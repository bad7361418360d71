"""Solver objects (the ``psi`` step functions of paper Algo 1) + registry.

This slice ports the :class:`Solver` interface and :class:`ALF`, the
Asynchronous Leapfrog solver MALI is defined on. The Runge-Kutta tableaus
of the JAX package come with a later slice; ``get_solver`` names it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from .alf import (alf_step, alf_step_with_error, check_backend, check_eta,
                  init_velocity)
from .dense import pad_dead_rows, shift_to_step_ends

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]
# trial(state, t, h) -> (state_next, err_ratio); err_ratio <= 1 accepts.
TrialFn = Callable[[Pytree, torch.Tensor, torch.Tensor],
                   Tuple[Pytree, torch.Tensor]]


class Solver:
    """Interface shared by every solver (Table 1's solver axis).

    ``init_state``/``output`` mediate between the user-facing state ``z``
    and the solver's internal state (ALF augments it with the tracked
    velocity ``v``); ``trial_fn`` closes a uniform trial step
    ``(state, t, h) -> (state_next, err_ratio)`` over a controller.
    """

    name: str = "?"
    order: int = 0
    stages: int = 1                 # f-evals per (trial) step
    has_error_estimate: bool = False

    def init_state(self, f: Dynamics, params: Pytree, z0: Pytree,
                   t0: torch.Tensor) -> Pytree:
        return z0

    def output(self, state: Pytree) -> Pytree:
        return state

    def trial_fn(self, f: Dynamics, params: Pytree, controller) -> TrialFn:
        raise NotImplementedError

    def kernel_step_ops(self) -> Tuple[str, ...]:
        """Registry qualnames ("<package>.<op>") of the kernel ops this
        solver's trial step launches; () when the step is plain PyTorch.
        :func:`repro_torch.core.naive.check_direct_backprop` refuses the
        solver if any of them is forward-only."""
        return ()

    def interpolant(self, f: Dynamics, params: Pytree, states: Pytree,
                    state_end: Pytree, ts: torch.Tensor, hs: torch.Tensor,
                    n_live: torch.Tensor):
        """Per-step endpoint data ``(y0, d0, y1, d1)`` for dense output.

        ``states`` is the recorded (bound, ...) buffer of accepted-step
        start solver states, ``state_end`` the final solver state,
        ``ts``/``hs`` the signed step times and sizes (rows past
        ``n_live`` are padding, backfilled with the end state so ``f``
        never sees the zeros). The default re-evaluates ``f`` at both step
        endpoints, batched over the whole buffer with ``torch.func.vmap``;
        solvers whose state carries a velocity (:class:`ALF`) read the
        slope off it instead."""
        from torch.func import vmap
        ends = shift_to_step_ends(states, state_end, n_live)
        y0 = self.output(pad_dead_rows(states, state_end, n_live))
        y1 = self.output(pad_dead_rows(ends, state_end, n_live))
        eval_f = vmap(lambda z, t: f(params, z, t))
        return y0, eval_f(y0, ts), y1, eval_f(y1, ts + hs)

    def interpolant_fevals(self, bound: int) -> int:
        """Dynamics evaluations :meth:`interpolant` spends over ``bound``
        recorded rows (two batched passes by default)."""
        return 2 * bound


@dataclasses.dataclass(frozen=True)
class ALF(Solver):
    """Asynchronous Leapfrog (paper Algo 2): the invertible solver MALI is
    defined on. State is the augmented ``(z, v)`` pair with
    ``v0 = f(z0, t0)`` (paper Sec 3.1); ``eta`` is the damping coefficient
    of Appendix A.5.

    ``backend='cuda'`` runs the step's elementwise state algebra through
    the fused :mod:`repro_torch.kernels.alf_step` kernels (one flat pass
    over the whole state pytree per op) instead of per-leaf tensor ops.
    The step's ops carry reverse rules (kernels too), so every gradient
    consumer accepts this backend: MALI's backward launches the fused
    backward or the inverse kernels, and direct backprop (``Naive``,
    ``SaveAt(steps|dense)``) differentiates through the launches."""

    eta: float = 1.0
    backend: str = "reference"

    name = "alf"
    order = 2
    stages = 1
    has_error_estimate = True       # embedded 1st-vs-2nd order estimate

    def __post_init__(self):
        check_eta(self.eta)
        check_backend(self.backend)

    def init_state(self, f, params, z0, t0):
        return (z0, init_velocity(f, params, z0, t0))

    def output(self, state):
        return state[0]

    def trial_fn(self, f, params, controller) -> TrialFn:
        if not controller.adaptive:
            # Every trial is accepted: skip the (unused) error estimate.
            def fixed_trial(state, t, h):
                z, v = state
                z1, v1 = alf_step(f, params, z, v, t, h, self.eta,
                                  self.backend)
                return (z1, v1), controller.error_ratio(None, z, z1)

            return fixed_trial

        def trial(state, t, h):
            z, v = state
            z1, v1, err = alf_step_with_error(f, params, z, v, t, h,
                                              self.eta, self.backend)
            return (z1, v1), controller.error_ratio(err, z, z1)

        return trial

    def kernel_step_ops(self) -> Tuple[str, ...]:
        if self.backend != "cuda":
            return ()
        return ("alf_step.alf_midpoint", "alf_step.alf_update")

    def interpolant(self, f, params, states, state_end, ts, hs, n_live):
        """ALF dense output from the velocity pair: the augmented state
        tracks ``v ~ dz/dt`` at every node, so the Hermite slopes come off
        the recorded ``(z, v)`` with zero extra ``f`` evaluations."""
        ends = shift_to_step_ends(states, state_end, n_live)
        z0s, v0s = pad_dead_rows(states, state_end, n_live)
        z1s, v1s = pad_dead_rows(ends, state_end, n_live)
        return z0s, v0s, z1s, v1s

    def interpolant_fevals(self, bound: int) -> int:
        return 0


SOLVERS = {"alf": ALF()}

# Solver names of the JAX package that land with a later slice.
_LATER = ("euler", "heun2", "heun_euler", "midpoint", "bosh3", "rk23", "rk2",
          "rk4", "dopri5")


def get_solver(name) -> Solver:
    """Resolve a solver: pass through :class:`Solver` instances, look up
    string names in the registry."""
    if isinstance(name, Solver):
        return name
    if name in _LATER:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet: the Runge-Kutta solvers "
            "land with the RK/ACA/Backsolve slice (ROADMAP queue 1)")
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered solver names: "
            f"{', '.join(sorted(SOLVERS))} (or pass a Solver instance)") \
            from None
