"""Shared interface types of the composable ``solve()`` API.

* :class:`GradientMethod` — the gradient-estimation axis of paper Table 1.
  Each method validates its solver/controller compatibility (MALI => ALF),
  owns its autograd wiring, and integrates over an observation grid
  through one entry point.
* :class:`RunStats` — the raw accepted/trial counters a method's forward
  pass emits.
* :class:`Stats` / :class:`Solution` / :class:`SaveAt` — the user-facing
  result types of :func:`repro_torch.core.solve.solve`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .dense import DenseInterpolation

Pytree = Any


class RunStats(NamedTuple):
    """Step accounting from one forward integration (for fixed-step
    control rejected == 0)."""
    n_accepted: torch.Tensor   # int32: accepted solver steps, all segments
    n_rejected: torch.Tensor   # int32: rejected trial steps
    n_fevals: torch.Tensor     # int32: forward dynamics evaluations


def make_run_stats(n_accepted: torch.Tensor, n_trials: torch.Tensor,
                   stages: int, init_evals: int = 0) -> RunStats:
    """Fold raw driver counters into :class:`RunStats`. ``n_accepted`` may
    be per-segment (summed here); ``stages`` is the solver's f-evals per
    trial; ``init_evals`` covers ALF's ``v0 = f(z0, t0)``."""
    n_acc = torch.sum(n_accepted).to(torch.int32)
    n_tr = n_trials.to(torch.int32)
    return RunStats(n_acc, n_tr - n_acc, n_tr * stages + init_evals)


class Stats(NamedTuple):
    """``Solution.stats``: the paper's Table 1 accounting for one solve.

    ``n_fevals`` counts forward-pass dynamics evaluations (trials x stages
    + 1 for ALF's ``v0``). ``residual_bytes`` is the analytic
    backward-residual footprint of the gradient method (MALI: the
    per-observation (z, v) pairs, constant in step count), computed from
    shapes — not a measurement."""
    n_accepted: torch.Tensor   # int32
    n_rejected: torch.Tensor   # int32
    n_fevals: torch.Tensor     # int32
    n_segments: int            # observation segments (T - 1)
    residual_bytes: int        # analytic residual-memory estimate
    # Span-recording solves (SaveAt(steps=True)/dense=True) set this: False
    # when the AdaptiveController's max_steps budget ran out before t1, so
    # the record (and any interpolant over it) covers only a prefix of the
    # span. None where not tracked.
    span_complete: Optional[torch.Tensor] = None   # bool


class Solution(NamedTuple):
    """Result of :func:`repro_torch.core.solve.solve`: ``ys``/``ts`` are the
    end state and scalar ``t1`` (default), the (T, ...) trajectory over
    ``SaveAt.ts`` (``ys[0] == z0``), or the padded per-step record of
    ``SaveAt(steps=True)``, whose live rows :attr:`num_steps` /
    :attr:`step_mask` give. With ``SaveAt(dense=True)`` the solution is
    callable in time: :meth:`evaluate` interpolates the state anywhere in
    the span off per-step cubic-Hermite coefficients."""
    ys: Pytree
    ts: torch.Tensor
    stats: Stats
    # Dense-output record (SaveAt(dense=True)); None otherwise.
    interpolation: Optional[DenseInterpolation] = None
    # Live rows of the padded SaveAt(steps=True) buffer; None otherwise.
    n_live: Optional[torch.Tensor] = None

    @property
    def num_steps(self) -> torch.Tensor:
        """Accepted solver steps of the recorded trajectory; for
        ``SaveAt(steps=True)`` the live rows are ``0 .. num_steps``
        inclusive (the step-start states plus the final state)."""
        if self.n_live is not None:
            return self.n_live - 1
        return self.stats.n_accepted

    @property
    def step_mask(self) -> torch.Tensor:
        """Boolean mask over the rows of ``ts``/``ys``: all True for the
        exact-shape modes, True only for rows ``< n_live`` of the padded
        ``SaveAt(steps=True)`` buffer."""
        ts = torch.as_tensor(self.ts)
        if ts.dim() == 0:
            return torch.ones((), dtype=torch.bool, device=ts.device)
        if self.n_live is None:
            return torch.ones(ts.shape[0], dtype=torch.bool,
                              device=ts.device)
        return torch.arange(ts.shape[0], device=ts.device) < self.n_live

    def evaluate(self, t) -> Pytree:
        """Dense-output interpolation at query time(s) ``t`` (a scalar
        gives one state, a (Q,) tensor a leading Q axis), clamped into the
        span. Needs ``SaveAt(dense=True)``; differentiable with respect to
        params and z0 by direct backprop through the recorded steps."""
        if self.interpolation is None:
            raise ValueError(
                "Solution.evaluate(t) needs dense output: pass "
                "saveat=SaveAt(dense=True) to solve() to record the "
                "per-step interpolation coefficients")
        return self.interpolation.evaluate(t)

    def __call__(self, t) -> Pytree:
        """A dense Solution is callable in time: ``sol(t)`` is
        ``sol.evaluate(t)``."""
        return self.evaluate(t)


@dataclasses.dataclass(frozen=True, eq=False)
class SaveAt:
    """What to save, one mode per solve: ``ts=<1-D grid>`` for the
    trajectory at every requested timepoint (ascending or descending);
    ``steps=True`` for every accepted step's start state plus the final
    state, as a padded buffer; ``dense=True`` for per-step cubic-Hermite
    coefficients behind ``Solution.evaluate(t)``; otherwise only the final
    state ``z(t1)``."""
    ts: Optional[Any] = None
    steps: bool = False
    dense: bool = False

    def __post_init__(self):
        picked = [m for m, on in (("ts=<grid>", self.ts is not None),
                                  ("steps=True", self.steps),
                                  ("dense=True", self.dense)) if on]
        if len(picked) > 1:
            raise ValueError("SaveAt: pass only one of ts=<grid>, "
                             f"steps=True or dense=True, not {picked}")


class GradientMethod:
    """Base of the gradient-estimation axis (paper Table 1 rows).

    Subclasses are frozen dataclasses implementing ``default_solver()``,
    ``validate(solver, controller)`` (reject incompatible axes with an
    actionable error before integrating), ``integrate(f, params, z0, ts,
    solver, controller)`` -> ``(traj, RunStats)`` with ``traj`` of leading
    axis T = len(ts), and ``residual_bytes(z0, n_obs, solver, controller)``.
    """

    name: str = "?"

    def default_solver(self):
        raise NotImplementedError

    def validate(self, solver, controller) -> None:
        if controller.adaptive and not solver.has_error_estimate:
            raise ValueError(
                f"solver {solver.name!r} has no embedded error estimate; "
                "use ConstantSteps(n) with it or pick an embedded pair")

    def integrate(self, f, params, z0: Pytree, ts: torch.Tensor, solver,
                  controller) -> Tuple[Pytree, RunStats]:
        raise NotImplementedError

    def residual_bytes(self, z0: Pytree, n_obs: int, solver,
                       controller) -> int:
        return 0


def state_nbytes(z0: Pytree) -> int:
    """Byte size of one state pytree."""
    return sum(int(l.numel()) * l.element_size()
               for l in pytree.tree_leaves(z0))
