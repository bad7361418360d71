"""solve(): the composable front door of the integrator.

The paper's Table 1 is a matrix of gradient methods x solvers x step-size
policies; ``solve`` exposes those axes as independent objects::

    from repro_torch.core import (solve, SaveAt, ALF, ConstantSteps,
                                  AdaptiveController, MALI, Naive)

    sol = solve(f, params, z0, 0.0, 1.0,
                solver=ALF(eta=1.0, backend="cuda"),
                controller=ConstantSteps(8),      # or AdaptiveController(...)
                gradient=MALI(),                  # or Naive()
                saveat=SaveAt(ts=torch.linspace(0., 1., 16)))
    sol.ys      # (16, ...) trajectory
    sol.stats   # accepted/rejected steps, f-evals, residual footprint

The solve computes on the device of ``z0`` and ``params``. This slice
covers ALF x {MALI, Naive} x {ConstantSteps, AdaptiveController} x
{end state, ``SaveAt(ts=)``}, forward and reverse time; the other axes of
the JAX package raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from .integrate import as_time_grid, scalar_time_grid, validate_span
from .interface import GradientMethod, RunStats, SaveAt, Solution, Stats
from .mali import MALI
from .solvers import Solver, get_solver
from .stepsize import AdaptiveController, StepController

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]


def _build_stats(rstats: RunStats, gradient: GradientMethod, z0: Pytree,
                 grid: torch.Tensor, solver: Solver,
                 controller: StepController) -> Stats:
    n_obs = int(grid.shape[0])
    return Stats(
        n_accepted=rstats.n_accepted,
        n_rejected=rstats.n_rejected,
        n_fevals=rstats.n_fevals,
        n_segments=n_obs - 1,
        residual_bytes=gradient.residual_bytes(z0, n_obs, solver, controller),
    )


def _refuse_later_axes(saveat: SaveAt, batching, event,
                       diff_bounds: bool) -> None:
    later = []
    if batching is not None:
        later.append("batching= (ROADMAP queue 1, Batching)")
    if event is not None:
        later.append("event= (ROADMAP queue 1, time as an axis: events)")
    if saveat.steps or saveat.dense:
        later.append("SaveAt(steps=True)/SaveAt(dense=True) (ROADMAP queue "
                     "1, direct-backprop slice: dense output)")
    if diff_bounds:
        later.append("diff_bounds=True (ROADMAP queue 1, time as an axis: "
                     "diff_bounds)")
    if later:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(later))


def solve(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0, t1=1.0, *,
          solver: Optional[Solver] = None,
          controller: Optional[StepController] = None,
          gradient: Optional[GradientMethod] = None,
          saveat: Optional[SaveAt] = None,
          batching=None, event=None,
          diff_bounds: bool = False) -> Solution:
    """Integrate ``dz/dt = f(params, z, t)`` and return a :class:`Solution`.

    ``t1 < t0`` (or a descending ``SaveAt.ts`` grid) integrates in reverse
    time; only ``t0 == t1`` is rejected. Defaults follow the paper's MALI
    configuration: ``gradient=MALI()``, its ``ALF()`` solver and
    ``AdaptiveController(rtol=1e-2, atol=1e-3, max_steps=64)``.
    Differentiate any loss of ``sol.ys`` with autograd and the gradient
    method's backward applies.
    """
    gradient = MALI() if gradient is None else gradient
    if not isinstance(gradient, GradientMethod):
        raise TypeError(f"gradient must be a GradientMethod, got {gradient!r}")
    solver = gradient.default_solver() if solver is None else get_solver(solver)
    controller = AdaptiveController() if controller is None else controller
    if not isinstance(controller, StepController):
        raise TypeError(
            f"controller must be a StepController (ConstantSteps or "
            f"AdaptiveController), got {controller!r}")
    saveat = SaveAt() if saveat is None else saveat
    _refuse_later_axes(saveat, batching, event, diff_bounds)

    gradient.validate(solver, controller)
    device = pytree.tree_leaves(z0)[0].device
    trajectory = saveat.ts is not None
    if trajectory:
        grid = as_time_grid(saveat.ts, device)
    else:
        validate_span(t0, t1)
        grid = scalar_time_grid(t0, t1, device)
    traj, rstats = gradient.integrate(f, params, z0, grid, solver,
                                      controller)
    stats = _build_stats(rstats, gradient, z0, grid, solver, controller)
    if trajectory:
        return Solution(ys=traj, ts=grid, stats=stats)
    return Solution(ys=pytree.tree_map(lambda b: b[-1], traj), ts=grid[-1],
                    stats=stats)


__all__ = ["solve", "Solution", "SaveAt", "Stats", "GradientMethod"]
