"""solve(): the composable front door of the integrator.

The paper's Table 1 is a matrix of gradient methods x solvers x step-size
policies; ``solve`` exposes those axes as independent objects::

    from repro_torch.core import (solve, SaveAt, ALF, Dopri5,
                                  ConstantSteps, AdaptiveController,
                                  MALI, Naive, ACA, Backsolve)

    sol = solve(f, params, z0, 0.0, 1.0,
                solver=ALF(eta=1.0, backend="cuda"),
                controller=ConstantSteps(8),      # or AdaptiveController(...)
                gradient=MALI(),          # or Naive()/ACA()/Backsolve()
                saveat=SaveAt(ts=torch.linspace(0., 1., 16)))
    sol.ys      # (16, ...) trajectory
    sol.stats   # accepted/rejected steps, f-evals, residual footprint

The solve computes on the device of ``z0`` and ``params``. The port
covers every solver of the registry (ALF on either backend, the
Runge-Kutta tableaus) x {MALI, Naive, ACA, Backsolve} x {ConstantSteps,
AdaptiveController} x {end state, ``SaveAt(ts=)``, ``SaveAt(steps=True)``,
``SaveAt(dense=True)``}, forward and reverse time, with or without
``diff_bounds``; ``batching=`` and ``event=`` raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from .dense import build_interpolation
from .integrate import (as_time_grid, integrate_grid, scalar_time_grid,
                        validate_span)
from .interface import (GradientMethod, RunStats, SaveAt, Solution, Stats,
                        make_run_stats)
from .aca import ACA
from .adjoint import Adjoint, Backsolve
from .mali import MALI
from .naive import Naive, check_direct_backprop
from .solvers import ALF, Solver, get_solver
from .stepsize import AdaptiveController, StepController

_tm = pytree.tree_map

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


def _record_span(f, params, z0, t0, t1, solver, controller):
    """One state-recording integration over the single [t0, t1] segment,
    the shared forward of SaveAt(steps=True) and SaveAt(dense=True), in
    either time direction."""
    grid = scalar_time_grid(t0, t1, pytree.tree_leaves(z0)[0].device)
    state0 = solver.init_state(f, params, z0, grid[0])
    trial = solver.trial_fn(f, params, controller)
    res = integrate_grid(trial, state0, grid, controller=controller,
                         order=solver.order, record_states=True)
    return grid, res


def _span_stats(res, z0, grid, solver, controller, extra_evals=0) -> Stats:
    """Stats of a recorded span: its residuals are the recorded buffer
    itself, Naive's footprint, whatever gradient method was passed."""
    init_evals = (1 if isinstance(solver, ALF) else 0) + extra_evals
    rstats = make_run_stats(res.n_accepted, res.n_trials, solver.stages,
                            init_evals)
    stats = _build_stats(rstats, Naive(), z0, grid, solver, controller)
    return stats._replace(span_complete=res.completed)


def _solve_dense(f, params, z0, t0, t1, solver, controller) -> Solution:
    """SaveAt(steps=True): every accepted step of the single [t0, t1]
    segment. Per-step output pins each intermediate state, so gradients
    flow by direct backprop through the recorded sequence, whatever
    gradient method was passed."""
    check_direct_backprop(solver, "SaveAt(steps=True)")
    grid, res = _record_span(f, params, z0, t0, t1, solver, controller)
    n_acc = res.n_accepted[0]
    at = n_acc.long().reshape(1)
    starts = solver.output(_tm(lambda b: b[0], res.state_traj))
    final = solver.output(res.state)
    # One padded buffer: rows 0..n_acc-1 are step-start states, row n_acc
    # the final state, later rows zero.
    ys = _tm(lambda b, fin: torch.cat([b, torch.zeros_like(b[:1])])
             .index_put((at,), fin.unsqueeze(0)), starts, final)
    ts_out = torch.cat([res.ts[0], torch.zeros_like(res.ts[0][:1])])
    ts_out = ts_out.index_put((at,), grid[-1].reshape(1))
    return Solution(ys=ys, ts=ts_out,
                    stats=_span_stats(res, z0, grid, solver, controller),
                    n_live=n_acc + 1)


def _solve_dense_interp(f, params, z0, t0, t1, solver,
                        controller) -> Solution:
    """SaveAt(dense=True): record the span and fit the per-step
    cubic-Hermite interpolant behind ``Solution.evaluate(t)``; gradients
    flow through ``ys`` and through interpolated values by direct backprop
    through the recorded sequence."""
    check_direct_backprop(solver, "SaveAt(dense=True)")
    grid, res = _record_span(f, params, z0, t0, t1, solver, controller)
    states = _tm(lambda b: b[0], res.state_traj)
    interp = build_interpolation(solver, f, params, states, res.state,
                                 res.ts[0], res.hs[0], res.n_accepted[0],
                                 grid[0], grid[-1])
    stats = _span_stats(res, z0, grid, solver, controller,
                        solver.interpolant_fevals(controller.step_bound))
    return Solution(ys=solver.output(res.state), ts=grid[-1], stats=stats,
                    interpolation=interp)


def _refuse_later_axes(batching, event) -> None:
    later = []
    if batching is not None:
        later.append("batching= (ROADMAP queue 1, Batching)")
    if event is not None:
        later.append("event= (ROADMAP queue 1, time as an axis: events)")
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
    method's backward applies. ``SaveAt(steps=True)`` returns every
    accepted step's start state plus the final state as a padded buffer
    (``sol.num_steps``, ``sol.step_mask``); ``SaveAt(dense=True)`` makes
    ``sol.evaluate(t)`` interpolate anywhere in the span. Both pin every
    step's state, so their gradients are direct backprop through the
    recorded steps, whatever ``gradient`` says.
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
    _refuse_later_axes(batching, event)

    gradient.validate(solver, controller)
    if diff_bounds and (saveat.steps or saveat.dense):
        raise ValueError(
            "diff_bounds=True needs a fixed observation grid; "
            "SaveAt(steps=True)/SaveAt(dense=True) output is indexed by "
            "accepted steps, which carry no boundary cotangents — use "
            "the default end state or SaveAt(ts=grid)")
    if saveat.steps or saveat.dense:
        validate_span(t0, t1)
        dense = _solve_dense if saveat.steps else _solve_dense_interp
        return dense(f, params, z0, t0, t1, solver, controller)
    device = pytree.tree_leaves(z0)[0].device
    trajectory = saveat.ts is not None
    if trajectory:
        grid = as_time_grid(saveat.ts, device)
    else:
        validate_span(t0, t1)
        grid = scalar_time_grid(t0, t1, device)
    traj, rstats = gradient.integrate(f, params, z0, grid, solver,
                                      controller, diff_bounds)
    stats = _build_stats(rstats, gradient, z0, grid, solver, controller)
    if trajectory:
        return Solution(ys=traj, ts=grid, stats=stats)
    return Solution(ys=pytree.tree_map(lambda b: b[-1], traj), ts=grid[-1],
                    stats=stats)


__all__ = ["solve", "Solution", "SaveAt", "Stats", "GradientMethod",
           "MALI", "Naive", "ACA", "Backsolve", "Adjoint", "ALF",
           "AdaptiveController"]
