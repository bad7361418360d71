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
``diff_bounds``, terminating events (``event=``) and the three batching
modes: ``Lockstep()``, ``PerSample()`` (each row its own adaptive
control, ``f`` called per sample) and ``Sharded()`` (the rows split over
a ``torch.distributed`` mesh axis, ``inner`` batching on each rank).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import vjp

from .dense import build_interpolation, locate_event
from .integrate import (as_time_grid, integrate_grid, scalar_time_grid,
                        validate_span)
from .interface import (Batching, Event, GradientMethod, Lockstep,
                        PerSample, RunStats, SaveAt, Sharded, Solution,
                        Stats, batch_first, batch_size, make_run_stats,
                        tree_vdot)
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
    the shared forward of SaveAt(steps=True), SaveAt(dense=True) and the
    event detection pass, in either time direction."""
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


def _span_interpolation(f, params, solver, grid, res):
    """Fit the dense cubic-Hermite record of one recorded span."""
    states = _tm(lambda b: b[0], res.state_traj)
    return build_interpolation(solver, f, params, states, res.state,
                               res.ts[0], res.hs[0], res.n_accepted[0],
                               grid[0], grid[-1])


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
    interp = _span_interpolation(f, params, solver, grid, res)
    stats = _span_stats(res, z0, grid, solver, controller,
                        solver.interpolant_fevals(controller.step_bound))
    return Solution(ys=solver.output(res.state), ts=grid[-1], stats=stats,
                    interpolation=interp)


def _detach(tree: Pytree) -> Pytree:
    return _tm(lambda x: x.detach(), tree)


def _ift_event_time(f, params, event: Event, z_ev, t_event, fired):
    """The event time, differentiable through the implicit function
    theorem.

    The detection pass runs on detached inputs, so ``t_event`` carries no
    gradient. The crossing is defined by ``c(z(t*; theta), t*) = 0``, so

        dt*/dtheta = -<c_z, dz(t*)/dtheta> / (<c_z, f(z*, t*)> + c_t).

    Written as a value-preserving correction,
    ``t* - (c(z_ev, t*) - sg(c)) / sg(cdot)``: the subtraction is zero in
    value, and its backward routes the re-solve's differentiable ``z_ev``
    into the IFT quotient. ``fired`` gates the correction (an event-free
    span keeps a plain span end with no gradient), and ``|cdot| > 1e-12``
    guards the division."""
    cval = torch.as_tensor(event.cond_fn(z_ev, t_event))
    z_sg = _detach(z_ev)
    c_sg, pull = vjp(lambda z, t: torch.as_tensor(event.cond_fn(z, t)),
                     z_sg, t_event)
    c_z, c_t = pull(torch.ones_like(c_sg))
    with torch.no_grad():
        cdot = tree_vdot(c_z, f(params, z_sg, t_event)) + c_t
    safe = torch.where(torch.abs(cdot) > 1e-12, cdot, torch.ones_like(cdot))
    corr = (cval - cval.detach()) / safe
    return t_event - torch.where(fired, corr, torch.zeros_like(corr))


def _solve_event(f, params, z0, t0, t1, solver, controller, gradient,
                 saveat, event: Event, diff_bounds: bool) -> Solution:
    """Terminating-event solve: record the full span on detached inputs,
    locate and refine the first crossing of ``event.cond_fn`` on the
    interpolant, then re-solve ``[t0, t_event]`` with the chosen gradient
    method (``t_event`` a constant of the re-solve, so every method
    differentiates it as a plain solve). ``Stats.event_time`` is made
    differentiable afterwards by :func:`_ift_event_time`."""
    if saveat.steps or saveat.dense:
        raise ValueError(
            "SaveAt(steps=True)/SaveAt(dense=True) with event= is not "
            "supported: the per-step record would mix pre- and post-event "
            "steps of the detection pass; use SaveAt(ts=grid) (post-event "
            "rows hold the terminal state) or the default end state")
    device = pytree.tree_leaves(z0)[0].device
    trajectory = saveat.ts is not None
    if trajectory:
        user_grid = as_time_grid(saveat.ts, device)
        t0, t1 = user_grid[0], user_grid[-1]

    # Detection pass: never differentiated, and its bisection evaluates
    # the interpolant, never the dynamics.
    with torch.no_grad():
        grid, res = _record_span(f, params, z0, t0, t1, solver, controller)
        interp = _span_interpolation(f, params, solver, grid, res)
        t_event, fired = locate_event(interp, event.cond_fn,
                                      event.direction, event.max_bisections,
                                      grid[-1])

    # The differentiable re-solve over the event-terminated span. A grid
    # is clamped at t_event (sign-aware): every post-event segment has
    # length zero, so those rows hold the terminal state and time.
    if trajectory:
        clamped = torch.where(user_grid[-1] >= user_grid[0],
                              torch.minimum(user_grid, t_event),
                              torch.maximum(user_grid, t_event))
        traj, rstats = gradient.integrate(f, params, z0, clamped, solver,
                                          controller, diff_bounds)
        ys, ts_out, grid_out = traj, clamped, clamped
        z_ev = _tm(lambda b: b[-1], traj)
    else:
        # t0 from a fresh grid: it keeps its gradient (diff_bounds)
        start = scalar_time_grid(t0, t1, device)[0]
        grid_out = torch.stack([start, t_event.to(start.dtype)])
        traj, rstats = gradient.integrate(f, params, z0, grid_out, solver,
                                          controller, diff_bounds)
        ys, ts_out = _tm(lambda b: b[-1], traj), grid_out[-1]
        z_ev = ys
    t_event = _ift_event_time(f, params, event, z_ev, t_event, fired)

    # The accounting is the re-solve's plus the detection pass's.
    det = _span_stats(res, z0, grid, solver, controller,
                      solver.interpolant_fevals(controller.step_bound))
    n_obs = int(grid_out.shape[0])
    stats = Stats(
        n_accepted=rstats.n_accepted + det.n_accepted,
        n_rejected=rstats.n_rejected + det.n_rejected,
        n_fevals=rstats.n_fevals + det.n_fevals,
        n_segments=n_obs - 1,
        residual_bytes=gradient.residual_bytes(z0, n_obs, solver,
                                               controller),
        event_fired=fired, event_time=t_event,
        span_complete=res.completed)
    return Solution(ys=ys, ts=ts_out, stats=stats)


# ---------------------------------------------------------------------------
# Batched solves (the Batching axis)
# ---------------------------------------------------------------------------

def _broadcast_rows(rstats: RunStats, nb: int) -> RunStats:
    """Lockstep per-row counters: every row takes the shared step sequence
    and is evaluated on every shared trial, so each row's counters are the
    batch system's."""
    return RunStats(*(torch.broadcast_to(c.detach(), (nb,))
                      for c in rstats))


def _batched_stats(per: RunStats, n_segments: int, residual_bytes: int,
                   span_complete=None) -> Stats:
    """Stats of a batched solve: ``per_sample`` keeps the (B,) rows, the
    scalar counters hold their totals."""
    return Stats(
        n_accepted=torch.sum(per.n_accepted).to(torch.int32),
        n_rejected=torch.sum(per.n_rejected).to(torch.int32),
        n_fevals=torch.sum(per.n_fevals).to(torch.int32),
        n_segments=n_segments, residual_bytes=residual_bytes,
        per_sample=per, span_complete=span_complete)


def _solve_lockstep(f, params, z0, grid, nb, solver, controller, gradient,
                    trajectory, diff_bounds=False):
    """One shared controller decision per trial: the unbatched machinery
    on the batched state (the batch one concatenated system)."""
    traj, rstats = gradient.integrate(f, params, z0, grid, solver,
                                      controller, diff_bounds)
    ys = batch_first(traj) if trajectory else _tm(lambda b: b[-1], traj)
    return ys, _broadcast_rows(rstats, nb)


def _solve_per_sample(f, params, z0, grid, solver, controller, gradient,
                      trajectory, diff_bounds=False):
    """Row-independent control through the per-row driver (each sample
    its own (t, h, done); see integrate.py)."""
    traj, per = gradient.integrate_batched(f, params, z0, grid, solver,
                                           controller, diff_bounds)
    ys = traj if trajectory else _tm(lambda b: b[:, -1], traj)
    return ys, RunStats(*(c.detach() for c in per))


def _solve_sharded(f, params, z0, grid, nb, solver, controller, gradient,
                   trajectory, batching: Sharded):
    """Data parallelism over one axis of the ambient device mesh: each
    rank solves its slice of the rows with ``batching.inner``, and the
    whole batch is gathered back on every rank. ``z0`` and ``params`` are
    replicated, so their cotangents are summed over the ranks (the
    gradient of the JAX package's replicated-in, sharded-out
    ``shard_map``)."""
    from repro_torch.distributed.sharding import (ambient_mesh, axis_group,
                                                  gather_rows,
                                                  mark_replicated)
    mesh = ambient_mesh()
    if mesh is None:
        raise ValueError(
            "Sharded() batching needs an active mesh context: wrap the "
            "solve in `with mesh:` (repro_torch.launch.mesh.make_host_mesh"
            "()), or use Lockstep()/PerSample() on a single device")
    if batching.axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"Sharded(axis={batching.axis!r}): the active mesh has axes "
            f"{mesh.mesh_dim_names}; pass one of those (the production mesh "
            "uses 'data' for batch parallelism)")
    group, n_shards, rank = axis_group(mesh, batching.axis)
    if nb % n_shards != 0:
        raise ValueError(
            f"Sharded(axis={batching.axis!r}): batch size {nb} is not "
            f"divisible by the axis size {n_shards}; pad the batch or "
            "pick a divisible size")
    local = nb // n_shards
    lo = rank * local
    p_local = _tm(lambda x: mark_replicated(x, group, n_shards), params)
    z_local = _tm(
        lambda x: mark_replicated(x, group, n_shards)[lo:lo + local], z0)
    if isinstance(batching.inner, PerSample):
        ys, per = _solve_per_sample(f, p_local, z_local, grid, solver,
                                    controller, gradient, trajectory)
    else:
        ys, per = _solve_lockstep(f, p_local, z_local, grid, local, solver,
                                  controller, gradient, trajectory)

    def gather(x):
        return gather_rows(x, group, n_shards, rank)

    return _tm(gather, ys), RunStats(*(gather(c) for c in per))


def _solve_batched(f, params, z0, t0, t1, solver, controller, gradient,
                   saveat, batching: Batching,
                   diff_bounds: bool) -> Solution:
    """A batched solve: ``ys`` batch-first and per-row counters in
    ``stats.per_sample`` (their totals in the scalar counters), whatever
    the mode."""
    nb = batch_size(z0)
    if saveat.steps or saveat.dense:
        # Lockstep's shared step sequence keeps per-step output
        # rectangular; PerSample/Sharded raggedness is refused in
        # Batching.validate.
        if saveat.steps:
            sol = _solve_dense(f, params, z0, t0, t1, solver, controller)
            ys = batch_first(sol.ys)
        else:
            # the interpolant carries the batch axis inside each
            # coefficient leaf: evaluate(t) gives (B, ...) per query
            sol = _solve_dense_interp(f, params, z0, t0, t1, solver,
                                      controller)
            ys = sol.ys
        per = _broadcast_rows(RunStats(sol.stats.n_accepted,
                                       sol.stats.n_rejected,
                                       sol.stats.n_fevals), nb)
        stats = _batched_stats(per, sol.stats.n_segments,
                               sol.stats.residual_bytes,
                               sol.stats.span_complete)
        return Solution(ys=ys, ts=sol.ts, stats=stats,
                        interpolation=sol.interpolation, n_live=sol.n_live)
    grid = _time_grid(saveat, t0, t1, z0)
    trajectory = saveat.ts is not None
    if isinstance(batching, Sharded):
        ys, per = _solve_sharded(f, params, z0, grid, nb, solver,
                                 controller, gradient, trajectory, batching)
    elif isinstance(batching, PerSample):
        ys, per = _solve_per_sample(f, params, z0, grid, solver, controller,
                                    gradient, trajectory, diff_bounds)
    else:
        ys, per = _solve_lockstep(f, params, z0, grid, nb, solver,
                                  controller, gradient, trajectory,
                                  diff_bounds)
    n_obs = int(grid.shape[0])
    stats = _batched_stats(per, n_obs - 1,
                           gradient.residual_bytes(z0, n_obs, solver,
                                                   controller))
    return Solution(ys=ys, ts=grid if trajectory else grid[-1], stats=stats)


def _time_grid(saveat: SaveAt, t0, t1, z0) -> torch.Tensor:
    """The observation grid on z0's device: ``SaveAt.ts``, or [t0, t1]."""
    device = pytree.tree_leaves(z0)[0].device
    if saveat.ts is not None:
        return as_time_grid(saveat.ts, device)
    return scalar_time_grid(t0, t1, device)


def solve(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0, t1=1.0, *,
          solver: Optional[Solver] = None,
          controller: Optional[StepController] = None,
          gradient: Optional[GradientMethod] = None,
          saveat: Optional[SaveAt] = None,
          batching: Optional[Batching] = None,
          event: Optional[Event] = None,
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

    ``event=Event(cond_fn, ...)`` stops the solve at the first sign change
    of ``cond_fn(z, t)`` (:class:`~repro_torch.core.interface.Event`):
    ``sol.stats.event_fired`` / ``event_time`` record it, and on a
    ``SaveAt(ts=grid)`` the post-event rows hold the terminal state.
    ``batching=`` makes the leading axis of every ``z0`` leaf a batch
    axis: ``ys`` batch-first, ``(B, ...)`` or ``(B, T, ...)``, and
    ``stats.per_sample`` per-row counters (the scalar counters their
    totals). ``Lockstep()`` integrates the batch as one system, one
    shared accept/reject per trial; ``PerSample()`` gives each row its
    own adaptive control, with ``f`` called per sample (one row of
    ``z``, that row's scalar ``t``), for fewer f-evals on a batch of
    mixed stiffness; ``Sharded(axis, inner)`` splits the rows over a mesh
    axis (``with repro_torch.launch.mesh.make_host_mesh():``), ``inner``
    batching on each rank, the whole batch gathered back on every rank.
    ``diff_bounds=True`` gives ``t0``/``t1`` (and every ``SaveAt.ts``
    entry) their analytic cotangents.
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

    gradient.validate(solver, controller)
    if saveat.ts is None:
        validate_span(t0, t1)
    if diff_bounds:
        if saveat.steps or saveat.dense:
            raise ValueError(
                "diff_bounds=True needs a fixed observation grid; "
                "SaveAt(steps=True)/SaveAt(dense=True) output is indexed by "
                "accepted steps, which carry no boundary cotangents — use "
                "the default end state or SaveAt(ts=grid)")
        if isinstance(batching, Sharded):
            raise ValueError(
                "diff_bounds=True with Sharded() batching is not supported: "
                "the observation grid is a closed-over constant inside "
                "shard_map, so its cotangents cannot cross the mesh axis — "
                "use Lockstep()/PerSample(), or vmap sharded solves with "
                "static bounds")

    if event is not None:
        if not isinstance(event, Event):
            raise TypeError(f"event must be an Event, got {event!r}")
        if batching is not None:
            raise ValueError(
                "event= with batching= is not supported: per-sample event "
                "times are ragged; vmap single event solves, or solve the "
                "batch without an event and post-process")
        return _solve_event(f, params, z0, t0, t1, solver, controller,
                            gradient, saveat, event, diff_bounds)

    if batching is not None:
        if not isinstance(batching, Batching):
            raise TypeError(
                f"batching must be a Batching (Lockstep, PerSample or "
                f"Sharded), got {batching!r}")
        batching.validate(controller, saveat)
        return _solve_batched(f, params, z0, t0, t1, solver, controller,
                              gradient, saveat, batching, diff_bounds)

    if saveat.steps or saveat.dense:
        dense = _solve_dense if saveat.steps else _solve_dense_interp
        return dense(f, params, z0, t0, t1, solver, controller)
    grid = _time_grid(saveat, t0, t1, z0)
    traj, rstats = gradient.integrate(f, params, z0, grid, solver,
                                      controller, diff_bounds)
    stats = _build_stats(rstats, gradient, z0, grid, solver, controller)
    if saveat.ts is not None:
        return Solution(ys=traj, ts=grid, stats=stats)
    return Solution(ys=_tm(lambda b: b[-1], traj), ts=grid[-1], stats=stats)


__all__ = ["solve", "Solution", "SaveAt", "Stats", "Event", "GradientMethod",
           "Batching", "Lockstep", "PerSample", "Sharded",
           "MALI", "Naive", "ACA", "Backsolve", "Adjoint", "ALF",
           "AdaptiveController"]
