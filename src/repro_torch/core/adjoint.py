"""Backsolve adjoint method (Chen et al. 2018, torchdiffeq-style) as an
autograd node.

Forward: integrate and keep only the per-observation states — O(T) memory.
Backward: solve the *reverse-time* augmented IVP

    d/dt [ z, a, g ] = [ f,  -(df/dz)^T a,  -(df/dtheta)^T a ]

from T down to t0, re-deriving the trajectory numerically. Because the
reverse-time trajectory is itself a numerical solution, it drifts from the
forward one (paper Thm 2.1) — the inaccuracy MALI removes. This is the
paper's main baseline.

:class:`Backsolve` (alias :data:`Adjoint`) works with any registered
solver, ALF included (its ``eta`` and ``backend`` ride on the solver), and
both step controllers; each observation segment restarts the solver (ALF
re-initialises ``v = f(z, t)``) and the adaptive controller. Both solves
run with autograd off: on ``ALF(backend="cuda")`` every step of the
forward and of the augmented solve is one ``alf_midpoint`` and one
``alf_update`` launch over the whole state tree (``(z, a, g_params)`` in
the backward), through the ops' grad-free path. Only the VJP of ``f``
inside the augmented dynamics builds a graph, one step at a time.

Under ``PerSample`` (``rows`` = B) both solves run per row, and the
augmented dynamics are themselves mapped per sample, so each row carries
its own parameter cotangent ``g`` (a (B, ...) leaf per parameter) through
its own adaptive reverse solve, as ``jax.vmap`` of the JAX package's
backward does; the rows' ``g`` are summed at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import vjp

from .alf import tree_add, tree_sub, tree_zeros_like
from .integrate import (grid_run, integrate_span, prepend_row,
                        reverse_segment_sweep, segment_pairs, stack_states,
                        tree_row)
from .interface import (GradientMethod, bounds_cotangents, grid_vjp,
                        make_run_stats, per_sample, state_nbytes)
from .solvers import ALF, Dopri5, Solver, get_solver
from .stepsize import StepController, controller_from_kwargs

_tm = pytree.tree_map

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]


class AdjointConfig(NamedTuple):
    f: Dynamics
    solver: Solver
    controller: StepController
    diff_bounds: bool = False  # emit analytic dL/dts boundary cotangents
    rows: int = 0              # B: per-row control, f called per sample


def _integrate(cfg: AdjointConfig, dyn: Dynamics, params: Pytree,
               state0: Pytree, t0, t1):
    """Integrate ``dyn`` over one span with cfg's solver and controller.
    Returns (z_out, n_accepted, n_trials)."""
    state = cfg.solver.init_state(dyn, params, state0, t0)
    trial = cfg.solver.trial_fn(dyn, params, cfg.controller)
    out = integrate_span(trial, state, t0, t1, controller=cfg.controller,
                         order=cfg.solver.order, rows=cfg.rows)
    return cfg.solver.output(out.state), out.n_accepted, out.n_trials


def _adjoint_grid(cfg: AdjointConfig, params, z0, ts):
    """The Backsolve autograd node over (params, z0, ts); returns
    ``(z_traj, RunStats)``."""

    f = per_sample(cfg.f) if cfg.rows else cfg.f

    def fwd(params, z0, ts):
        z, n_acc, n_tr, tail = z0, [], 0, []
        for pair in segment_pairs(ts):
            z, a, t = _integrate(cfg, f, params, z, pair[0], pair[1])
            n_acc.append(a)
            n_tr = n_tr + t
            tail.append(z)
        z_traj = prepend_row(z0, stack_states(tail))
        # ALF re-initialises v0 = f(z, t) at every observation segment.
        init_evals = (ts.shape[0] - 1) if isinstance(cfg.solver, ALF) else 0
        stats = make_run_stats(torch.stack(n_acc), n_tr, cfg.solver.stages,
                               init_evals)
        return z_traj, stats, (z_traj, params, ts)   # O(T) residuals

    def bwd(residuals, g_traj):
        z_traj, params, ts = residuals

        def aug_one(p, aug, t):
            z, a, _g = aug
            f_val, vjp_fn = vjp(lambda pp, zz: cfg.f(pp, zz, t), p, z)
            dp, dz = vjp_fn(a)
            return (f_val, _tm(torch.neg, dz), _tm(torch.neg, dp))

        aug_dyn = per_sample(aug_one) if cfg.rows else aug_one

        def seg(carry, g_k1, k):
            a_z, g_p = carry
            # Reverse-time IVP over ts[k+1] -> ts[k]; z restarts from the
            # stored observation (torchdiffeq-style), so reverse drift does
            # not compound across segments, and g[k+1] enters a(t).
            aug0 = (tree_row(z_traj, k + 1), tree_add(a_z, g_k1), g_p)
            (_z, a_z, g_p), _, _ = _integrate(cfg, aug_dyn, params, aug0,
                                              ts[k + 1], ts[k])
            return (a_z, g_p)

        # per row: each row's own parameter cotangent, summed at the end
        g0 = (_tm(lambda x: x.new_zeros((cfg.rows,) + x.shape), params)
              if cfg.rows else tree_zeros_like(params))
        carry0 = (tree_zeros_like(tree_row(g_traj, 0)), g0)
        a_z, g_params = reverse_segment_sweep(seg, carry0, g_traj,
                                              ts.shape[0] - 1)
        if cfg.rows:
            g_params = _tm(lambda g: g.sum(0), g_params)
        g_ts = None
        if cfg.diff_bounds:
            a_t0 = tree_sub(a_z, tree_row(g_traj, 0))
            g_ts = bounds_cotangents(f, params, z_traj, ts, g_traj, a_t0)
        return g_params, a_z, g_ts

    return grid_vjp(fwd, bwd, params, z0, ts)


@dataclasses.dataclass(frozen=True)
class Backsolve(GradientMethod):
    """Reverse-time adjoint (Table 1 'adjoint' row): O(T) forward memory,
    gradients subject to reverse-integration drift (paper Thm 2.1).

    Each backward segment integrates ts[k+1] -> ts[k], whatever their
    order: for a reverse-time forward solve (descending ts) the adjoint
    IVP runs in ascending time, through the same sign-agnostic driver."""

    name = "adjoint"

    def default_solver(self) -> Solver:
        return Dopri5()

    def integrate(self, f, params, z0, ts, solver, controller,
                  diff_bounds: bool = False, rows: int = 0):
        return _adjoint_grid(AdjointConfig(f, solver, controller, diff_bounds,
                                           rows), params, z0, ts)

    def residual_bytes(self, z0, n_obs, solver, controller) -> int:
        # Only the per-observation states survive to the backward pass.
        return n_obs * state_nbytes(z0)


Adjoint = Backsolve


def odeint_adjoint(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0, t1=1.0,
                   *, ts=None, solver="dopri5", n_steps: int = 0,
                   eta: float = 1.0, rtol: float = 1e-2, atol: float = 1e-3,
                   max_steps: int = 64) -> Pytree:
    """Backsolve-adjoint integration (legacy kwargs facade)."""
    sol = get_solver(solver)
    if isinstance(sol, ALF) and eta != sol.eta:
        sol = ALF(eta=float(eta), backend=sol.backend)
    controller = controller_from_kwargs(n_steps, rtol, atol, max_steps)
    method = Backsolve()
    method.validate(sol, controller)
    return grid_run(lambda grid: method.integrate(
        f, params, z0, grid, sol, controller)[0], z0, t0, t1, ts)
