"""Naive method: backpropagate directly through the solver loop.

The integration loop is plain PyTorch under autograd, so every per-step
intermediate stays alive for the backward pass and residual memory grows
with the number of (trial) steps — the paper's characterization (memory
N_z*N_f*N_t*m). Naive-through-ALF on the reference backend is the gradient
oracle for MALI: both run the identical forward, so they agree to float
precision.

Under ``PerSample`` (``rows`` = B) the loop is the per-row driver and
autograd differentiates through its ``torch.where`` masks, so a finished
row's padding trials get zero cotangents, as under ``jax.vmap``.

``diff_bounds=True`` wraps the run in an autograd node that substitutes
the analytic observation-time cotangents
(:func:`~repro_torch.core.interface.bounds_cotangents`) for the discrete
``dL/dts`` plain autograd would give (the derivative of the step-size
arithmetic), so all four gradient methods agree on the diff_bounds
semantics; the params/z0 path stays ordinary autograd, re-run in the
backward with ``ts`` detached.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree_util as pytree

from .alf import tree_sub
from .integrate import grid_run, integrate_grid, tree_row
from .interface import (GradientMethod, bounds_cotangents, grid_vjp,
                        make_run_stats, per_sample, state_nbytes)
from .solvers import ALF, Solver, get_solver
from .stepsize import controller_from_kwargs


def _naive_run(f, params, z0, ts, solver: Solver, controller,
               rows: int = 0):
    state0 = solver.init_state(f, params, z0, ts[0])
    trial = solver.trial_fn(f, params, controller)
    res = integrate_grid(trial, state0, ts, controller=controller,
                         order=solver.order, rows=rows)
    init_evals = 1 if isinstance(solver, ALF) else 0
    return (solver.output(res.traj),
            make_run_stats(res.n_accepted, res.n_trials, solver.stages,
                           init_evals))


def _naive_grid_db(f, params, z0, ts, solver: Solver, controller,
                   rows: int = 0):
    """Naive integration with analytic observation-time cotangents: the
    forward is :func:`_naive_run`; the backward re-runs it under autograd
    with ``ts`` detached for the params/z0 cotangents and adds
    :func:`bounds_cotangents` for ``ts``."""

    def fwd(params, z0, ts):
        traj, stats = _naive_run(f, params, z0, ts, solver, controller,
                                 rows)
        return traj, stats, (traj, params, z0, ts)

    def bwd(residuals, g_traj):
        z_traj, params, z0, ts = residuals
        p_leaves, p_spec = pytree.tree_flatten(params)
        z_leaves, z_spec = pytree.tree_flatten(z0)
        inputs = [x.detach().requires_grad_(True)
                  for x in p_leaves + z_leaves]
        with torch.enable_grad():
            traj, _ = _naive_run(
                f, pytree.tree_unflatten(inputs[:len(p_leaves)], p_spec),
                pytree.tree_unflatten(inputs[len(p_leaves):], z_spec),
                ts.detach(), solver, controller, rows)
            grads = torch.autograd.grad(pytree.tree_leaves(traj), inputs,
                                        pytree.tree_leaves(g_traj),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs)]
        g_params = pytree.tree_unflatten(grads[:len(p_leaves)], p_spec)
        g_z0 = pytree.tree_unflatten(grads[len(p_leaves):], z_spec)
        a_t0 = tree_sub(g_z0, tree_row(g_traj, 0))
        g_ts = bounds_cotangents(f, params, z_traj, ts, g_traj, a_t0)
        return g_params, g_z0, g_ts

    return grid_vjp(fwd, bwd, params, z0, ts)


def check_direct_backprop(solver: Solver, consumer: str) -> None:
    """Refuse solvers whose trial step launches forward-only kernel ops.

    The solver reports the kernel ops its step launches
    (:meth:`Solver.kernel_step_ops`) and each is looked up in the
    ``NO_REVERSE_RULE`` registry; a listed op is refused with its recorded
    reason."""
    from repro_torch.kernels.registry import no_reverse_reason
    blocked = [(op, no_reverse_reason(op)) for op in solver.kernel_step_ops()]
    blocked = [(op, r) for op, r in blocked if r is not None]
    if blocked:
        detail = "; ".join(f"{op} (NO_REVERSE_RULE: {r})"
                           for op, r in blocked)
        raise ValueError(
            f"{consumer} backpropagates directly through the recorded step "
            f"sequence, but solver {solver.name!r} launches forward-only "
            f"kernel op(s): {detail}")


@dataclasses.dataclass(frozen=True)
class Naive(GradientMethod):
    """Direct backprop through the integration loop (Table 1 'naive' row):
    the memory-hungry oracle every memory-efficient method is checked
    against, in both integration directions."""

    name = "naive"

    def default_solver(self) -> Solver:
        return ALF()

    def validate(self, solver, controller) -> None:
        super().validate(solver, controller)
        check_direct_backprop(solver, "Naive()")

    def integrate(self, f, params, z0, ts, solver, controller,
                  diff_bounds: bool = False, rows: int = 0):
        run = _naive_grid_db if diff_bounds else _naive_run
        return run(per_sample(f) if rows else f, params, z0, ts, solver,
                   controller, rows)

    def residual_bytes(self, z0, n_obs, solver, controller) -> int:
        # Autograd keeps every trial step's intermediates alive — grows
        # with the per-segment step budget.
        state = 2 if isinstance(solver, ALF) else 1
        return ((n_obs - 1) * controller.step_bound * solver.stages
                * state * state_nbytes(z0))


def odeint_naive(f, params, z0, t0=0.0, t1=1.0, *, ts=None, solver="alf",
                 n_steps: int = 0, eta: float = 1.0, rtol: float = 1e-2,
                 atol: float = 1e-3, max_steps: int = 64):
    """Differentiable integration (legacy kwargs facade); with ``ts``
    returns the (T, ...) trajectory (``traj[0] == z0``), otherwise z(t1)
    via the length-1 grid [t0, t1]."""
    sol = get_solver(solver)
    if isinstance(sol, ALF) and eta != sol.eta:
        sol = ALF(eta=float(eta), backend=sol.backend)
    controller = controller_from_kwargs(n_steps, rtol, atol, max_steps)
    method = Naive()
    method.validate(sol, controller)
    return grid_run(lambda grid: method.integrate(
        f, params, z0, grid, sol, controller)[0], z0, t0, t1, ts)
