"""Adaptive Checkpoint Adjoint (ACA; Zhuang et al. 2020) as an autograd
node.

The forward pass stores the *accepted* trajectory {z_i} (O(N_t) memory —
the paper's N_z(N_f + N_t)) plus the accepted (t_i, h_i); the backward pass
replays each accepted step under a local ``torch.func.vjp``, leaving the
step-size search out of the graph (depth N_f * N_t). This is the paper's
strongest accuracy baseline, the method MALI matches in gradient quality
while dropping the O(N_t) term.

Like MALI, ACA integrates over an observation grid ``ts``, checkpointing
every segment's step start states (``integrate_grid(record_states=True)``)
and emitting z at every ``ts[k]``. Both step controllers share one node;
the backward replays the recorded steps of each segment either way. The
replay script is signed: a reverse-time solve replays its negative h_i.

:class:`ACA` accepts any Runge-Kutta solver (the ALF solver belongs to
MALI). Its steps are plain PyTorch: ACA launches no kernel. Under
``PerSample`` each row checkpoints and replays its own accepted steps;
the sweep masks a row past its own count as MALI's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from repro_torch.tree_util import vjp

from .alf import tree_add, tree_sub, tree_zeros_like
from .integrate import (grid_run, integrate_grid, keep_rows, mask_rows,
                        reverse_masked_scan, reverse_segment_sweep,
                        sweep_counts, tree_row)
from .interface import (GradientMethod, bounds_cotangents, grid_vjp,
                        make_run_stats, per_sample, state_nbytes)
from .solvers import HeunEuler, RungeKutta, get_solver
from .stepsize import StepController, controller_from_kwargs

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]


class AcaConfig(NamedTuple):
    f: Dynamics
    solver: RungeKutta
    controller: StepController
    diff_bounds: bool = False  # emit analytic dL/dts boundary cotangents
    rows: int = 0              # B: per-row control, f the per-sample map


def _aca_grid(cfg: AcaConfig, params, z0, ts):
    """The ACA autograd node over (params, z0, ts); returns
    ``(z_traj, RunStats)``."""

    def fwd(params, z0, ts):
        trial = cfg.solver.trial_fn(cfg.f, params, cfg.controller)
        res = integrate_grid(trial, z0, ts, controller=cfg.controller,
                             order=cfg.solver.order, record_states=True,
                             rows=cfg.rows)
        stats = make_run_stats(res.n_accepted, res.n_trials,
                               cfg.solver.stages)
        # Residuals: the checkpointed per-step start states (the paper's
        # O(N_t) term), the recorded (t_i, h_i) replay script and the
        # observation trajectory (the diff_bounds cotangents read it).
        return res.traj, stats, (res.traj, params, ts, res.ts, res.hs,
                                 res.n_accepted, res.state_traj)

    def bwd(residuals, g_traj):
        z_traj, params, ts, seg_ts, seg_hs, seg_acc, seg_ckpts = residuals
        tableau = cfg.solver.tableau
        n_seg = ts.shape[0] - 1
        plan = sweep_counts(cfg.controller, seg_acc)

        def step_body(carry, t, h, z_i, live):
            a_z, g_p = carry
            _, vjp_fn = vjp(lambda p, z: tableau.step(cfg.f, p, z, t, h,
                                                      False)[0], params, z_i)
            dp, dz = vjp_fn(mask_rows(live, a_z))
            return (keep_rows(live, dz, a_z), tree_add(g_p, dp))

        def seg(carry, g_k1, k):
            a_z, g_p = carry
            a_z = tree_add(a_z, g_k1)
            n_steps, row_counts = plan[k]
            return reverse_masked_scan(step_body, (a_z, g_p), seg_ts[k],
                                       seg_hs[k], n_steps,
                                       extras=tree_row(seg_ckpts, k),
                                       row_counts=row_counts)

        carry0 = (tree_zeros_like(tree_row(g_traj, 0)),
                  tree_zeros_like(params))
        a_z, g_params = reverse_segment_sweep(seg, carry0, g_traj, n_seg)
        g_ts = None
        if cfg.diff_bounds:
            a_t0 = tree_sub(a_z, tree_row(g_traj, 0))
            g_ts = bounds_cotangents(cfg.f, params, z_traj, ts, g_traj, a_t0)
        return g_params, a_z, g_ts

    return grid_vjp(fwd, bwd, params, z0, ts)


@dataclasses.dataclass(frozen=True)
class ACA(GradientMethod):
    """Adaptive Checkpoint Adjoint (Table 1 'ACA' row): checkpoint every
    accepted step, replay each under a local VJP in the backward sweep.
    The replay script is signed, so gradients are direction-agnostic."""

    name = "aca"

    def default_solver(self) -> RungeKutta:
        return HeunEuler()

    def validate(self, solver, controller) -> None:
        if not isinstance(solver, RungeKutta):
            raise ValueError(
                "ACA supports Runge-Kutta solvers; use gradient=MALI() for "
                f"the ALF solver (got {getattr(solver, 'name', solver)!r})")
        super().validate(solver, controller)

    def integrate(self, f, params, z0, ts, solver, controller,
                  diff_bounds: bool = False, rows: int = 0):
        cfg = AcaConfig(per_sample(f) if rows else f, solver, controller,
                        diff_bounds, rows)
        return _aca_grid(cfg, params, z0, ts)

    def residual_bytes(self, z0, n_obs, solver, controller) -> int:
        # Checkpointed step-start states per segment + the observation traj.
        return ((n_obs - 1) * controller.step_bound + n_obs) * state_nbytes(z0)


def odeint_aca(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0, t1=1.0, *,
               ts=None, solver="heun_euler", n_steps: int = 0,
               rtol: float = 1e-2, atol: float = 1e-3,
               max_steps: int = 64) -> Pytree:
    """ACA integration (legacy kwargs facade over the object API)."""
    sol = get_solver(solver)
    controller = controller_from_kwargs(n_steps, rtol, atol, max_steps)
    method = ACA()
    method.validate(sol, controller)
    return grid_run(lambda grid: method.integrate(
        f, params, z0, grid, sol, controller)[0], z0, t0, t1, ts)
