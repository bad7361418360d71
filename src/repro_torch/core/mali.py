"""MALI: Memory-efficient ALF Integrator (paper Algo 4) as a
``torch.autograd.Function``.

The forward pass integrates the augmented ``(z, v)`` state over an
observation grid ``ts`` of T timepoints, under ``no_grad``. What it saves
for the backward pass is exactly the per-observation ``(z_k, v_k)`` pairs —
O(T * N_z), *constant in the number of solver steps* — plus the recorded
``(t_i, h_i)`` of the accepted steps, their counts, ``ts`` and the params.

Backward: per segment (in reverse), rebuild the trajectory step by step
with the exact ALF inverse (psi^-1), starting from the stored segment-end
state, and run one local VJP of psi per accepted step, accumulating the
adjoint state a(t) and dL/dtheta — the discretized Eq. (2)/(3) of the
paper. The trajectory cotangent g[k] enters a(t) as the sweep crosses
observation k. Rejected trials of the step-size search are not replayed.

Per-row batching (``integrate_batched``, ``PerSample``): the forward
runs each row's own adaptive control, and the backward sweeps every
segment over its rows' largest accepted count, a row past its own count
passing its carry through unchanged and handing the f-VJP a zero
cotangent, so padding adds exactly nothing to the gradients; each row's
psi^-1 reconstruction replays that row's own (t_i, h_i).

Gradients with respect to the observation times are zeros by default;
with ``diff_bounds=True`` the backward emits the analytic boundary
cotangents ``dL/dt_k = <g_k, f(z_k, t_k)>`` / ``dL/dt_0 = -<a(t0),
f(z0, t0)>`` (:func:`~repro_torch.core.interface.bounds_cotangents`). The
step counters are outputs marked non-differentiable.

:func:`odeint_mali` and :func:`mali_forward_stats` are the legacy kwargs
facades of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import rows_like, vjp

from .alf import (alf_inverse, alf_step, check_eta, init_velocity,
                  tree_add, tree_sub, tree_zeros_like)
from .integrate import (grid_run, integrate_grid, keep_rows, mask_rows,
                        reverse_masked_scan, reverse_segment_sweep,
                        scalar_time_grid, sweep_counts, tree_row)
from .interface import (GradientMethod, bounds_cotangents, grid_vjp,
                        make_run_stats, per_sample, state_nbytes)
from .solvers import ALF
from .stepsize import (AdaptiveController, StepController,
                       controller_from_kwargs)

_tm = pytree.tree_map

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]


class MaliConfig(NamedTuple):
    f: Dynamics
    eta: float
    controller: StepController
    fused_bwd: bool = True      # share the inverse's f-eval with the VJP
    backend: str = "reference"  # step algebra: plain tensors or kernels
    diff_bounds: bool = False   # emit analytic dL/dts boundary cotangents
    rows: int = 0               # B: per-row control, f the per-sample map


def _step_backward(cfg: MaliConfig, params, z_i, v_i, t_start, h, a_z, a_v,
                   live=None):
    """One reverse step: rebuild the step input via psi^-1 and backprop
    psi, fused (3 f-eval-equivalents) or via the reference two-pass.
    ``backend='cuda'`` runs the fused step's elementwise algebra as one
    kernel launch on each side of the f linearization; the two-pass path
    launches the inverse kernels and replays the step through the forward
    kernels' reverse rules. A (B,) ``live`` zeroes the f-VJP's cotangent
    on the dead rows (:func:`~repro_torch.core.integrate.mask_rows`)."""
    if cfg.fused_bwd:
        fused = (_cuda_fused_inverse_and_vjp if cfg.backend == "cuda"
                 else _fused_inverse_and_vjp)
        return fused(cfg.f, cfg.eta, params, z_i, v_i, t_start + h, h,
                     a_z, a_v, live)
    z_prev, v_prev = alf_inverse(cfg.f, params, z_i, v_i, t_start + h, h,
                                 cfg.eta, cfg.backend)
    dp, dz, dv = _local_step_vjp(cfg.f, cfg.eta, params, z_prev, v_prev,
                                 t_start, h, *mask_rows(live, (a_z, a_v)),
                                 cfg.backend)
    return z_prev, v_prev, dz, dv, dp


def _local_step_vjp(f, eta, params, z_prev, v_prev, t_prev, h, a_z, a_v,
                    backend="reference"):
    """VJP of one ALF step at the rebuilt input state (the reference path:
    replays psi under ``torch.func.vjp``; the oracle of the fused path).
    With ``backend='cuda'`` the replayed step launches the kernels and the
    VJP runs through their reverse rules, as Naive's backward does."""
    def step_fn(p, z, v):
        return alf_step(f, p, z, v, t_prev, h, eta, backend)

    _, vjp_fn = vjp(step_fn, params, z_prev, v_prev)
    return vjp_fn((a_z, a_v))  # (dL/dparams, dL/dz_prev, dL/dv_prev)


def _cuda_fused_inverse_and_vjp(f, eta, params, z_i, v_i, t_i, h, a_z, a_v,
                                live=None):
    """The fused backward step of :func:`_fused_inverse_and_vjp` with its
    elementwise algebra as TWO kernel launches: ``alf_bwd_pre`` emits the
    inverse midpoint k1 and the f-eval cotangent
    cot_u1 = 2*eta*(a_v + (h/2)*a_z) — ready before the linearization — then
    one ``torch.func.vjp`` of f gives (u1, dparams, dk1), and
    ``alf_bwd_post`` finishes the psi^-1 rebuild and the adjoint
    propagation."""
    from repro_torch.kernels.alf_step.ops import alf_bwd_post, alf_bwd_pre
    s1 = t_i - h / 2
    k1, cot_u1 = alf_bwd_pre(z_i, v_i, a_z, a_v, h, eta=eta)
    u1, vjp_f = vjp(lambda p, kk: f(p, kk, s1), params, k1)
    dparams, dk1 = vjp_f(mask_rows(live, cot_u1))
    z_prev, v_prev, dz_prev, dv_prev = alf_bwd_post(
        k1, v_i, u1, a_z, a_v, dk1, h, eta=eta)
    return z_prev, v_prev, dz_prev, dv_prev, dparams


def _fused_inverse_and_vjp(f, eta, params, z_i, v_i, t_i, h, a_z, a_v,
                           live=None):
    """One backward step of Algo 4 with the inverse's f-eval SHARED with
    the local VJP: the inverse evaluates u1 = f(k1, s1) at
    k1 = z_i - v_i*h/2, exactly where the local VJP of psi needs the
    linearization of f, so one ``torch.func.vjp`` provides both. The rest
    of psi is linear and its VJP is written out:

        cot_vout = a_v + (h/2)*a_z
        cot_u1   = 2*eta*cot_vout
        (dparams, dk1) = vjp_f(cot_u1)
        dz_prev  = a_z + dk1
        dv_prev  = (h/2)*dz_prev + (1-2*eta)*cot_vout

    Returns (z_prev, v_prev, dz_prev, dv_prev, dparams). A (B,) ``h``
    (one step per row) broadcasts against each leaf's batch axis; a (B,)
    ``live`` zeroes cot_u1 on the dead rows.
    """
    s1 = t_i - h / 2
    k1 = _tm(lambda zi, vi: zi - vi * (rows_like(h, zi) / 2), z_i, v_i)
    u1, vjp_f = vjp(lambda p, kk: f(p, kk, s1), params, k1)
    if eta == 1.0:
        v_prev = _tm(lambda ui, vo: 2.0 * ui - vo, u1, v_i)
    else:
        inv = 1.0 / (1.0 - 2.0 * eta)
        v_prev = _tm(lambda vo, ui: (vo - 2.0 * eta * ui) * inv, v_i, u1)
    z_prev = _tm(lambda ki, vp: ki - vp * (rows_like(h, ki) / 2), k1,
                 v_prev)
    cot_vout = _tm(lambda av, az: av + (rows_like(h, av) / 2) * az, a_v,
                   a_z)
    cot_u1 = _tm(lambda c: 2.0 * eta * c, cot_vout)
    dparams, dk1 = vjp_f(mask_rows(live, cot_u1))
    cot_k1 = _tm(torch.add, a_z, dk1)
    dv_prev = _tm(lambda ck, cv: (rows_like(h, ck) / 2) * ck
                  + (1.0 - 2.0 * eta) * cv, cot_k1, cot_vout)
    return z_prev, v_prev, cot_k1, dv_prev, dparams


def _close_v0_vjp(f, params, z0, t0, a_z, a_v, g_params):
    """Close the v0 = f(z0, t0) initialization: route a_v into z0/params."""
    _, vjp_f = vjp(lambda p, z: f(p, z, t0), params, z0)
    dp, dz = vjp_f(a_v)
    return tree_add(g_params, dp), tree_add(a_z, dz)


def _mali_forward(cfg: MaliConfig, params, z0, ts):
    """One grid integration of the augmented (z, v) state under cfg's
    controller; returns the full GridResult bookkeeping."""
    v0 = init_velocity(cfg.f, params, z0, ts[0])
    solver = ALF(cfg.eta, cfg.backend)
    trial = solver.trial_fn(cfg.f, params, cfg.controller)
    return integrate_grid(trial, (z0, v0), ts, controller=cfg.controller,
                          order=solver.order, rows=cfg.rows)


def _mali_grid(cfg: MaliConfig, params, z0, ts):
    """The MALI autograd node over (params, z0, ts); returns
    ``(z_traj, RunStats)``."""

    def fwd(params, z0, ts):
        res = _mali_forward(cfg, params, z0, ts)
        z_traj, v_traj = res.traj
        stats = make_run_stats(res.n_accepted, res.n_trials, 1, 1)
        # Residuals: the per-observation (z_k, v_k) pairs — O(T * N_z),
        # constant in the step count — the recorded (t_i, h_i), ts and
        # the params.
        return z_traj, stats, (z_traj, v_traj, params, ts, res.ts, res.hs,
                               res.n_accepted)

    def bwd(residuals, g_traj):
        z_traj, v_traj, params, ts, seg_ts, seg_hs, seg_acc = residuals
        n_seg = ts.shape[0] - 1
        plan = sweep_counts(cfg.controller, seg_acc)

        def step_body(c, t_start, h, live):
            z_i, v_i, az, av, gp = c
            new = _step_backward(cfg, params, z_i, v_i, t_start, h, az, av,
                                 live)
            kept = keep_rows(live, new[:4], c[:4])
            return (*kept, tree_add(gp, new[4]))

        def seg(carry, g_k1, k):
            a_z, a_v, g_p = carry
            # Restart from the stored segment-end state (the exact forward
            # value) rather than chaining psi^-1 across segments, so float
            # drift does not accumulate across observations.
            a_z = tree_add(a_z, g_k1)
            carry_k = (tree_row(z_traj, k + 1), tree_row(v_traj, k + 1),
                       a_z, a_v, g_p)
            n_steps, row_counts = plan[k]
            _, _, a_z, a_v, g_p = reverse_masked_scan(
                step_body, carry_k, seg_ts[k], seg_hs[k], n_steps,
                row_counts=row_counts)
            return (a_z, a_v, g_p)

        z0 = tree_row(z_traj, 0)
        carry0 = (tree_zeros_like(z0), tree_zeros_like(tree_row(v_traj, 0)),
                  tree_zeros_like(params))
        a_z, a_v, g_params = reverse_segment_sweep(seg, carry0, g_traj,
                                                   n_seg)
        g_params, a_z = _close_v0_vjp(cfg.f, params, z0, ts[0], a_z, a_v,
                                      g_params)
        g_ts = None
        if cfg.diff_bounds:
            # a(t0) is the flow-swept adjoint: total dL/dz0 minus the
            # traj[0] == z0 identity-row cotangent.
            a_t0 = tree_sub(a_z, tree_row(g_traj, 0))
            g_ts = bounds_cotangents(cfg.f, params, z_traj, ts, g_traj, a_t0)
        return g_params, a_z, g_ts

    return grid_vjp(fwd, bwd, params, z0, ts)


@dataclasses.dataclass(frozen=True)
class MALI(GradientMethod):
    """The paper's method (Algo 4): trajectory-rebuilding gradients at
    O(T * N_z) residual memory, reverse-accurate with respect to its own
    forward discretization. ``fused_bwd`` shares psi^-1's f-eval with the
    local VJP (3 instead of 4 f-eval-equivalents per backward step).

    Time direction: the recorded (t_i, h_i) buffers are signed, so a
    reverse-time solve replays negative steps and psi^-1 runs with the
    same signed h."""

    fused_bwd: bool = True

    name = "mali"

    def default_solver(self) -> ALF:
        return ALF()

    def validate(self, solver, controller) -> None:
        if not isinstance(solver, ALF):
            raise ValueError(
                "MALI is defined for the ALF solver only (paper Sec 3); got "
                f"solver {getattr(solver, 'name', solver)!r}. Pass "
                "solver=ALF(eta=...) or use gradient=Naive().")

    def integrate(self, f, params, z0, ts, solver, controller,
                  diff_bounds: bool = False, rows: int = 0):
        cfg = MaliConfig(per_sample(f) if rows else f, solver.eta,
                         controller, self.fused_bwd, solver.backend,
                         diff_bounds, rows)
        return _mali_grid(cfg, params, z0, ts)

    def residual_bytes(self, z0, n_obs, solver, controller) -> int:
        # The per-observation (z_k, v_k) pairs — constant in step count.
        return 2 * n_obs * state_nbytes(z0)


def odeint_mali(f: Dynamics, params: Pytree, z0: Pytree,
                t0=0.0, t1=1.0, *, ts=None, n_steps: int = 0,
                eta: float = 1.0, rtol: float = 1e-2, atol: float = 1e-3,
                max_steps: int = 64, fused_bwd: bool = True) -> Pytree:
    """Integrate dz/dt = f(params, z, t) with MALI gradients (legacy
    kwargs facade). Without ``ts``: z(t1) over [t0, t1]; with ``ts``
    (T >= 2 points): the (T, ...) trajectory, ``traj[0] == z0``.
    ``n_steps > 0`` selects ``ConstantSteps``, ``n_steps == 0``
    ``AdaptiveController(rtol, atol, max_steps)``."""
    check_eta(eta)
    cfg = MaliConfig(f, float(eta),
                     controller_from_kwargs(n_steps, rtol, atol, max_steps),
                     bool(fused_bwd))
    return grid_run(lambda grid: _mali_grid(cfg, params, z0, grid)[0], z0,
                    t0, t1, ts)


def mali_forward_stats(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0,
                       t1=1.0, *, eta: float = 1.0, rtol: float = 1e-2,
                       atol: float = 1e-3, max_steps: int = 64):
    """Adaptive forward only, returning (zT, n_accepted, n_evals) for the
    paper's m / N_t accounting. Superseded by ``Solution.stats`` (where
    n_evals = n_accepted + n_rejected)."""
    check_eta(eta)
    cfg = MaliConfig(f, float(eta),
                     AdaptiveController(float(rtol), float(atol),
                                        int(max_steps)))
    grid = scalar_time_grid(t0, t1, pytree.tree_leaves(z0)[0].device)
    with torch.no_grad():
        res = _mali_forward(cfg, params, z0, grid)
    return res.state[0], torch.sum(res.n_accepted), res.n_trials
