"""Legacy string-keyed ``odeint`` facade over the composable ``solve()``.

``odeint(method=..., solver=..., n_steps=...)`` predates the object API
and is kept behaviour-preserving: it builds the Solver / StepController /
GradientMethod / SaveAt objects and returns ``Solution.ys`` (see
:mod:`repro_torch.core.solve`). New code should call ``solve()``; calling
this facade emits a ``DeprecationWarning``.

Inapplicable kwargs are not silently dropped: ``eta`` with a non-ALF
solver or ``fused_bwd`` with a non-MALI method raises, and
``rtol``/``atol``/``max_steps`` beside a fixed ``n_steps > 0`` warns.
``solver`` may also be a Solver instance, as in the JAX facade:
``solver=ALF(backend="cuda")`` runs the ALF step on the kernels.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable

from .aca import ACA, odeint_aca
from .adjoint import Backsolve, odeint_adjoint
from .interface import SaveAt
from .mali import MALI, mali_forward_stats, odeint_mali
from .naive import Naive, odeint_naive
from .solve import solve
from .solvers import ALF, get_solver
from .stepsize import AdaptiveController, ConstantSteps

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, Any], Pytree]

_DEFAULT_SOLVER = {
    "mali": "alf",
    "naive": "alf",
    "aca": "heun_euler",
    "adjoint": "dopri5",
}

METHODS = tuple(_DEFAULT_SOLVER)


def _gradient_for(method: str, fused_bwd: bool):
    if method == "mali":
        return MALI(fused_bwd=fused_bwd)
    if method == "naive":
        return Naive()
    if method == "aca":
        return ACA()
    return Backsolve()


def odeint(f: Dynamics, params: Pytree, z0: Pytree, t0=0.0, t1=1.0, *,
           ts=None, method: str = "mali", solver: str | None = None,
           n_steps: int | None = None, eta: float | None = None,
           rtol: float | None = None, atol: float | None = None,
           max_steps: int | None = None,
           fused_bwd: bool | None = None) -> Pytree:
    """Integrate dz/dt = f(params, z, t).

    * ``ts=None`` (default): integrate over [t0, t1] and return ``z(t1)``
      with the structure of ``z0``.
    * ``ts`` a 1-D grid of T >= 2 strictly monotonic timepoints: return
      the trajectory whose leaves gain a leading axis T, ``traj[0] == z0``
      (``t0``/``t1`` are ignored).

    method: 'mali' (paper), 'naive', 'aca', 'adjoint' (Table 1 baselines).
    solver: 'alf' | 'euler' | 'heun_euler' | 'midpoint' | 'rk23' | 'rk4' |
            'dopri5' (and the registry's aliases), or a Solver instance;
            MALI requires ALF.
    n_steps > 0 -> fixed uniform grid per observation segment;
            n_steps == 0 (default) -> adaptive (rtol/atol, bounded by
            max_steps trials per segment); n_steps < 0 -> error.

    Example::

        traj = odeint(f, params, z0, ts=torch.linspace(0.0, 1.0, 8),
                      method="aca", n_steps=4)      # (8, *z0.shape)
    """
    warnings.warn(
        "odeint() is a legacy string-keyed facade; use "
        "repro_torch.core.solve() with Solver/StepController/"
        "GradientMethod/SaveAt objects — it also exposes Solution.stats, "
        "reverse-time spans and dense output",
        DeprecationWarning, stacklevel=2)
    if method not in _DEFAULT_SOLVER:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    solver_name = solver or _DEFAULT_SOLVER[method]

    # Reject silently-inapplicable kwargs (only defaults are filled in).
    if eta is not None and solver_name != "alf":
        raise ValueError(
            f"eta={eta} was passed, but method={method!r} with "
            f"solver={solver_name!r} ignores it — eta is the ALF damping "
            "coefficient. Drop it, or pick solver='alf'.")
    if fused_bwd is not None and method != "mali":
        raise ValueError(
            f"fused_bwd={fused_bwd} was passed, but it is MALI's "
            f"backward-sharing switch; method={method!r} ignores it.")
    if n_steps is not None and n_steps < 0:
        raise ValueError(f"n_steps must be >= 0 (0 selects adaptive "
                         f"control), got {n_steps}")
    fixed = n_steps is not None and n_steps > 0
    if fixed:
        dropped = [kw for kw, v in (("rtol", rtol), ("atol", atol),
                                    ("max_steps", max_steps))
                   if v is not None]
        if dropped:
            warnings.warn(
                f"{'/'.join(dropped)} ignored: n_steps={n_steps} selects "
                "the fixed-step controller", stacklevel=2)

    solver_obj = (ALF(eta=1.0 if eta is None else float(eta))
                  if solver_name == "alf" else get_solver(solver_name))
    # Only pass what the caller set: AdaptiveController's defaults stay
    # the single source of truth.
    adaptive_kw = {k: v for k, v in
                   (("rtol", rtol), ("atol", atol), ("max_steps", max_steps))
                   if v is not None}
    controller = (ConstantSteps(int(n_steps)) if fixed else
                  AdaptiveController(**adaptive_kw))
    gradient = _gradient_for(method, True if fused_bwd is None else
                             bool(fused_bwd))
    saveat = SaveAt() if ts is None else SaveAt(ts=ts)
    return solve(f, params, z0, t0, t1, solver=solver_obj,
                 controller=controller, gradient=gradient, saveat=saveat).ys


__all__ = ["odeint", "odeint_mali", "odeint_naive", "odeint_aca",
           "odeint_adjoint", "mali_forward_stats", "METHODS"]
