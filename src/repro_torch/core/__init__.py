"""The MALI integrator on PyTorch: the composable ``solve()`` with every
solver (ALF and the Runge-Kutta tableaus), controller and gradient method
(MALI, Naive, ACA, Backsolve) of the JAX package, per-step and dense
output, ``diff_bounds``, terminating events, the ``Lockstep``,
``PerSample`` and ``Sharded`` batching modes, and the legacy string-keyed
``odeint`` facade.

Module names follow the JAX package (``repro.core``) so each counterpart
is easy to find.
"""
from .aca import ACA
from .adjoint import Adjoint, Backsolve
from .alf import (BACKENDS, alf_inverse, alf_step, alf_step_with_error,
                  check_eta, init_velocity, tree_add, tree_scale, tree_sub,
                  tree_zeros_like)
from .api import (METHODS, mali_forward_stats, odeint, odeint_aca,
                  odeint_adjoint, odeint_mali, odeint_naive)
from .dense import DenseInterpolation, hermite_coefficients
from .integrate import as_time_grid, integrate_grid, integrate_span, \
    validate_span
from .interface import (Batching, Event, GradientMethod, Lockstep,
                        PerSample, RunStats, SaveAt, Sharded, Solution, Stats,
                        batch_size, state_nbytes)
from .mali import MALI
from .naive import Naive, check_direct_backprop
from .ode_block import OdeSettings, ode_block
from .solve import solve
from .solvers import (ALF, SOLVERS, Bosh3, ButcherTableau, Dopri5, Euler,
                      HeunEuler, Midpoint, Rk4, RungeKutta, Solver,
                      get_solver)
from .stepsize import AdaptiveController, ConstantSteps, StepController

__all__ = [
    # ALF primitives
    "alf_step", "alf_inverse", "alf_step_with_error", "init_velocity",
    "check_eta", "BACKENDS",
    # composable API
    "solve", "Solution", "SaveAt", "Stats", "RunStats", "GradientMethod",
    "DenseInterpolation", "hermite_coefficients",
    "Event", "Batching", "Lockstep", "PerSample", "Sharded", "batch_size",
    "MALI", "Naive", "ACA", "Backsolve", "Adjoint", "check_direct_backprop",
    "Solver", "RungeKutta", "ALF", "ButcherTableau",
    "Euler", "HeunEuler", "Midpoint", "Bosh3", "Rk4", "Dopri5",
    "StepController", "ConstantSteps", "AdaptiveController",
    # legacy facade
    "odeint", "odeint_mali", "odeint_naive", "odeint_aca", "odeint_adjoint",
    "mali_forward_stats", "METHODS", "SOLVERS", "get_solver",
    "OdeSettings", "ode_block",
    # drivers / tree utils
    "as_time_grid", "validate_span", "integrate_grid", "integrate_span",
    "tree_add", "tree_sub", "tree_scale", "tree_zeros_like", "state_nbytes",
]
