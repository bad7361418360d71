"""The MALI integrator on PyTorch: ``solve()`` with ALF, MALI and Naive,
and per-step and dense output.

Module names follow the JAX package (``repro.core``) so each counterpart
is easy to find.
"""
from .alf import (BACKENDS, alf_inverse, alf_step, alf_step_with_error,
                  check_eta, init_velocity)
from .dense import DenseInterpolation, hermite_coefficients
from .interface import (GradientMethod, RunStats, SaveAt, Solution, Stats,
                        state_nbytes)
from .mali import MALI
from .naive import Naive, check_direct_backprop
from .ode_block import OdeSettings
from .solve import solve
from .solvers import ALF, Solver, get_solver
from .stepsize import AdaptiveController, ConstantSteps, StepController

__all__ = [
    "solve", "Solution", "SaveAt", "Stats", "RunStats", "GradientMethod",
    "MALI", "Naive", "check_direct_backprop", "ALF", "Solver", "get_solver",
    "ConstantSteps", "AdaptiveController", "StepController", "BACKENDS",
    "alf_step", "alf_inverse", "alf_step_with_error", "init_velocity",
    "check_eta", "state_nbytes", "DenseInterpolation",
    "hermite_coefficients", "OdeSettings",
]
