"""Solver objects (the ``psi`` step functions of paper Algo 1) + registry.

* :class:`Solver` — the interface every solver implements: how to build
  the integrator state from ``z0`` (plain ``z`` for Runge-Kutta, the
  augmented ``(z, v)`` pair for ALF), how to advance it one (trial) step,
  and how to read ``z`` back out of it.
* :class:`RungeKutta` — a solver backed by a :class:`ButcherTableau`
  (order / FSAL / embedded-error metadata live on the tableau). Its
  stages are plain PyTorch, as the JAX package's are plain ``jnp``.
* :class:`ALF` — the Asynchronous Leapfrog solver of the paper (Algo 2/3).

Tableaus: Euler, Heun2 (Heun-Euler with its embedded Euler error — the
solver ACA used in the paper), explicit midpoint, Bogacki-Shampine 3(2)
("RK23"), classic RK4 and Dormand-Prince 5(4) ("Dopri5"), with the JAX
package's coefficients as the same Python floats, summed in the same
order, so the port's steps match it to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import rows_like

from .alf import (alf_step, alf_step_with_error, check_backend, check_eta,
                  init_velocity)
from .dense import pad_dead_rows, shift_to_step_ends

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]
# trial(state, t, h) -> (state_next, err_ratio); err_ratio <= 1 accepts.
TrialFn = Callable[[Pytree, torch.Tensor, torch.Tensor],
                   Tuple[Pytree, torch.Tensor]]

_tm = pytree.tree_map


def _weighted_sum(terms: Sequence[Tuple[float, Pytree]]) -> Optional[Pytree]:
    """sum(c_i * tree_i) left to right, skipping zero coefficients; None
    if all are zero."""
    terms = [(c, k) for (c, k) in terms if c != 0.0]
    if not terms:
        return None
    acc = _tm(lambda x: terms[0][0] * x, terms[0][1])
    for c, k in terms[1:]:
        acc = _tm(lambda a, x: a + c * x, acc, k)
    return acc


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    order: int
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    b_err: Optional[Tuple[float, ...]] = None  # b - b_hat (error weights)
    fsal: bool = False

    def step(self, f: Dynamics, params: Pytree, z: Pytree, t: torch.Tensor,
             h: torch.Tensor,
             with_error: bool = True) -> Tuple[Pytree, Optional[Pytree]]:
        """One step ``z -> z + h * sum(b_i k_i)`` and, when the tableau
        has error weights and ``with_error``, the embedded error estimate
        ``h * sum(b_err_i k_i)`` (else None). A (B,) ``t``/``h`` (one per
        row, ``PerSample``) broadcasts against each leaf's batch axis."""
        ks = []
        for i, ci in enumerate(self.c):
            incr = _weighted_sum(list(zip(self.a[i], ks)))
            zi = z if incr is None else _tm(
                lambda zz, dd: zz + rows_like(h, dd) * dd, z, incr)
            ks.append(f(params, zi, t + ci * h))
        upd = _weighted_sum(list(zip(self.b, ks)))
        z_next = _tm(lambda zz, dd: zz + rows_like(h, dd) * dd, z, upd)
        err = None
        if with_error and self.b_err is not None:
            e = _weighted_sum(list(zip(self.b_err, ks)))
            err = _tm(lambda x: rows_like(h, x) * x, e)
        return z_next, err


EULER = ButcherTableau("euler", 1, c=(0.0,), a=((),), b=(1.0,))

# Heun's 2nd-order with embedded Euler -> the "Heun-Euler" adaptive pair.
HEUN2 = ButcherTableau(
    "heun2", 2,
    c=(0.0, 1.0), a=((), (1.0,)), b=(0.5, 0.5),
    b_err=(-0.5, 0.5),  # (heun - euler) weights
)

MIDPOINT = ButcherTableau(
    "midpoint", 2, c=(0.0, 0.5), a=((), (0.5,)), b=(0.0, 1.0),
)

# Bogacki-Shampine 3(2) — torchdiffeq's "bosh3" / scipy "RK23".
BOSH3 = ButcherTableau(
    "bosh3", 3,
    c=(0.0, 0.5, 0.75, 1.0),
    a=((), (0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9)),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 0.25, 4 / 9 - 1 / 3, -0.125),
    fsal=True,
)

RK4 = ButcherTableau(
    "rk4", 4,
    c=(0.0, 0.5, 0.5, 1.0),
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
)

# Dormand-Prince 5(4) — torchdiffeq default "dopri5".
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_BH = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)
DOPRI5 = ButcherTableau(
    "dopri5", 5,
    c=(0.0, 0.2, 0.3, 0.8, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (0.2,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        _DP_B[:-1] + (0.0,),
    ),
    b=_DP_B,
    b_err=tuple(b - bh for b, bh in zip(_DP_B, _DP_BH)),
    fsal=True,
)


class Solver:
    """Interface shared by every solver (Table 1's solver axis).

    ``init_state``/``output`` mediate between the user-facing state ``z``
    and the solver's internal state (ALF augments it with the tracked
    velocity ``v``); ``trial_fn`` closes a uniform trial step
    ``(state, t, h) -> (state_next, err_ratio)`` over a controller. A
    (B,) ``h`` makes the trial per-row (``PerSample``): one ratio per
    row.
    """

    name: str = "?"
    order: int = 0
    stages: int = 1                 # f-evals per (trial) step
    has_error_estimate: bool = False

    def init_state(self, f: Dynamics, params: Pytree, z0: Pytree,
                   t0: torch.Tensor) -> Pytree:
        return z0

    def output(self, state: Pytree) -> Pytree:
        return state

    def trial_fn(self, f: Dynamics, params: Pytree, controller) -> TrialFn:
        raise NotImplementedError

    def kernel_step_ops(self) -> Tuple[str, ...]:
        """Registry qualnames ("<package>.<op>") of the kernel ops this
        solver's trial step launches; () when the step is plain PyTorch.
        :func:`repro_torch.core.naive.check_direct_backprop` refuses the
        solver if any of them is forward-only."""
        return ()

    def interpolant(self, f: Dynamics, params: Pytree, states: Pytree,
                    state_end: Pytree, ts: torch.Tensor, hs: torch.Tensor,
                    n_live: torch.Tensor):
        """Per-step endpoint data ``(y0, d0, y1, d1)`` for dense output.

        ``states`` is the recorded (bound, ...) buffer of accepted-step
        start solver states, ``state_end`` the final solver state,
        ``ts``/``hs`` the signed step times and sizes (rows past
        ``n_live`` are padding, backfilled with the end state so ``f``
        never sees the zeros). The default re-evaluates ``f`` at both step
        endpoints, batched over the whole buffer with ``torch.func.vmap``;
        solvers whose state carries a velocity (:class:`ALF`) read the
        slope off it instead."""
        from repro_torch.tree_util import vmap
        ends = shift_to_step_ends(states, state_end, n_live)
        y0 = self.output(pad_dead_rows(states, state_end, n_live))
        y1 = self.output(pad_dead_rows(ends, state_end, n_live))
        eval_f = vmap(lambda z, t: f(params, z, t))
        return y0, eval_f(y0, ts), y1, eval_f(y1, ts + hs)

    def interpolant_fevals(self, bound: int) -> int:
        """Dynamics evaluations :meth:`interpolant` spends over ``bound``
        recorded rows (two batched passes by default)."""
        return 2 * bound


@dataclasses.dataclass(frozen=True)
class RungeKutta(Solver):
    """A Runge-Kutta solver defined by its Butcher tableau. Its step is
    plain PyTorch (no kernel op), so ``kernel_step_ops()`` is ()."""

    tableau: ButcherTableau = EULER

    @property
    def name(self) -> str:
        return self.tableau.name

    @property
    def order(self) -> int:
        return self.tableau.order

    @property
    def stages(self) -> int:
        return len(self.tableau.c)

    @property
    def has_error_estimate(self) -> bool:
        return self.tableau.b_err is not None

    @property
    def fsal(self) -> bool:
        return self.tableau.fsal

    def trial_fn(self, f: Dynamics, params: Pytree, controller) -> TrialFn:
        # Under ConstantSteps every trial is accepted: skip the (unused)
        # error estimate.
        with_error = controller.adaptive

        def trial(z, t, h):
            z1, err = self.tableau.step(f, params, z, t, h, with_error)
            return z1, controller.error_ratio(err, z, z1, h.dim() > 0)

        return trial


@dataclasses.dataclass(frozen=True)
class ALF(Solver):
    """Asynchronous Leapfrog (paper Algo 2): the invertible solver MALI is
    defined on. State is the augmented ``(z, v)`` pair with
    ``v0 = f(z0, t0)`` (paper Sec 3.1); ``eta`` is the damping coefficient
    of Appendix A.5.

    ``backend='cuda'`` runs the step's elementwise state algebra through
    the fused :mod:`repro_torch.kernels.alf_step` kernels (one flat pass
    over the whole state pytree per op) instead of per-leaf tensor ops.
    The step's ops carry reverse rules (kernels too), so every gradient
    consumer accepts this backend: MALI's backward launches the fused
    backward or the inverse kernels, and direct backprop (``Naive``,
    ``SaveAt(steps|dense)``) differentiates through the launches."""

    eta: float = 1.0
    backend: str = "reference"

    name = "alf"
    order = 2
    stages = 1
    has_error_estimate = True       # embedded 1st-vs-2nd order estimate

    def __post_init__(self):
        check_eta(self.eta)
        check_backend(self.backend)

    def init_state(self, f, params, z0, t0):
        return (z0, init_velocity(f, params, z0, t0))

    def output(self, state):
        return state[0]

    def trial_fn(self, f, params, controller) -> TrialFn:
        if not controller.adaptive:
            # Every trial is accepted: skip the (unused) error estimate.
            def fixed_trial(state, t, h):
                z, v = state
                z1, v1 = alf_step(f, params, z, v, t, h, self.eta,
                                  self.backend)
                return (z1, v1), controller.error_ratio(None, z, z1)

            return fixed_trial

        def trial(state, t, h):
            z, v = state
            z1, v1, err = alf_step_with_error(f, params, z, v, t, h,
                                              self.eta, self.backend)
            return (z1, v1), controller.error_ratio(err, z, z1, h.dim() > 0)

        return trial

    def kernel_step_ops(self) -> Tuple[str, ...]:
        if self.backend != "cuda":
            return ()
        return ("alf_step.alf_midpoint", "alf_step.alf_update")

    def interpolant(self, f, params, states, state_end, ts, hs, n_live):
        """ALF dense output from the velocity pair: the augmented state
        tracks ``v ~ dz/dt`` at every node, so the Hermite slopes come off
        the recorded ``(z, v)`` with zero extra ``f`` evaluations."""
        ends = shift_to_step_ends(states, state_end, n_live)
        z0s, v0s = pad_dead_rows(states, state_end, n_live)
        z1s, v1s = pad_dead_rows(ends, state_end, n_live)
        return z0s, v0s, z1s, v1s

    def interpolant_fevals(self, bound: int) -> int:
        return 0


def Euler() -> RungeKutta:
    return RungeKutta(EULER)


def HeunEuler() -> RungeKutta:
    return RungeKutta(HEUN2)


def Midpoint() -> RungeKutta:
    return RungeKutta(MIDPOINT)


def Bosh3() -> RungeKutta:
    return RungeKutta(BOSH3)


def Rk4() -> RungeKutta:
    return RungeKutta(RK4)


def Dopri5() -> RungeKutta:
    return RungeKutta(DOPRI5)


SOLVERS = {
    "euler": RungeKutta(EULER),
    "heun2": RungeKutta(HEUN2),
    "heun_euler": RungeKutta(HEUN2),
    "midpoint": RungeKutta(MIDPOINT),
    "bosh3": RungeKutta(BOSH3),
    "rk23": RungeKutta(BOSH3),
    "rk2": RungeKutta(HEUN2),
    "rk4": RungeKutta(RK4),
    "dopri5": RungeKutta(DOPRI5),
    "alf": ALF(),
}


def get_solver(name) -> Solver:
    """Resolve a solver: pass through :class:`Solver` instances, look up
    string names in the registry."""
    if isinstance(name, Solver):
        return name
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered solver names: "
            f"{', '.join(sorted(SOLVERS))} (or pass a Solver instance)") \
            from None
