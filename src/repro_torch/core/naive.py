"""Naive method: backpropagate directly through the solver loop.

The integration loop is plain PyTorch under autograd, so every per-step
intermediate stays alive for the backward pass and residual memory grows
with the number of (trial) steps — the paper's characterization (memory
N_z*N_f*N_t*m). Naive-through-ALF on the reference backend is the gradient
oracle for MALI: both run the identical forward, so they agree to float
precision.
"""
from __future__ import annotations

import dataclasses

from .integrate import integrate_grid
from .interface import GradientMethod, make_run_stats, state_nbytes
from .solvers import ALF, Solver


def _naive_run(f, params, z0, ts, solver: Solver, controller):
    state0 = solver.init_state(f, params, z0, ts[0])
    trial = solver.trial_fn(f, params, controller)
    res = integrate_grid(trial, state0, ts, controller=controller,
                         order=solver.order)
    init_evals = 1 if isinstance(solver, ALF) else 0
    return (solver.output(res.traj),
            make_run_stats(res.n_accepted, res.n_trials, solver.stages,
                           init_evals))


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

    def integrate(self, f, params, z0, ts, solver, controller):
        return _naive_run(f, params, z0, ts, solver, controller)

    def residual_bytes(self, z0, n_obs, solver, controller) -> int:
        # Autograd keeps every trial step's intermediates alive — grows
        # with the per-segment step budget.
        state = 2 if isinstance(solver, ALF) else 1
        return ((n_obs - 1) * controller.step_bound * solver.stages
                * state * state_nbytes(z0))
