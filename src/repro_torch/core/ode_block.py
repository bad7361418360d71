"""ODEBlock: the paper's technique as a composable network module.

A residual block ``y = x + g(x)`` is the one-step Euler discretization of
``dz/dt = g(z, t)``; an ODEBlock replaces it with a continuous
integration ``y = z(T), z(0) = x`` (paper Sec 4.2). :class:`OdeSettings`
is the flat, hashable record model configs carry
(``configs.ModelConfig.ode``); ``as_objects()`` lowers it to the Solver /
StepController / GradientMethod / SaveAt objects
:func:`repro_torch.core.solve.solve` takes, every method and solver name
of the JAX package included. Field names, defaults and checks are the JAX
package's (``repro.core.ode_block.OdeSettings``), with two differences of
the port: the JAX ``backend="pallas"`` is the port's ``"cuda"`` (both
names are accepted), and :meth:`OdeSettings.batching` gives
``Sharded(axis=batch_axis)`` over a ``torch.distributed`` device mesh.

The LM serve path reads only ``mode``, ``n_steps``, ``eta`` and ``t1``: it
unrolls the ALF steps explicitly (``models/transformer.py::layer_serve``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from .aca import ACA
from .adjoint import Backsolve
from .alf import check_eta
from .interface import Batching, SaveAt, Sharded
from .mali import MALI
from .naive import Naive
from .solve import solve
from .solvers import ALF, SOLVERS, get_solver
from .stepsize import AdaptiveController, ConstantSteps

Pytree = Any

_METHODS = ("mali", "naive", "aca", "adjoint")
# the JAX package's backend names -> the port's ALF backends
_BACKEND = {"reference": "reference", "pallas": "cuda", "cuda": "cuda"}


@dataclasses.dataclass(frozen=True)
class OdeSettings:
    """Integrator settings carried by model configs (hashable/static).

    ``t0``/``t1`` bound the integration span; ``t0 > t1`` expresses a
    reverse-time block.
    """
    mode: str = "off"          # 'off' | 'per_block'
    method: str = "mali"       # gradient method
    solver: str = "alf"
    n_steps: int = 2           # 0 = adaptive
    t0: float = 0.0            # span start (t0 > t1 = reverse-time block)
    t1: float = 1.0
    eta: float = 1.0           # ALF damping
    rtol: float = 1e-2
    atol: float = 1e-3
    max_steps: int = 32
    fused_bwd: bool = True     # share psi^-1's f-eval with the local VJP
    obs_times: Optional[Tuple[float, ...]] = None  # observation grid ts
    backend: str = "reference"  # 'reference' | 'cuda' ('pallas' = 'cuda')
    batch_axis: Optional[str] = None  # mesh axis for Sharded() batching

    def validate(self) -> "OdeSettings":
        if self.mode not in ("off", "per_block"):
            raise ValueError(f"bad ode.mode {self.mode!r}")
        if self.method not in _METHODS:
            raise ValueError(f"bad ode.method {self.method!r}; "
                             f"choose from {_METHODS}")
        if self.solver not in SOLVERS:
            raise ValueError(f"bad ode.solver {self.solver!r}; "
                             f"choose from {sorted(SOLVERS)}")
        if self.method == "mali" and self.solver != "alf":
            raise ValueError("MALI requires the ALF solver")
        if self.n_steps < 0:
            raise ValueError(f"ode.n_steps must be >= 0 (0 = adaptive), "
                             f"got {self.n_steps}")
        if self.max_steps < 1:
            raise ValueError(f"ode.max_steps must be >= 1, "
                             f"got {self.max_steps}")
        if self.rtol < 0.0 or self.atol < 0.0:
            raise ValueError(f"ode tolerances must be non-negative, got "
                             f"rtol={self.rtol}, atol={self.atol}")
        if not math.isfinite(self.t0):
            raise ValueError(f"ode.t0 must be finite, got {self.t0}")
        if not math.isfinite(self.t1):
            raise ValueError(f"ode.t1 must be finite, got {self.t1}")
        if self.t0 == self.t1:
            raise ValueError(
                f"ode.t0 == ode.t1 == {self.t1} is an empty integration "
                "span; use t1 > t0 for a forward block or t0 > t1 for a "
                "reverse-time block")
        if self.solver == "alf":
            check_eta(self.eta)
        if self.obs_times is not None and len(self.obs_times) < 2:
            raise ValueError("obs_times needs at least 2 timepoints")
        if self.backend not in _BACKEND:
            raise ValueError(f"bad ode.backend {self.backend!r}; "
                             f"choose from {sorted(_BACKEND)}")
        if _BACKEND[self.backend] == "cuda" and self.solver != "alf":
            raise ValueError(f"ode.backend={self.backend!r} requires the ALF "
                             "solver (the fused step kernels are "
                             "ALF-specific)")
        if self.batch_axis is not None and self.obs_times is not None:
            raise ValueError("ode.batch_axis with obs_times is unsupported: "
                             "batched trajectories are (B, T, ...) while the "
                             "block contract is time-leading (T, ...)")
        return self

    def as_objects(self):
        """Lower to (solver, controller, gradient, saveat) for solve()."""
        self.validate()
        solver = (ALF(eta=self.eta, backend=_BACKEND[self.backend])
                  if self.solver == "alf" else get_solver(self.solver))
        controller = (ConstantSteps(self.n_steps) if self.n_steps > 0 else
                      AdaptiveController(self.rtol, self.atol,
                                         self.max_steps))
        gradient = {"mali": MALI(fused_bwd=self.fused_bwd),
                    "naive": Naive(), "aca": ACA(),
                    "adjoint": Backsolve()}[self.method]
        saveat = (SaveAt() if self.obs_times is None else
                  SaveAt(ts=torch.tensor(self.obs_times,
                                         dtype=torch.float32)))
        return solver, controller, gradient, saveat

    def batching(self) -> Optional[Batching]:
        """The Batching object of this block's solves (None: the batch
        one system, lockstep). ``batch_axis`` names a mesh dimension: the
        block's solve runs as a ``Sharded(axis)`` fleet over the ambient
        ``with mesh:`` context (:mod:`repro_torch.distributed.sharding`).
        Under data parallelism over that axis the rows are already split
        (:func:`~repro_torch.distributed.data_parallel.solves_per_shard`):
        this rank's rows are its shard, solved with ``Sharded``'s inner
        batching and not sliced again."""
        if self.batch_axis is None:
            return None
        from repro_torch.distributed.data_parallel import solves_per_shard
        sharded = Sharded(axis=self.batch_axis)
        return sharded.inner if solves_per_shard(self) else sharded


def ode_block(dynamics: Callable[[Pytree, Pytree, Any], Pytree],
              settings: OdeSettings) -> Callable[[Pytree, Pytree], Pytree]:
    """Wrap ``dynamics(params, z, t)`` into ``apply(params, x)``: ``z(t1)``
    integrated from ``settings.t0`` (``t0 > t1`` runs the block in reverse
    time), or the trajectory over ``settings.obs_times``."""
    solver, controller, gradient, saveat = settings.as_objects()

    def apply(params: Pytree, x: Pytree) -> Pytree:
        return solve(dynamics, params, x, settings.t0, settings.t1,
                     solver=solver, controller=controller, gradient=gradient,
                     saveat=saveat).ys

    return apply
