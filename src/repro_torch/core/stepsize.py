"""Step-size policy objects (paper Algo 1) — the step-controller axis.

* :class:`ConstantSteps` — ``n`` uniform sub-steps per observation segment
  (the paper's large-scale fixed-h setting; every trial is accepted).
* :class:`AdaptiveController` — the error-ratio controller of Algo 1 with
  ``rtol``/``atol`` and a bounded ``max_steps`` trial budget per segment
  (rejected trials still cost f-evals), warm-starting each segment at the
  previous segment's step proposal.
* :class:`ReproducibleController` — the same controller with its
  device-dependent float32 operations taken in float64 and rounded once:
  the error norm's sum of squares and mean, and the step-size factor's
  power. In float32 they differ between devices and batchings (the CPU's
  and the card's ``pow`` differ on ~6% of inputs; a per-row and a
  whole-state sum of the same elements, or the CPU's and the card's, add
  in other orders; the card divides by a Python number as a multiply by
  its reciprocal), and on a stiff problem an ulp in one step size
  changes later accept/reject decisions. Rounded once, a solve takes the
  same steps on every device and in every batching (a row of a batch,
  alone): the serve engine's controller.

Both controllers take their square roots correctly rounded (the error
norm's in float64, rounded once; the initial step's on the host). The
CPU's float32 ``sqrt`` is MKL's vector kernel, which misses the correct
rounding on ~0.6% of inputs on an AVX-512 host, on none with AVX2 and on
~17% without FMA (``tests/f1_host_probe.py``).

The numeric policy is plain tensor functions over 0-d tensors, computed on
the state's device; the driving loop lives in
:mod:`repro_torch.core.integrate`.

**One controller over several ranks.** Inside :func:`global_error_norm`
(a data-parallel training step whose blocks solve adaptively without a
batch axis: each rank holds its rows of the global batch) a Lockstep
solve's error norm is the global batch's, as the JAX package's GSPMD
computes it: each rank's sum of squares and element count are summed
over the group (in the controller's accumulation dtype, one collective)
before the mean and the root. The ranks' parts are gathered and added in
rank order, the same arithmetic on every rank, so the ratio, and with it
every accept/reject decision and step size, is bit-equal on the ranks,
and MALI's backward replays the same ``(t_i, h_i)`` everywhere with no
collective. Where autograd reaches the norm (Naive differentiates
through the step sizes) the backward sums the cotangent over the group,
as ``psum``'s transpose does.

The group is the ranks that hold one system's rows: the whole rows'
group for one controller over the global batch, or, in a ``Sharded``
fleet whose blocks span several ranks, the ranks of this rank's block
(:func:`~repro_torch.distributed.data_parallel.fleet_of`: one group for
each block, the blocks' reductions running side by side). The
reduction is counted as ``error_norm@<the group's axes>``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, ClassVar, Iterator, List

import numpy as np
import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import rows_like

# Classic Hairer-Norsett-Wanner defaults.
SAFETY = 0.9
MIN_FACTOR = 0.2     # paper's DecayFactor floor
MAX_FACTOR = 10.0    # paper's IncreaseFactor ceiling


def _tol_rows(tol, x: torch.Tensor, rows: bool):
    """A (B,) tolerance shaped against the leaf ``x`` under ``rows``; a
    Python number (or any tolerance off the per-row path) as it is."""
    if rows and isinstance(tol, torch.Tensor):
        return rows_like(tol, x)
    return tol


# The groups a Lockstep solve's error norm is summed over, innermost last
# (a list, not thread-local state: autograd runs backward functions on its
# own threads).
_NORM_GROUPS: List[Any] = []


@contextlib.contextmanager
def global_error_norm(group) -> Iterator[None]:
    """Inside the block the error norm of every solve that is not per-row
    (``rows=False``) is summed over ``group`` (a
    :class:`~repro_torch.distributed.data_parallel.DataGroup` of the ranks
    that hold one system's rows: the global batch's, or one fleet
    block's; None: nothing changes), module docstring."""
    if group is None:
        yield
        return
    _NORM_GROUPS.append(group)
    try:
        yield
    finally:
        _NORM_GROUPS.pop()


class _GroupSum(torch.autograd.Function):
    """The ranks' (sum of squares, count) added in rank order on every
    rank; the backward sums the cotangent over the group the same way."""

    @staticmethod
    def forward(part, group):
        return group.all_gather(part[None], name="error_norm").sum(0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous()[None],
                                    name="error_norm_vjp").sum(0), None


def _scaled_rms(err: Any, z0: Any, z1: Any, rtol, atol, rows: bool,
                acc) -> torch.Tensor:
    """:func:`error_ratio`, its squares summed in ``acc`` (None: the
    elements' float32); inside :func:`global_error_norm` (and not per
    row) the sum and the count are the group's."""
    total = 0.0
    count = 0
    for e, a, b in zip(pytree.tree_leaves(err), pytree.tree_leaves(z0),
                       pytree.tree_leaves(z1)):
        scale = (_tol_rows(atol, a, rows)
                 + _tol_rows(rtol, a, rows)
                 * torch.maximum(torch.abs(a), torch.abs(b)))
        r = (e / scale).to(torch.float32)
        if rows:
            total = total + torch.sum((r * r).reshape(r.shape[0], -1), 1,
                                      dtype=acc)
            count += r[0].numel()
        else:
            total = total + torch.sum(r * r, dtype=acc)
            count += r.numel()
    # safe sqrt: d(sqrt)/dx at exactly 0 is inf, which poisons backprop
    # through the adaptive loop (0-cotangent * inf = NaN) — the naive
    # method differentiates through this code path.
    # The root in float64, rounded once: correctly rounded, as XLA's. The
    # CPU's float32 sqrt (MKL's vector kernel) is not, and which inputs it
    # misses moves with the host's instruction set.
    if _NORM_GROUPS and not rows:
        part = torch.stack([total, torch.full_like(total, count)])
        total, n = _GroupSum.apply(part, _NORM_GROUPS[-1]).unbind(0)
        ms = total / n
    else:
        ms = total / max(count, 1)
    pos = ms > 0
    root = torch.sqrt(torch.where(pos, ms, torch.ones_like(ms)).double())
    return root.to(ms.dtype) * torch.where(pos, 1.0, 0.0)


def error_ratio(err: Any, z0: Any, z1: Any, rtol, atol,
                rows: bool = False) -> torch.Tensor:
    """RMS of err scaled by atol + rtol*max(|z0|,|z1|). Accept iff <= 1.

    The reduction runs over every element of the state pytree, so a
    batch-shaped state integrates in lockstep (one shared accept/reject).
    With ``rows`` (``PerSample`` batching: every leaf has the batch axis
    in front) it runs over each row's elements across all leaves and
    gives a (B,) ratio, one accept/reject per row; ``rtol``/``atol`` may
    then be (B,) tensors, one tolerance pair per row (the serve engine's
    per-request tolerances), spread over each leaf's rows.
    """
    return _scaled_rms(err, z0, z1, rtol, atol, rows, None)


def _clipped_step(h: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    factor = torch.clamp(SAFETY * power, MIN_FACTOR, MAX_FACTOR)
    return h * factor


def next_step_size(h: torch.Tensor, ratio: torch.Tensor,
                   order: int) -> torch.Tensor:
    """h * clip(safety * ratio^(-1/(p+1))). The factor is strictly
    positive, so the sign of ``h`` (the integration direction) is kept."""
    ratio = torch.clamp_min(ratio, 1e-10)
    return _clipped_step(h, ratio ** (-1.0 / (order + 1)))


def _bounded_step(span: torch.Tensor,
                  tol_scale: torch.Tensor) -> torch.Tensor:
    base = torch.abs(span) * 0.05
    tol_scale = torch.clamp(tol_scale, 1e-4, 1.0)
    return torch.sign(span) * torch.maximum(base * tol_scale,
                                            torch.abs(span) * 1e-4)


def initial_step_size(rtol: float, atol: float,
                      span: torch.Tensor) -> torch.Tensor:
    """A small fraction of the span, tolerance-scaled, signed like the span
    (a negative span — reverse time — proposes a negative step)."""
    # the float32 tolerance's root taken on the host, correctly rounded,
    # then a fill on the device: no host-to-device copy, so no sync
    root = float(np.sqrt(np.float32(rtol + atol)))
    return _bounded_step(span, torch.full((), root, dtype=torch.float32,
                                          device=span.device))


@dataclasses.dataclass(frozen=True)
class StepController:
    """Base step-size policy: the accept/reject decision (``error_ratio``:
    <= 1 accepts) and the per-segment recorded-step bound (``step_bound``:
    the size of the buffers the backward sweep replays)."""

    adaptive: ClassVar[bool] = False

    def error_ratio(self, err: Any, z0: Any, z1: Any,
                    rows: bool = False) -> torch.Tensor:
        raise NotImplementedError

    @property
    def step_bound(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantSteps(StepController):
    """Fixed uniform grid: ``n`` sub-steps per observation segment."""

    n: int = 8

    adaptive: ClassVar[bool] = False

    def __post_init__(self):
        try:
            n = int(self.n)
        except (TypeError, ValueError):
            n = -1
        if n < 1 or n != self.n:
            raise ValueError(
                f"ConstantSteps needs a positive integer step count, got "
                f"n={self.n!r}")
        object.__setattr__(self, "n", n)

    def error_ratio(self, err, z0, z1, rows=False) -> torch.Tensor:
        # Every trial is accepted.
        return torch.zeros((), device=pytree.tree_leaves(z0)[0].device)

    @property
    def step_bound(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class AdaptiveController(StepController):
    """Paper Algo 1: accept iff the atol/rtol-scaled error RMS is <= 1,
    shrink on reject / grow on accept with the clipped single-exponent
    factor, under a ``max_steps`` trial budget per segment."""

    rtol: float = 1e-2
    atol: float = 1e-3
    max_steps: int = 64

    adaptive: ClassVar[bool] = True

    def __post_init__(self):
        if self.rtol < 0.0 or self.atol < 0.0:
            raise ValueError(
                f"tolerances must be non-negative, got rtol={self.rtol}, "
                f"atol={self.atol}")
        if self.rtol == 0.0 and self.atol == 0.0:
            raise ValueError("rtol and atol cannot both be zero")
        try:
            m = int(self.max_steps)
        except (TypeError, ValueError):
            m = -1
        if m < 1 or m != self.max_steps:
            raise ValueError(
                f"max_steps must be a positive integer, got {self.max_steps!r}")
        object.__setattr__(self, "max_steps", m)
        object.__setattr__(self, "rtol", float(self.rtol))
        object.__setattr__(self, "atol", float(self.atol))

    def error_ratio(self, err, z0, z1, rows=False) -> torch.Tensor:
        if err is None:
            raise ValueError(
                "adaptive step control needs a solver with an embedded "
                "error estimate; use ConstantSteps with this solver")
        return self.norm(err, z0, z1, self.rtol, self.atol, rows)

    # The policy's arithmetic, free of the instance's tolerances: the
    # serve engine calls it with (B,) per-request ones.
    @staticmethod
    def norm(err, z0, z1, rtol, atol, rows: bool = False) -> torch.Tensor:
        """The error ratio at ``rtol``/``atol`` (:func:`error_ratio`)."""
        return error_ratio(err, z0, z1, rtol, atol, rows)

    @staticmethod
    def next_step(h: torch.Tensor, ratio: torch.Tensor,
                  order: int) -> torch.Tensor:
        """The step proposed after a trial of step ``h`` and error ratio
        ``ratio`` by a method of ``order``."""
        return next_step_size(h, ratio, order)

    @property
    def step_bound(self) -> int:
        return self.max_steps

    def initial_step(self, span: torch.Tensor) -> torch.Tensor:
        return initial_step_size(self.rtol, self.atol, span)


@dataclasses.dataclass(frozen=True)
class ReproducibleController(AdaptiveController):
    """:class:`AdaptiveController` with its device-dependent float32
    operations rounded once (module docstring): its accept/reject
    decisions and step sizes are the same on the CPU and the card, and
    for a row of a ``PerSample`` batch and the same sample alone. The
    serve engine decides with it."""

    @staticmethod
    def norm(err, z0, z1, rtol, atol, rows: bool = False) -> torch.Tensor:
        """The sum of squares, its mean and the root in float64, the ratio
        rounded to float32 once."""
        return _scaled_rms(err, z0, z1, rtol, atol, rows,
                           torch.float64).to(torch.float32)

    @staticmethod
    def next_step(h: torch.Tensor, ratio: torch.Tensor,
                  order: int) -> torch.Tensor:
        """The float32 power taken in float64 and rounded once: the
        correctly rounded power."""
        ratio = torch.clamp_min(ratio, 1e-10)
        # the exponent as a float32 pow takes it
        exponent = float(np.float32(-1.0 / (order + 1)))
        power = torch.pow(ratio.double(), exponent).to(ratio.dtype)
        return _clipped_step(h, power)


def controller_from_kwargs(n_steps: int, rtol: float, atol: float,
                           max_steps: int) -> StepController:
    """Map the legacy kwargs convention (n_steps > 0 fixed, == 0 adaptive)
    to a StepController — shared by every legacy odeint facade."""
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0 (0 selects adaptive control),"
                         f" got {n_steps}")
    if n_steps > 0:
        return ConstantSteps(int(n_steps))
    return AdaptiveController(float(rtol), float(atol), int(max_steps))
