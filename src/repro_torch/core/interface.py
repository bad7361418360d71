"""Shared interface types of the composable ``solve()`` API.

* :class:`GradientMethod` — the gradient-estimation axis of paper Table 1.
  Each method validates its solver/controller compatibility (MALI => ALF),
  owns its autograd wiring, and integrates over an observation grid
  through one entry point.
* :class:`RunStats` — the raw accepted/trial counters a method's forward
  pass emits.
* :class:`Stats` / :class:`Solution` / :class:`SaveAt` — the user-facing
  result types of :func:`repro_torch.core.solve.solve`.
* :class:`Event` — a terminating event (stop at a sign change of
  ``cond_fn(z, t)``, bisection-refined on the dense interpolant).
* :class:`Batching` — the batching axis over a leading batch dimension:
  :class:`Lockstep` (the whole batch is one ODE system, one shared
  controller decision per trial), :class:`PerSample` (each row its own
  controller; :meth:`GradientMethod.integrate_batched`, with ``f`` called
  per sample through :func:`per_sample`) and :class:`Sharded` (the rows
  split over a ``torch.distributed`` device-mesh axis).
* :func:`grid_vjp` — the ``torch.autograd.Function`` wiring the
  memory-efficient methods share (where the JAX package gives each its
  own ``custom_vjp``), and :func:`bounds_cotangents`, the analytic
  ``dL/dts`` of ``solve(..., diff_bounds=True)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree_util as pytree

from .dense import DenseInterpolation

Pytree = Any


class RunStats(NamedTuple):
    """Step accounting from one forward integration (for fixed-step
    control rejected == 0)."""
    n_accepted: torch.Tensor   # int32: accepted solver steps, all segments
    n_rejected: torch.Tensor   # int32: rejected trial steps
    n_fevals: torch.Tensor     # int32: forward dynamics evaluations


def make_run_stats(n_accepted: torch.Tensor, n_trials: torch.Tensor,
                   stages: int, init_evals: int = 0) -> RunStats:
    """Fold raw driver counters into :class:`RunStats`. ``n_accepted`` is
    per segment, (T-1,) or (T-1, B) per row, and summed over the segments
    here; ``stages`` is the solver's f-evals per trial; ``init_evals``
    covers ALF's ``v0 = f(z0, t0)``, once per row."""
    n_acc = torch.sum(n_accepted, 0).to(torch.int32)
    n_tr = n_trials.to(torch.int32)
    return RunStats(n_acc, n_tr - n_acc, n_tr * stages + init_evals)


class Stats(NamedTuple):
    """``Solution.stats``: the paper's Table 1 accounting for one solve.

    ``n_fevals`` counts forward-pass dynamics evaluations (trials x stages
    + 1 for ALF's ``v0``). ``residual_bytes`` is the analytic
    backward-residual footprint of the gradient method (MALI: the
    per-observation (z, v) pairs, constant in step count), computed from
    shapes — not a measurement."""
    n_accepted: torch.Tensor   # int32
    n_rejected: torch.Tensor   # int32
    n_fevals: torch.Tensor     # int32
    n_segments: int            # observation segments (T - 1)
    residual_bytes: int        # analytic residual-memory estimate
    # Batched solves (solve(..., batching=...)) set per_sample: (B,) rows,
    # one per batch sample; the scalar counters then hold the per-row
    # totals (a Lockstep batch reports B x the shared counts). None for
    # unbatched solves.
    per_sample: Optional["RunStats"] = None
    # Event solves (solve(..., event=Event(...))) set these two: did the
    # event end the span, and at what (bisection-refined) time (t1 when it
    # did not fire). None on other solves.
    event_fired: Optional[torch.Tensor] = None   # bool
    event_time: Optional[torch.Tensor] = None
    # Span-recording solves (SaveAt(steps=True)/dense=True) set this: False
    # when the AdaptiveController's max_steps budget ran out before t1, so
    # the record (and any interpolant over it) covers only a prefix of the
    # span. None where not tracked.
    span_complete: Optional[torch.Tensor] = None   # bool


class Solution(NamedTuple):
    """Result of :func:`repro_torch.core.solve.solve`: ``ys``/``ts`` are the
    end state and scalar ``t1`` (default), the (T, ...) trajectory over
    ``SaveAt.ts`` (``ys[0] == z0``), or the padded per-step record of
    ``SaveAt(steps=True)``, whose live rows :attr:`num_steps` /
    :attr:`step_mask` give. With ``SaveAt(dense=True)`` the solution is
    callable in time: :meth:`evaluate` interpolates the state anywhere in
    the span off per-step cubic-Hermite coefficients."""
    ys: Pytree
    ts: torch.Tensor
    stats: Stats
    # Dense-output record (SaveAt(dense=True)); None otherwise.
    interpolation: Optional[DenseInterpolation] = None
    # Live rows of the padded SaveAt(steps=True) buffer; None otherwise.
    n_live: Optional[torch.Tensor] = None

    @property
    def num_steps(self) -> torch.Tensor:
        """Accepted solver steps of the recorded trajectory; for
        ``SaveAt(steps=True)`` the live rows are ``0 .. num_steps``
        inclusive (the step-start states plus the final state)."""
        if self.n_live is not None:
            return self.n_live - 1
        return self.stats.n_accepted

    @property
    def step_mask(self) -> torch.Tensor:
        """Boolean mask over the rows of ``ts``/``ys``: all True for the
        exact-shape modes, True only for rows ``< n_live`` of the padded
        ``SaveAt(steps=True)`` buffer."""
        ts = torch.as_tensor(self.ts)
        if ts.dim() == 0:
            return torch.ones((), dtype=torch.bool, device=ts.device)
        if self.n_live is None:
            return torch.ones(ts.shape[0], dtype=torch.bool,
                              device=ts.device)
        return torch.arange(ts.shape[0], device=ts.device) < self.n_live

    def evaluate(self, t) -> Pytree:
        """Dense-output interpolation at query time(s) ``t`` (a scalar
        gives one state, a (Q,) tensor a leading Q axis), clamped into the
        span. Needs ``SaveAt(dense=True)``; differentiable with respect to
        params and z0 by direct backprop through the recorded steps."""
        if self.interpolation is None:
            raise ValueError(
                "Solution.evaluate(t) needs dense output: pass "
                "saveat=SaveAt(dense=True) to solve() to record the "
                "per-step interpolation coefficients")
        return self.interpolation.evaluate(t)

    def __call__(self, t) -> Pytree:
        """A dense Solution is callable in time: ``sol(t)`` is
        ``sol.evaluate(t)``."""
        return self.evaluate(t)


@dataclasses.dataclass(frozen=True, eq=False)
class SaveAt:
    """What to save, one mode per solve: ``ts=<1-D grid>`` for the
    trajectory at every requested timepoint (ascending or descending);
    ``steps=True`` for every accepted step's start state plus the final
    state, as a padded buffer; ``dense=True`` for per-step cubic-Hermite
    coefficients behind ``Solution.evaluate(t)``; otherwise only the final
    state ``z(t1)``."""
    ts: Optional[Any] = None
    steps: bool = False
    dense: bool = False

    def __post_init__(self):
        picked = [m for m, on in (("ts=<grid>", self.ts is not None),
                                  ("steps=True", self.steps),
                                  ("dense=True", self.dense)) if on]
        if len(picked) > 1:
            raise ValueError("SaveAt: pass only one of ts=<grid>, "
                             f"steps=True or dense=True, not {picked}")


@dataclasses.dataclass(frozen=True)
class Event:
    """Terminating event: stop the solve at a sign change of
    ``cond_fn(z, t)`` (a scalar event function).

    A detection pass integrates the whole ``[t0, t1]`` span on detached
    inputs, finds the first crossing among the recorded step nodes
    (filtered by ``direction``: 0 any, +1 rising only, -1 falling only),
    refines it by ``max_bisections`` bisections on the dense cubic-Hermite
    interpolant (no dynamics evaluation), then re-solves ``[t0, t_event]``
    with the chosen gradient method. Gradients flow through that
    frozen-``t_event`` re-solve for all four methods, and
    ``Solution.stats.event_time`` is differentiable through the implicit
    function theorem. Without a crossing the solve runs to ``t1`` and
    ``event_time == t1``. Under an
    :class:`~repro_torch.core.stepsize.AdaptiveController` the detection
    pass is one segment, so ``max_steps`` must cover the whole span.

    Example::

        ev = Event(lambda z, t: z[0] - 0.5, direction=+1)
        sol = solve(f, params, z0, 0.0, 10.0, event=ev)
        sol.ys                      # z(t_event)
        sol.stats.event_time        # the crossing time

    Equality is field-based, ``cond_fn`` by identity.
    """
    cond_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]
    direction: int = 0
    max_bisections: int = 32

    def __post_init__(self):
        if not callable(self.cond_fn):
            raise TypeError(f"Event.cond_fn must be callable (z, t) -> "
                            f"scalar, got {self.cond_fn!r}")
        if self.direction not in (-1, 0, 1):
            raise ValueError(f"Event.direction must be -1, 0 or +1, got "
                             f"{self.direction!r}")
        if not isinstance(self.max_bisections, int) or self.max_bisections < 1:
            raise ValueError(f"Event.max_bisections must be a positive "
                             f"integer, got {self.max_bisections!r}")


class Batching:
    """Base of the batching axis: how one ``solve`` treats the leading
    batch dimension of ``z0``. Batched solves return ``ys`` batch-first:
    ``(B, ...)`` for the end state, ``(B, T, ...)`` for a
    ``SaveAt(ts=grid)`` trajectory, whatever the mode."""

    name: str = "?"

    def validate(self, controller, saveat) -> None:
        """Reject or flag incompatible axes before integrating
        (overridden)."""


@dataclasses.dataclass(frozen=True)
class Lockstep(Batching):
    """The whole batch is one ODE system: the adaptive controller's error
    norm reduces over every sample, so there is one shared accept/reject
    decision per trial. What an unbatched ``solve`` over a batch-shaped
    ``z0`` does, made explicit."""

    name = "lockstep"


@dataclasses.dataclass(frozen=True)
class PerSample(Batching):
    """Per-sample adaptive control: each row carries its own ``(t, h,
    done)`` through the per-row driver (:mod:`repro_torch.core.integrate`)
    and accepts or rejects on its own error norm; a finished row rides
    along as a no-op, its trials uncounted. ``f`` is called per sample,
    with that row's scalar ``t`` (:func:`per_sample`), while the ALF
    kernels act on the whole batch with a per-row step size. Each gradient
    method's backward replays every row's own ``(t_i, h_i)``. Fewer total
    f-evals than :class:`Lockstep` on stiffness-heterogeneous batches."""

    name = "per_sample"

    def validate(self, controller, saveat) -> None:
        if saveat is not None and (saveat.steps or saveat.dense):
            mode = "steps=True" if saveat.steps else "dense=True"
            raise ValueError(
                f"SaveAt({mode}) under PerSample() batching is ragged "
                "(each sample accepts a different number of steps); use "
                "SaveAt(ts=grid) for a shared observation grid, or "
                "Lockstep() for a shared step sequence")
        if controller is not None and not controller.adaptive:
            warnings.warn(
                "PerSample() with a fixed-step controller degenerates to "
                "Lockstep(): every sample takes the identical step "
                "sequence, so there is no per-row accept/reject to "
                "exploit. Use AdaptiveController(...) or Lockstep().",
                UserWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class Sharded(Batching):
    """Shard the batch over a ``torch.distributed`` device-mesh axis, one
    slice of the rows per rank along ``axis``, each applying ``inner``
    batching (:class:`Lockstep` or :class:`PerSample`) to its rows. Needs
    an active mesh (``with make_host_mesh():``, see
    :mod:`repro_torch.launch.mesh`) whose dimension names include
    ``axis``, and a batch size divisible by that dimension's size.
    ``z0`` and ``params`` are replicated; ``ys`` and
    ``stats.per_sample`` hold the whole batch on every rank, and the
    backward all-reduces the ``params`` and ``z0`` cotangents, so values
    and gradients are the unsharded ``inner`` solve's on every rank."""

    axis: str = "data"
    inner: Batching = dataclasses.field(default_factory=Lockstep)

    name = "sharded"

    def __post_init__(self):
        if isinstance(self.inner, Sharded):
            raise ValueError("Sharded(inner=Sharded(...)) does not nest; "
                             "pick Lockstep() or PerSample() for inner")

    def validate(self, controller, saveat) -> None:
        if saveat is not None and (saveat.steps or saveat.dense):
            mode = "steps=True" if saveat.steps else "dense=True"
            raise ValueError(
                f"SaveAt({mode}) under Sharded() batching is ragged "
                "across shards (each shard's controller accepts its own "
                "step count); use SaveAt(ts=grid) or an unsharded "
                "Lockstep() solve")
        self.inner.validate(controller, saveat)


def batch_size(z0: Pytree) -> int:
    """The leading-axis batch size of a batched state tree. Every leaf
    must carry the same batch axis in front."""
    sizes = {}
    for key, leaf in pytree.tree_leaves_with_keys(z0):
        key = key or "<root>"
        if leaf.dim() == 0:
            raise ValueError(
                f"batched solve: z0 leaf {key} is a scalar — every leaf "
                "must have the batch axis as its leading dimension (add "
                "one with z[:, None]... or drop batching=)")
        sizes[key] = leaf.shape[0]
    if not sizes:
        raise ValueError("batched solve needs a non-empty z0 pytree")
    if len(set(sizes.values())) != 1:
        detail = ", ".join(f"{k}: {v}" for k, v in sizes.items())
        raise ValueError(
            "batched solve: inconsistent leading (batch) axis across z0 "
            f"leaves — {detail}. All leaves must share the same batch "
            "size; non-batched per-sample constants belong in params.")
    return next(iter(sizes.values()))


_tm = pytree.tree_map


def per_sample(f: Callable) -> Callable:
    """``f(params, z, t)`` written for one sample, as a map over a batch:
    ``torch.func.vmap`` over the leading axis of every leaf of ``z`` and,
    when ``t`` is (B,), over ``t`` (each row its own time); ``params``
    and a 0-d ``t`` are shared. This is how ``jax.vmap`` calls ``f``
    under the JAX package's ``PerSample``."""
    def rows_f(params, z, t):
        t_dim = 0 if t.dim() else None
        return pytree.vmap(f, in_dims=(None, 0, t_dim))(params, z, t)

    return rows_f


def batch_first(traj: Pytree) -> Pytree:
    """(T, B, ...) -> the batch-first (B, T, ...) of every batched
    mode."""
    return _tm(lambda b: torch.movedim(b, 0, 1), traj)


def tree_vdot(a: Pytree, b: Pytree) -> torch.Tensor:
    """Scalar inner product over matching pytrees (the adjoint-state dot
    products the boundary cotangents are built from)."""
    pairs = zip(pytree.tree_leaves(a), pytree.tree_leaves(b))
    acc = None
    for x, y in pairs:
        d = torch.sum(x * y)
        acc = d if acc is None else acc + d
    return acc


def bounds_cotangents(f, params: Pytree, z_traj: Pytree, ts: torch.Tensor,
                      g_traj: Pytree, a_t0: Pytree) -> torch.Tensor:
    """The analytic observation-time cotangents of an ODE solve
    (``solve(..., diff_bounds=True)``; torchdiffeq/diffrax convention)::

        dL/dt_k = +<g_k, f(z_k, t_k)>          k = 1 .. T-1
        dL/dt_0 = -<a(t0), f(z0, t0)>

    where ``a(t0)`` is the swept adjoint at ``t0``: the method's total
    ``dL/dz0`` minus the ``traj[0] == z0`` identity-row cotangent ``g_0``.
    One ``f`` evaluation per observation row (a loop over the T-1 rows
    where the JAX package vmaps ``f``)."""
    rows = [-tree_vdot(a_t0, f(params, _tm(lambda b: b[0], z_traj), ts[0]))]
    for k in range(1, ts.shape[0]):
        z_k = _tm(lambda b: b[k], z_traj)
        rows.append(tree_vdot(_tm(lambda b: b[k], g_traj),
                              f(params, z_k, ts[k])))
    return torch.stack(rows).to(ts.dtype)


class _GridVJP(torch.autograd.Function):
    """One observation-grid integration with a hand-written backward.

    ``fwd(params, z0, ts) -> (traj, RunStats, residuals)`` runs under
    ``no_grad``; the tensors of ``residuals`` (a pytree) are what is saved
    for the backward pass, through ``save_for_backward`` (so saved-tensor
    hooks see them). ``bwd(residuals, g_traj) -> (g_params, g_z0, g_ts)``
    runs with grad mode off; ``g_ts`` may be None (no dL/dts). Params and
    z0 enter as flattened leaves; the outputs are the (T, ...) trajectory
    leaves followed by the three RunStats counters (non-differentiable).
    """

    @staticmethod
    def forward(ctx, fwd, bwd, ts, p_spec, z_spec, n_p: int, *leaves):
        params = pytree.tree_unflatten(list(leaves[:n_p]), p_spec)
        z0 = pytree.tree_unflatten(list(leaves[n_p:]), z_spec)
        traj, stats, residuals = fwd(params, z0, ts)
        z_leaves = pytree.tree_leaves(traj)
        r_leaves, r_spec = pytree.tree_flatten(residuals)
        ctx.bwd, ctx.specs = bwd, (z_spec, r_spec)
        ctx.ts_like = (ts.shape, ts.dtype, ts.device)
        ctx.save_for_backward(*r_leaves)
        ctx.mark_non_differentiable(*stats)
        return (*z_leaves, *stats)

    @staticmethod
    def backward(ctx, *grads):
        z_spec, r_spec = ctx.specs
        residuals = pytree.tree_unflatten(list(ctx.saved_tensors), r_spec)
        n_z = len(grads) - len(RunStats._fields)
        z_like = pytree.tree_leaves(residuals[0])
        g_traj = pytree.tree_unflatten(
            [torch.zeros_like(z) if g is None else g
             for g, z in zip(grads[:n_z], z_like)], z_spec)
        g_params, g_z0, g_ts = ctx.bwd(residuals, g_traj)
        if g_ts is None and ctx.needs_input_grad[2]:
            shape, dtype, device = ctx.ts_like
            g_ts = torch.zeros(shape, dtype=dtype, device=device)
        return (None, None, g_ts, None, None, None,
                *pytree.tree_leaves(g_params), *pytree.tree_leaves(g_z0))


def grid_vjp(fwd: Callable, bwd: Callable, params: Pytree, z0: Pytree,
             ts: torch.Tensor) -> Tuple[Pytree, RunStats]:
    """Run ``fwd`` / ``bwd`` (see :class:`_GridVJP`) as one autograd node
    over ``(params, z0, ts)``. ``residuals[0]`` must be the trajectory
    tree (its leaves give the shapes of absent cotangents). Returns
    ``(traj, RunStats)``."""
    p_leaves, p_spec = pytree.tree_flatten(params)
    z_leaves, z_spec = pytree.tree_flatten(z0)
    out = _GridVJP.apply(fwd, bwd, ts, p_spec, z_spec, len(p_leaves),
                         *p_leaves, *z_leaves)
    n_z = len(z_leaves)
    return (pytree.tree_unflatten(list(out[:n_z]), z_spec),
            RunStats(*out[n_z:]))


class GradientMethod:
    """Base of the gradient-estimation axis (paper Table 1 rows).

    Subclasses are frozen dataclasses implementing ``default_solver()``,
    ``validate(solver, controller)`` (reject incompatible axes with an
    actionable error before integrating), ``integrate(f, params, z0, ts,
    solver, controller, diff_bounds, rows)`` -> ``(traj, RunStats)`` with
    ``traj`` of leading axis T = len(ts), and ``residual_bytes(z0, n_obs,
    solver, controller)``. With ``diff_bounds=True`` the backward emits the
    analytic :func:`bounds_cotangents` for ``ts`` (zeros otherwise).
    ``rows`` = B > 0 integrates the B rows of ``z0`` independently (the
    :meth:`integrate_batched` driver).
    """

    name: str = "?"

    def default_solver(self):
        raise NotImplementedError

    def validate(self, solver, controller) -> None:
        if controller.adaptive and not solver.has_error_estimate:
            raise ValueError(
                f"solver {solver.name!r} has no embedded error estimate; "
                "use ConstantSteps(n) with it or pick an embedded pair")

    def integrate(self, f, params, z0: Pytree, ts: torch.Tensor, solver,
                  controller, diff_bounds: bool = False,
                  rows: int = 0) -> Tuple[Pytree, RunStats]:
        raise NotImplementedError

    def integrate_batched(self, f, params, z0: Pytree, ts: torch.Tensor,
                          solver, controller, diff_bounds: bool = False
                          ) -> Tuple[Pytree, RunStats]:
        """The PerSample driver: the explicit form of the JAX package's
        ``jax.vmap`` of :meth:`integrate` over the leading axis of ``z0``.
        Each row carries its own ``(t, h, done)`` and replay buffers,
        ``f`` is called per sample (:func:`per_sample`), and the backward
        replays each row's own step script. Returns ``(traj, RunStats)``
        with leading axis B (traj ``(B, T, ...)``, counters ``(B,)``).
        ``params`` and ``ts`` are shared by the rows, so their cotangents
        (``ts``'s with ``diff_bounds=True``) sum over the rows."""
        nb = batch_size(z0)
        traj, stats = self.integrate(f, params, z0, ts, solver, controller,
                                     diff_bounds, rows=nb)
        # a fixed-step run counts once for every row
        return batch_first(traj), RunStats(*(c.expand(nb) for c in stats))

    def residual_bytes(self, z0: Pytree, n_obs: int, solver,
                       controller) -> int:
        return 0


def state_nbytes(z0: Pytree) -> int:
    """Byte size of one state pytree."""
    return sum(int(l.numel()) * l.element_size()
               for l in pytree.tree_leaves(z0))
