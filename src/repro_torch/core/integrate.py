"""One controller-parameterized integration driver (paper Algo 1).

:func:`integrate_grid` integrates across an observation grid ``ts`` of T
timepoints, carrying the integrator state (and, for adaptive control, the
warm-started step proposal) across segment boundaries. It records the
``(t_i, h_i)`` of every accepted step of every segment — the replay script
MALI's backward sweep walks — plus accepted/trial counters that surface as
``Solution.stats``.

The trial signature is uniform across solvers and controllers::

    trial(state, t, h) -> (state_next, err_ratio)   # err_ratio <= 1 accepts

The adaptive loop keeps the masked ``(state, t, h, done)`` carry of the JAX
package's bounded scan: every update is a ``torch.where`` on the accept
predicate and the ``(t_i, h_i)`` buffers take index writes at the accepted
count, all on the device. Where the JAX scan runs all ``max_steps`` trials
and its iterations after ``done`` are the identity, this loop stops a
segment once ``done`` — one host read per trial — so the recorded buffers,
counters and results are the same. Plain autograd differentiates through
the loop (the Naive method); MALI runs it under ``no_grad``.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .stepsize import (AdaptiveController, ConstantSteps, StepController,
                       initial_step_size, next_step_size)

_tm = pytree.tree_map

Pytree = Any
TrialFn = Callable[[Pytree, torch.Tensor, torch.Tensor],
                   Tuple[Pytree, torch.Tensor]]

TIME_DTYPE = torch.float32


def tree_where(pred: torch.Tensor, a: Pytree, b: Pytree) -> Pytree:
    return _tm(lambda x, y: torch.where(pred, x, y), a, b)


def tree_row(traj: Pytree, k: int) -> Pytree:
    """Row ``k`` of a stacked (T, ...) trajectory."""
    return _tm(lambda b: b[k], traj)


def stack_states(states: List[Pytree]) -> Pytree:
    """[state_0, ..., state_{T-1}] -> one tree of (T, ...) leaves."""
    return _tm(lambda *xs: torch.stack(xs), *states)


def as_time_grid(ts, device=None) -> torch.Tensor:
    """Validate/convert an observation grid to a float32 tensor: 1-D, at
    least two timepoints, strictly monotonic in either direction (an
    increasing grid is a forward solve, a decreasing one a reverse-time
    solve)."""
    grid = torch.as_tensor(ts, dtype=TIME_DTYPE, device=device)
    if grid.dim() != 1 or grid.shape[0] < 2:
        raise ValueError("ts must be a 1-D grid of at least 2 timepoints "
                         f"(got shape {tuple(grid.shape)})")
    host = grid.detach().cpu().numpy()
    diffs = np.diff(host)
    if not (np.all(diffs > 0) or np.all(diffs < 0)):
        raise ValueError(
            "ts must be strictly monotonic (all increasing or all "
            f"decreasing); got ts={host.tolist()}")
    return grid


def validate_span(t0, t1) -> None:
    """Reject an empty span (``t1 < t0`` is legal: reverse time)."""
    if float(t0) == float(t1):
        raise ValueError(
            f"empty integration span: t0 == t1 == {float(t0)}; pass t1 > t0 "
            "for a forward solve or t1 < t0 for a reverse-time solve")


def scalar_time_grid(t0, t1, device=None) -> torch.Tensor:
    """The length-1 observation grid [t0, t1] of the end-state path."""
    return torch.stack([torch.as_tensor(t0, dtype=TIME_DTYPE, device=device),
                        torch.as_tensor(t1, dtype=TIME_DTYPE, device=device)])


def fixed_grid_times(t0: torch.Tensor, t1: torch.Tensor, n_steps: int):
    """(t_i, h) for a uniform grid (t_i = t0 + i*h, h signed)."""
    h = (t1 - t0) / n_steps
    ts = t0 + h * torch.arange(n_steps, dtype=TIME_DTYPE, device=t0.device)
    return ts, h


def reverse_segment_sweep(seg_fn: Callable, carry0: Tuple, g: Pytree,
                          n_seg: int) -> Tuple:
    """Shared backward scaffold of the observation-grid gradients.

    Runs ``seg_fn(carry, g_k1, k) -> carry`` over segments
    k = n_seg-1 .. 0, feeding each its end-observation cotangent
    ``g[k+1]``, then adds the ``traj[0] = z0`` identity-row cotangent
    ``g[0]`` into ``carry[0]`` (the state adjoint a_z)."""
    carry = carry0
    for k in range(n_seg - 1, -1, -1):
        carry = seg_fn(carry, tree_row(g, k + 1), k)
    a_z = _tm(torch.add, carry[0], tree_row(g, 0))
    return (a_z,) + tuple(carry[1:])


def reverse_masked_scan(body: Callable, carry0: Pytree, ts: torch.Tensor,
                        hs: torch.Tensor, n_accepted: int) -> Pytree:
    """Apply ``body(carry, t_i, h_i)`` for i = n_accepted-1 .. 0 over the
    recorded buffers. The JAX scan visits all ``max_steps`` slots with
    identity pass-through past ``n_accepted``; this visits the live slots
    only, which gives the same carry."""
    carry = carry0
    for i in range(n_accepted - 1, -1, -1):
        carry = body(carry, ts[i], hs[i])
    return carry


class GridResult(NamedTuple):
    """Bookkeeping of one observation-grid integration."""
    state: Pytree               # final state at ts[-1]
    traj: Pytree                # (T, ...) state at each ts[k]; traj[0]=state0
    ts: torch.Tensor            # (T-1, bound) accepted step start times
    hs: torch.Tensor            # (T-1, bound) accepted step sizes
    n_accepted: torch.Tensor    # (T-1,) int32 accepted steps per segment
    n_trials: torch.Tensor      # int32 total trials (= accepted + rejected)
    completed: torch.Tensor     # bool: every segment reached its end time
    # (T-1, bound, ...) accepted-step start states, zero past each
    # segment's accepted count (record_states=True only).
    state_traj: Optional[Pytree] = None


class AdaptiveResult(NamedTuple):
    state: Pytree               # final state at t1
    ts: torch.Tensor            # (max_steps,) accepted step start times
    hs: torch.Tensor            # (max_steps,) accepted step sizes
    n_accepted: torch.Tensor    # int32
    n_evals: torch.Tensor       # int32 trial count
    h_final: torch.Tensor       # controller's step proposal at exit
    done: torch.Tensor          # bool: reached t1 within budget
    state_traj: Optional[Pytree] = None  # (max_steps, ...) start states


def integrate_adaptive(
    trial: TrialFn,
    state0: Pytree,
    t0: torch.Tensor,
    t1: torch.Tensor,
    *,
    order: int,
    rtol: float,
    atol: float,
    max_steps: int,
    h0: Optional[torch.Tensor] = None,
    record_states: bool = False,
) -> AdaptiveResult:
    """Bounded accept/reject loop over one span, direction-agnostic: ``h``
    and ``remaining`` carry the span's sign and every magnitude comparison
    goes through abs. ``record_states`` also returns the start state of
    every accepted step in a (max_steps, ...) buffer, zero past the
    accepted count — the JAX scan's buffer, built here once after the loop
    from the trials' start states (autograd differentiates through it)."""
    dev = t0.device
    t0 = t0.to(TIME_DTYPE)
    t1 = t1.to(TIME_DTYPE)
    h = (initial_step_size(rtol, atol, t1 - t0) if h0 is None
         else h0.to(TIME_DTYPE))
    ts_buf = torch.zeros((max_steps,), dtype=TIME_DTYPE, device=dev)
    hs_buf = torch.zeros((max_steps,), dtype=TIME_DTYPE, device=dev)
    state, t = state0, t0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    n_ev = torch.zeros((), dtype=torch.int32, device=dev)
    starts, accepts = [], []

    for _ in range(max_steps):
        if bool(done):
            break
        remaining = t1 - t
        is_last = torch.abs(h) >= torch.abs(remaining)
        h_eff = torch.where(is_last, remaining, h)

        state_next, ratio = trial(state, t, h_eff)
        accept = (ratio <= 1.0) & ~done
        n_ev = n_ev + torch.where(done, 0, 1).to(torch.int32)
        if record_states:
            starts.append(state)
            accepts.append(accept)

        # Record the accepted step's (start time, step size). Both stay
        # differentiable, as in the JAX scan: a dense interpolant built on
        # them depends on the step sizes, which depend on the state.
        idx = (n_acc.long().view(1),)
        ts_buf.index_put_(idx, torch.where(accept, t, ts_buf[idx]))
        hs_buf.index_put_(idx, torch.where(accept, h_eff, hs_buf[idx]))

        new_t = torch.where(accept, torch.where(is_last, t1, t + h_eff), t)
        state = tree_where(accept, state_next, state)
        h_next = next_step_size(h_eff, ratio, order)
        h = torch.where(done, h, h_next)
        done = done | (accept & is_last)
        t = new_t
        n_acc = n_acc + accept.to(torch.int32)

    traj = (_accepted_rows(starts, accepts, n_acc, max_steps)
            if record_states else None)
    return AdaptiveResult(state, ts_buf, hs_buf, n_acc, n_ev, h,
                          done | (t0 == t1), traj)


def _accepted_rows(starts: List[Pytree], accepts: List[torch.Tensor],
                   n_acc: torch.Tensor, bound: int) -> Pytree:
    """The (bound, ...) buffer of accepted trials' start states, in order,
    zero past ``n_acc``: a stable sort puts the accepted trials first, on
    the device."""
    order = torch.argsort((~torch.stack(accepts)).to(torch.int8),
                          stable=True)
    live = torch.arange(len(starts), device=n_acc.device) < n_acc

    def per_leaf(*rows):
        picked = torch.stack(rows)[order]
        mask = live.reshape((-1,) + (1,) * (picked.dim() - 1))
        picked = torch.where(mask, picked, torch.zeros_like(picked))
        pad = picked.new_zeros((bound - len(rows),) + picked.shape[1:])
        return torch.cat([picked, pad])

    return _tm(per_leaf, *starts)


def _constant_grid(trial: TrialFn, state0: Pytree, ts: torch.Tensor,
                   n: int, record_states: bool) -> GridResult:
    """ConstantSteps path of :func:`integrate_grid`: a plain per-segment
    sub-grid (every trial accepted), with the same bookkeeping as the
    adaptive path so the backward sweep is controller-agnostic."""
    n_seg = ts.shape[0] - 1
    state = state0
    states = [state0]
    seg_ts, seg_hs, seg_starts = [], [], []
    for k in range(n_seg):
        step_ts, h = fixed_grid_times(ts[k], ts[k + 1], n)
        starts = []
        for i in range(n):
            if record_states:
                starts.append(state)
            state, _ = trial(state, step_ts[i], h)
        states.append(state)
        seg_ts.append(step_ts.detach())
        seg_hs.append(h.detach().expand(n))
        if record_states:
            seg_starts.append(stack_states(starts))
    dev = ts.device
    return GridResult(
        state, stack_states(states), torch.stack(seg_ts),
        torch.stack(seg_hs),
        torch.full((n_seg,), n, dtype=torch.int32, device=dev),
        torch.tensor(n_seg * n, dtype=torch.int32, device=dev),
        torch.ones((), dtype=torch.bool, device=dev),
        stack_states(seg_starts) if record_states else None)


def _adaptive_grid(trial: TrialFn, state0: Pytree, ts: torch.Tensor,
                   controller: AdaptiveController, order: int,
                   record_states: bool) -> GridResult:
    """AdaptiveController path of :func:`integrate_grid`: per-segment
    bounded accept/reject loops, the step proposal warm-started across
    segment boundaries."""
    n_seg = ts.shape[0] - 1
    h_prev = controller.initial_step(ts[1] - ts[0])
    state = state0
    states = [state0]
    seg_ts, seg_hs, seg_acc, seg_done, seg_starts = [], [], [], [], []
    n_ev = torch.zeros((), dtype=torch.int32, device=ts.device)
    for k in range(n_seg):
        span = ts[k + 1] - ts[k]
        h0 = torch.sign(span) * torch.minimum(torch.abs(h_prev),
                                              torch.abs(span))
        out = integrate_adaptive(trial, state, ts[k], ts[k + 1], order=order,
                                 rtol=controller.rtol, atol=controller.atol,
                                 max_steps=controller.max_steps, h0=h0,
                                 record_states=record_states)
        state, h_prev = out.state, out.h_final
        states.append(state)
        seg_ts.append(out.ts)
        seg_hs.append(out.hs)
        seg_acc.append(out.n_accepted)
        seg_done.append(out.done)
        seg_starts.append(out.state_traj)
        n_ev = n_ev + out.n_evals
    return GridResult(state, stack_states(states), torch.stack(seg_ts),
                      torch.stack(seg_hs), torch.stack(seg_acc), n_ev,
                      torch.stack(seg_done).all(),
                      stack_states(seg_starts) if record_states else None)


def integrate_grid(
    trial: TrialFn,
    state0: Pytree,
    ts: torch.Tensor,
    *,
    controller: StepController,
    order: int,
    record_states: bool = False,
) -> GridResult:
    """THE grid driver: integrate across an observation grid ``ts`` (shape
    (T,)) under the given :class:`StepController`. The recorded per-segment
    (t_i, h_i) bookkeeping keeps the backward residual set at
    O(T * step_bound) scalars + O(T * N_z) states. ``record_states`` adds
    the per-accepted-step start states (``GridResult.state_traj``), what
    the per-step and dense outputs are built from."""
    if isinstance(controller, ConstantSteps):
        return _constant_grid(trial, state0, ts, controller.n, record_states)
    if isinstance(controller, AdaptiveController):
        return _adaptive_grid(trial, state0, ts, controller, order,
                              record_states)
    raise TypeError(f"unknown step controller {controller!r}")
