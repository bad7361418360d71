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
segment once ``done`` — one host read per trial, after it — so the
recorded buffers, counters and results are the same. Plain autograd
differentiates through the loop (the Naive method); MALI runs it under
``no_grad``.

:func:`integrate_span` is the single-interval ``t0 -> t1`` variant:
Backsolve's forward segments and its reverse-time augmented solve.

Per-row control (``PerSample`` batching, ``rows=B``): the explicit form
of what ``jax.vmap`` makes of the JAX package's masked scan. ``t``,
``h``, ``done`` and the counters are (B,) tensors, the recorded
``(t_i, h_i)`` buffers (max_steps, B), and the trial gets the (B,) ``t``
and ``h`` and returns one error ratio per row; every row accepts or
rejects on its own, and a finished row rides along as a no-op, its state,
time and step frozen by ``torch.where`` and its trial count stopped. The
loop still reads the host once per trial, on ``done.all()``. Under
``ConstantSteps`` every row takes the same steps, so ``t`` and ``h`` stay
0-d (as under ``jax.vmap``, where they do not depend on the state).

A fixed-step run reads nothing on the host and uploads nothing from it:
Python-number bounds become device tensors by a fill, not a copy.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import rows_like

from .stepsize import AdaptiveController, ConstantSteps, StepController

_tm = pytree.tree_map

Pytree = Any
TrialFn = Callable[[Pytree, torch.Tensor, torch.Tensor],
                   Tuple[Pytree, torch.Tensor]]

TIME_DTYPE = torch.float32


def tree_where(pred: torch.Tensor, a: Pytree, b: Pytree) -> Pytree:
    """``a`` where ``pred`` holds, else ``b``; a (B,) ``pred`` selects
    rows of leaves with the batch axis in front."""
    return _tm(lambda x, y: torch.where(rows_like(pred, x), x, y), a, b)


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
    t0, t1 = (float(t.detach()) if isinstance(t, torch.Tensor) else float(t)
              for t in (t0, t1))
    if t0 == t1:
        raise ValueError(
            f"empty integration span: t0 == t1 == {t0}; pass t1 > t0 "
            "for a forward solve or t1 < t0 for a reverse-time solve")


def _time_scalar(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=TIME_DTYPE).reshape(())
    # A fill on the device: the same float32 value as an upload, without
    # the blocking host-to-device copy.
    return torch.full((), float(t), dtype=TIME_DTYPE, device=device)


def scalar_time_grid(t0, t1, device=None) -> torch.Tensor:
    """The length-1 observation grid [t0, t1] of the end-state path. A
    tensor bound stays differentiable (``solve(..., diff_bounds=True)``)."""
    return torch.stack([_time_scalar(t0, device), _time_scalar(t1, device)])


def grid_run(run: Callable[[torch.Tensor], Pytree], z0: Pytree, t0, t1,
             ts) -> Pytree:
    """The grid convention of the legacy ``odeint_*`` facades: with
    ``ts``, ``run(grid)``'s (T, ...) trajectory on that grid; without,
    z(t1) from ``run`` on the length-1 grid [t0, t1]. The grid lies on
    z0's device."""
    device = pytree.tree_leaves(z0)[0].device
    if ts is None:
        return tree_row(run(scalar_time_grid(t0, t1, device)), -1)
    return run(as_time_grid(ts, device))


def fixed_grid_times(t0: torch.Tensor, t1: torch.Tensor, n_steps: int):
    """(t_i, h) for a uniform grid (t_i = t0 + i*h, h signed)."""
    h = (t1 - t0) / n_steps
    ts = t0 + h * torch.arange(n_steps, dtype=TIME_DTYPE, device=t0.device)
    return ts, h


def segment_pairs(ts: torch.Tensor) -> torch.Tensor:
    """(T-1, 2) tensor of consecutive (ts[k], ts[k+1]) segment bounds."""
    return torch.stack([ts[:-1], ts[1:]], -1)


def prepend_row(state0: Pytree, tail: Pytree) -> Pytree:
    """Stack ``state0`` in front of a (T-1, ...) segment-end trajectory,
    giving the (T, ...) observation trajectory with ``traj[0] == state0``."""
    return _tm(lambda s0, tl: torch.cat([s0.unsqueeze(0), tl], 0), state0,
               tail)


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
                        hs: torch.Tensor, n_accepted: int,
                        extras: Optional[Pytree] = None,
                        row_counts: Optional[torch.Tensor] = None
                        ) -> Pytree:
    """Apply ``body(carry, t_i, h_i, live)`` for i = n_accepted-1 .. 0
    over the recorded buffers; with ``extras`` the body is called as
    ``body(carry, t_i, h_i, extras_i, live)`` with row i of every extras
    leaf (ACA's checkpointed states). The JAX scan visits all
    ``max_steps`` slots with identity pass-through past ``n_accepted``;
    this visits the live slots only, which gives the same carry.

    Per-row buffers (``PerSample``): ``row_counts`` (B,) holds each row's
    accepted count and ``n_accepted`` its largest; ``live`` is then the
    (B,) mask ``i < row_counts``, and the body passes a dead row's carry
    through unchanged and hands its f-VJP a zero cotangent. Otherwise
    ``live`` is None: every visited slot is live."""
    carry = carry0
    for i in range(n_accepted - 1, -1, -1):
        live = None if row_counts is None else i < row_counts
        if extras is None:
            carry = body(carry, ts[i], hs[i], live)
        else:
            carry = body(carry, ts[i], hs[i], tree_row(extras, i), live)
    return carry


def sweep_counts(controller: StepController, seg_acc: torch.Tensor):
    """The reverse sweep's plan over the T-1 segments: for each, the
    number of slots to visit and the per-row counts (None when every row
    has them all). ConstantSteps needs no host read; an adaptive run
    reads its accepted counts once per backward, and a per-row run
    sweeps each segment over its rows' largest count."""
    n_seg = seg_acc.shape[0]
    if isinstance(controller, ConstantSteps):
        return [(controller.n, None)] * n_seg
    counts = seg_acc.tolist()  # odelint: disable=R001 -- one read a backward
    if seg_acc.dim() == 1:
        return [(c, None) for c in counts]
    return [(max(c), seg_acc[k]) for k, c in enumerate(counts)]


def mask_rows(live: Optional[torch.Tensor], tree: Pytree) -> Pytree:
    """``tree`` with the rows where ``live`` is False set to zero (the
    cotangent a padding slot hands its f-VJP); ``tree`` itself when
    ``live`` is None."""
    if live is None:
        return tree
    return _tm(lambda x: torch.where(rows_like(live, x), x,
                                     torch.zeros_like(x)), tree)


def keep_rows(live: Optional[torch.Tensor], new: Pytree,
              old: Pytree) -> Pytree:
    """``new`` on the live rows, ``old`` on the dead ones (all of ``new``
    when ``live`` is None)."""
    return new if live is None else tree_where(live, new, old)


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


class SpanResult(NamedTuple):
    """Bookkeeping of one t0 -> t1 integration."""
    state: Pytree
    n_accepted: torch.Tensor    # int32
    n_trials: torch.Tensor      # int32


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
    controller: AdaptiveController,
    h0: Optional[torch.Tensor] = None,
    record_states: bool = False,
    record_buf: Optional[Pytree] = None,
) -> AdaptiveResult:
    """Bounded accept/reject loop over one span, direction-agnostic: ``h``
    and ``remaining`` carry the span's sign and every magnitude comparison
    goes through abs. ``record_states`` also returns the start state of
    every accepted step in a (max_steps, ...) buffer, zero past the
    accepted count — the JAX scan's buffer. Given a zero ``record_buf``
    (grad-free only) the loop writes that buffer in place, one row per
    accepted trial, as the scan does; otherwise it is built once after the
    loop from the trials' start states (autograd differentiates through
    it; one trajectory only).

    A (B,) ``h0`` runs the loop per row (``PerSample``): every buffer
    gains a trailing B axis, each row writes its own next slot, and the
    loop ends when every row is done. ``controller`` gives the initial
    proposal, the ``max_steps`` trial bound and the step-size policy; the
    trial's error ratio is its own."""
    dev = t0.device
    t0 = t0.to(TIME_DTYPE)
    t1 = t1.to(TIME_DTYPE)
    max_steps = controller.max_steps
    h = (controller.initial_step(t1 - t0) if h0 is None
         else h0.to(TIME_DTYPE))
    shape = h.shape                      # () or (B,)
    ts_buf = torch.zeros((max_steps,) + shape, dtype=TIME_DTYPE, device=dev)
    hs_buf = torch.zeros((max_steps,) + shape, dtype=TIME_DTYPE, device=dev)
    state, t = state0, (t0.expand(shape) if shape else t0)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(shape, dtype=torch.int32, device=dev)
    n_ev = torch.zeros(shape, dtype=torch.int32, device=dev)
    cols = torch.arange(shape[0], device=dev) if shape else None
    starts, accepts = [], []

    for _ in range(max_steps):
        remaining = t1 - t
        is_last = torch.abs(h) >= torch.abs(remaining)
        h_eff = torch.where(is_last, remaining, h)

        state_next, ratio = trial(state, t, h_eff)
        accept = (ratio <= 1.0) & ~done
        n_ev = n_ev + torch.where(done, 0, 1).to(torch.int32)
        # Each row's next free slot: (slot,) for one trajectory, (slot_b,
        # b) per row.
        idx = ((n_acc.long().view(1),) if cols is None
               else (n_acc.long(), cols))
        if record_buf is not None:
            _tm(lambda b, s: _write_slot(b, idx, accept, s), record_buf,
                state)
        elif record_states:
            starts.append(state)
            accepts.append(accept)

        # Record the accepted step's (start time, step size). Both stay
        # differentiable, as in the JAX scan: a dense interpolant built on
        # them depends on the step sizes, which depend on the state.
        ts_buf.index_put_(idx, torch.where(accept, t, ts_buf[idx]))
        hs_buf.index_put_(idx, torch.where(accept, h_eff, hs_buf[idx]))

        new_t = torch.where(accept, torch.where(is_last, t1, t + h_eff), t)
        state = tree_where(accept, state_next, state)
        h_next = controller.next_step(h_eff, ratio, order)
        h = torch.where(done, h, h_next)
        done = done | (accept & is_last)
        t = new_t
        n_acc = n_acc + accept.to(torch.int32)
        # the loop's one host read a trial
        if bool(done.all() if shape else done):  # odelint: disable=R001 -- one read a trial
            break

    traj = record_buf
    if traj is None and record_states:
        traj = _accepted_rows(starts, accepts, n_acc, max_steps)
    return AdaptiveResult(state, ts_buf, hs_buf, n_acc, n_ev, h,
                          done | (t0 == t1), traj)


def _write_slot(buf: torch.Tensor, idx, accept: torch.Tensor,
                x: torch.Tensor) -> None:
    """Write ``x`` into ``buf`` at ``idx`` where ``accept`` holds."""
    cur = buf[idx]
    buf.index_put_(idx, torch.where(rows_like(accept, cur),
                                    x.reshape(cur.shape), cur))


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


def _record_buffer(state0: Pytree, n_seg: int, bound: int,
                   record_states: bool) -> Optional[Pytree]:
    """Grad-free recording (ACA's forward): one zero (n_seg, bound, ...)
    buffer written in place, one state per step as the JAX scan writes
    its buffer, instead of states stacked into copies (two to three states
    per step at the peak).

    None under autograd (Naive with ``SaveAt(steps|dense)``), which then
    records through the stacked list. Both give the same values and
    gradients, but each in-place write into one buffer adds a
    ``CopySlices`` node whose backward copies the whole buffer's
    gradient, so a backward over N recorded steps copies O(N^2) states,
    where the stacked record's backward copies O(N)."""
    if not record_states or torch.is_grad_enabled():
        return None
    return _tm(lambda x: x.new_zeros((n_seg, bound) + x.shape), state0)


def _constant_grid(trial: TrialFn, state0: Pytree, ts: torch.Tensor,
                   n: int, record_states: bool) -> GridResult:
    """ConstantSteps path of :func:`integrate_grid`: a plain per-segment
    sub-grid (every trial accepted), with the same bookkeeping as the
    adaptive path so the backward sweep is controller-agnostic."""
    n_seg = ts.shape[0] - 1
    state = state0
    states = [state0]
    seg_ts, seg_hs, seg_starts = [], [], []
    record = _record_buffer(state0, n_seg, n, record_states)
    for k in range(n_seg):
        step_ts, h = fixed_grid_times(ts[k], ts[k + 1], n)
        starts = []
        for i in range(n):
            if record is not None:
                _tm(lambda b, s: b[k, i].copy_(s), record, state)
            elif record_states:
                starts.append(state)
            state, _ = trial(state, step_ts[i], h)
        states.append(state)
        seg_ts.append(step_ts.detach())
        seg_hs.append(h.detach().expand(n))
        if record is None and record_states:
            seg_starts.append(stack_states(starts))
    dev = ts.device
    return GridResult(
        state, stack_states(states), torch.stack(seg_ts),
        torch.stack(seg_hs),
        torch.full((n_seg,), n, dtype=torch.int32, device=dev),
        torch.full((), n_seg * n, dtype=torch.int32, device=dev),
        torch.ones((), dtype=torch.bool, device=dev),
        record if record is not None or not record_states
        else stack_states(seg_starts))


def _adaptive_grid(trial: TrialFn, state0: Pytree, ts: torch.Tensor,
                   controller: AdaptiveController, order: int,
                   record_states: bool, rows: int = 0) -> GridResult:
    """AdaptiveController path of :func:`integrate_grid`: per-segment
    bounded accept/reject loops, the step proposal warm-started across
    segment boundaries (each row's own under ``rows``)."""
    n_seg = ts.shape[0] - 1
    h_prev = controller.initial_step(ts[1] - ts[0])
    if rows:
        h_prev = h_prev.expand(rows)
    state = state0
    states = [state0]
    seg_ts, seg_hs, seg_acc, seg_done, seg_starts = [], [], [], [], []
    n_ev = torch.zeros((), dtype=torch.int32, device=ts.device)
    record = _record_buffer(state0, n_seg, controller.max_steps,
                            record_states)
    for k in range(n_seg):
        span = ts[k + 1] - ts[k]
        h0 = torch.sign(span) * torch.minimum(torch.abs(h_prev),
                                              torch.abs(span))
        out = integrate_adaptive(
            trial, state, ts[k], ts[k + 1], order=order,
            controller=controller, h0=h0, record_states=record_states,
            record_buf=None if record is None else tree_row(record, k))
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
                      torch.stack(seg_done).all(0),
                      record if record is not None or not record_states
                      else stack_states(seg_starts))


def integrate_grid(
    trial: TrialFn,
    state0: Pytree,
    ts: torch.Tensor,
    *,
    controller: StepController,
    order: int,
    record_states: bool = False,
    rows: int = 0,
) -> GridResult:
    """THE grid driver: integrate across an observation grid ``ts`` (shape
    (T,)) under the given :class:`StepController`. The recorded per-segment
    (t_i, h_i) bookkeeping keeps the backward residual set at
    O(T * step_bound) scalars + O(T * N_z) states. ``record_states`` adds
    the per-accepted-step start states (``GridResult.state_traj``), what
    the per-step and dense outputs are built from. ``rows`` = B > 0 runs
    an adaptive controller per row (``PerSample``): the step buffers are
    then (T-1, bound, B), the accepted counts (T-1, B) and the trial
    count (B,)."""
    if isinstance(controller, ConstantSteps):
        return _constant_grid(trial, state0, ts, controller.n, record_states)
    if isinstance(controller, AdaptiveController):
        return _adaptive_grid(trial, state0, ts, controller, order,
                              record_states, rows)
    raise TypeError(f"unknown step controller {controller!r}")


# --- legacy driver names (pre-object API), kept as thin wrappers -----------

def integrate_fixed_grid(step: Callable[[Pytree, torch.Tensor, torch.Tensor],
                                        Pytree],
                         state0: Pytree, ts: torch.Tensor,
                         n_steps: int) -> Tuple[Pytree, Pytree]:
    """Deprecated: use :func:`integrate_grid` with ``ConstantSteps``.
    ``step(state, t, h)`` is one step; returns (the end state, the states
    at ``ts`` stacked)."""
    res = integrate_grid(lambda s, t, h: (step(s, t, h), None), state0, ts,
                         controller=ConstantSteps(n_steps), order=1)
    return res.state, res.traj


def integrate_adaptive_grid(trial: TrialFn, state0: Pytree,
                            ts: torch.Tensor, *, order: int, rtol: float,
                            atol: float, max_steps: int,
                            record_states: bool = False) -> GridResult:
    """Deprecated: use :func:`integrate_grid` with ``AdaptiveController``."""
    ctrl = AdaptiveController(rtol=rtol, atol=atol, max_steps=max_steps)
    return integrate_grid(trial, state0, ts, controller=ctrl, order=order,
                          record_states=record_states)


def integrate_span(
    trial: TrialFn,
    state0: Pytree,
    t0: torch.Tensor,
    t1: torch.Tensor,
    *,
    controller: StepController,
    order: int,
    rows: int = 0,
) -> SpanResult:
    """Single-interval ``t0 -> t1`` driver (Backsolve's forward segments
    and reverse-time augmented solve), sign-agnostic like the grid
    driver; the adaptive branch starts from the controller's initial
    proposal for the span, per row under ``rows`` = B > 0."""
    t0, t1 = t0.to(TIME_DTYPE), t1.to(TIME_DTYPE)
    if isinstance(controller, ConstantSteps):
        ts, h = fixed_grid_times(t0, t1, controller.n)
        state = state0
        for i in range(controller.n):
            state, _ = trial(state, ts[i], h)
        n = torch.full((), controller.n, dtype=torch.int32, device=t0.device)
        return SpanResult(state, n, n)
    if isinstance(controller, AdaptiveController):
        h0 = (controller.initial_step(t1 - t0).expand(rows) if rows
              else None)
        out = integrate_adaptive(trial, state0, t0, t1, order=order,
                                 controller=controller, h0=h0)
        return SpanResult(out.state, out.n_accepted, out.n_evals)
    raise TypeError(f"unknown step controller {controller!r}")
