"""Dense output: per-step cubic-Hermite interpolation.

``solve(..., saveat=SaveAt(dense=True))`` records, for every accepted
solver step, enough endpoint data to fit a cubic Hermite polynomial over
that step; :class:`DenseInterpolation` holds the fitted coefficients and
evaluates them at arbitrary query times — ``Solution.evaluate(t)``
delegates here. Where the endpoint data comes from is the solver's
business (:meth:`repro_torch.core.solvers.Solver.interpolant`): ALF reads
the slope off the tracked velocity ``v`` at no extra ``f`` evaluation.

:func:`locate_event` finds a terminating event's crossing on the same
interpolant.

Direction: the step search runs in ``sign(t_end - t_start)``-reflected
coordinates, so a reverse-time solve (negative step sizes) interpolates
like a forward one. Everything is plain tensor code, so autograd
differentiates an interpolated value back through the recorded states.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import vmap

_tm = pytree.tree_map

Pytree = Any


def _rows_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (rows,) tensor to broadcast over ``like``'s trailing
    axes."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def hermite_coefficients(y0: Pytree, d0: Pytree, y1: Pytree, d1: Pytree,
                         hs: torch.Tensor) -> Tuple[Pytree, ...]:
    """Fit the cubic Hermite polynomial per recorded step.

    Inputs carry a leading step axis. On the normalized coordinate
    ``s = (t - t_i) / h_i`` in [0, 1] the cubic through ``(y0, d0)`` and
    ``(y1, d1)`` is ``c0 + s*(c1 + s*(c2 + s*c3))`` with::

        c0 = y0
        c1 = h * d0
        c2 = 3*(y1 - y0) - h*(2*d0 + d1)
        c3 = -2*(y1 - y0) + h*(d0 + d1)

    ``h`` is the signed step size: the signs cancel between ``h*d`` and
    the normalization, so one formula serves both directions. Returns the
    ``(c0, c1, c2, c3)`` trees.
    """
    def per_leaf(a0, b0, a1, b1):
        h = _rows_like(hs, a0).to(a0.dtype)
        dy = a1 - a0
        return (a0, h * b0, 3.0 * dy - h * (2.0 * b0 + b1),
                -2.0 * dy + h * (b0 + b1))

    leaves0, spec = pytree.tree_flatten(y0)
    fitted = [per_leaf(*xs) for xs in zip(leaves0, pytree.tree_leaves(d0),
                                           pytree.tree_leaves(y1),
                                           pytree.tree_leaves(d1))]
    return tuple(pytree.tree_unflatten([f[i] for f in fitted], spec)
                 for i in range(4))


class DenseInterpolation(NamedTuple):
    """Piecewise-cubic dense output over one integration span.

    ``t0s``/``hs`` are the recorded accepted-step start times and signed
    step sizes (rows ``>= num_steps`` are padding); ``c0..c3`` hold the
    per-step Hermite coefficients with the same leading axis. Queries are
    clamped into ``[t_start, t_end]`` (either order), so the interpolant
    never extrapolates.
    """
    t0s: torch.Tensor          # (bound,) accepted step start times
    hs: torch.Tensor           # (bound,) signed accepted step sizes
    c0: Pytree                 # (bound, ...) Hermite coefficients
    c1: Pytree
    c2: Pytree
    c3: Pytree
    num_steps: torch.Tensor    # int32: live rows
    t_start: torch.Tensor      # span start (the solve's t0)
    t_end: torch.Tensor        # span end (the solve's t1)

    @property
    def direction(self) -> torch.Tensor:
        """+1 for a forward-time span, -1 for reverse time."""
        return torch.where(self.t_end >= self.t_start, 1.0, -1.0).to(
            self.t0s.dtype)

    def evaluate(self, t) -> Pytree:
        """The state at query time(s) ``t``: a scalar gives one state
        tree, a (Q,) tensor states with a leading Q axis."""
        t = torch.as_tensor(t, dtype=self.t0s.dtype, device=self.t0s.device)
        scalar = t.dim() == 0
        tq = torch.atleast_1d(t)
        lo = torch.minimum(self.t_start, self.t_end)
        hi = torch.maximum(self.t_start, self.t_end)
        tq = torch.clamp(tq, lo, hi)

        # Find the covering step in direction-reflected (ascending)
        # coordinates; padding rows sort to +inf and are never hit.
        sgn = self.direction
        bound = self.t0s.shape[0]
        n = self.num_steps.long()
        live = torch.arange(bound, device=self.t0s.device) < n
        keys = torch.where(live, self.t0s * sgn,
                           torch.full_like(self.t0s, float("inf")))
        j = torch.searchsorted(keys, (tq * sgn).contiguous(), right=True) - 1
        j = torch.minimum(torch.clamp_min(j, 0), torch.clamp_min(n - 1, 0))

        h = self.hs[j]
        s = (tq - self.t0s[j]) / torch.where(h == 0, torch.ones_like(h), h)

        def horner(a0, a1, a2, a3):
            sb = _rows_like(s, a0[j]).to(a0.dtype)
            return a0[j] + sb * (a1[j] + sb * (a2[j] + sb * a3[j]))

        out = _tm(horner, self.c0, self.c1, self.c2, self.c3)
        return _tm(lambda b: b[0], out) if scalar else out

    def __call__(self, t) -> Pytree:
        return self.evaluate(t)


def build_interpolation(solver, f, params, states: Pytree, state_end: Pytree,
                        ts: torch.Tensor, hs: torch.Tensor,
                        n_live: torch.Tensor, t_start,
                        t_end) -> DenseInterpolation:
    """Fit the per-step Hermite record of one ``record_states=True`` run:
    ``states`` is the (bound, ...) buffer of accepted-step start solver
    states, ``state_end`` the final solver state; the solver supplies the
    endpoint values and slopes (:meth:`Solver.interpolant`)."""
    y0, d0, y1, d1 = solver.interpolant(f, params, states, state_end, ts, hs,
                                        n_live)
    c0, c1, c2, c3 = hermite_coefficients(y0, d0, y1, d1, hs)
    return DenseInterpolation(
        t0s=ts, hs=hs, c0=c0, c1=c1, c2=c2, c3=c3,
        num_steps=torch.as_tensor(n_live, dtype=torch.int32),
        t_start=torch.as_tensor(t_start, dtype=ts.dtype, device=ts.device),
        t_end=torch.as_tensor(t_end, dtype=ts.dtype, device=ts.device))


def shift_to_step_ends(states: Pytree, state_end: Pytree,
                       n_live: torch.Tensor) -> Pytree:
    """Per-step end states from the start-state buffer: row i is the start
    of step i+1, with the final state at the last live row (rows past
    ``n_live`` are padding)."""
    last = torch.clamp_min(n_live - 1, 0).long().reshape(1)

    def per_leaf(b, e):
        rolled = torch.cat([b[1:], b[:1]], 0)
        return rolled.index_put((last,), e.unsqueeze(0))

    return _tm(per_leaf, states, state_end)


def pad_dead_rows(buf: Pytree, fill: Pytree, n_live: torch.Tensor) -> Pytree:
    """Replace the padding rows (index >= n_live) with ``fill``, so that
    ``f`` and event functions never see the zero padding."""
    def per_leaf(b, e):
        live = torch.arange(b.shape[0], device=b.device) < n_live
        return torch.where(_rows_like(live, b), b, e.unsqueeze(0))

    return _tm(per_leaf, buf, fill)


# ---------------------------------------------------------------------------
# Event location
# ---------------------------------------------------------------------------

def locate_event(interp: DenseInterpolation, cond_fn: Callable,
                 direction: int, max_bisections: int,
                 t_fallback) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find the first root of ``cond_fn(z(t), t)`` along the interpolant.

    ``cond_fn`` is evaluated once at every recorded step node (batched)
    and once at the span end; the first live sign change, filtered by
    ``direction`` (+1 rising only, -1 falling only, 0 either), is picked
    on the device, then ``max_bisections`` bisection iterations on the
    dense interpolant refine it inside its step: polynomial arithmetic, no
    dynamics evaluation and no host read. Returns ``(t_event, fired)`` as
    device tensors; without a crossing ``t_event == t_fallback`` and
    ``fired`` is False. Nothing here is differentiated: the caller freezes
    ``t_event``.
    """
    bound = interp.t0s.shape[0]
    live = torch.arange(bound, device=interp.t0s.device) < interp.num_steps
    node_t0 = interp.t0s
    node_t1 = interp.t0s + interp.hs

    def cond(z, t):
        return torch.as_tensor(cond_fn(z, t))

    def cond_at(tq):
        return cond(interp.evaluate(tq), tq)

    g0 = vmap(cond)(interp.evaluate(node_t0), node_t0)
    # Step i's end node is step i+1's start node (the interpolant is C0
    # there), so g0 shifted by one gives every step's end value but the
    # last live step's: the span end, evaluated once.
    g_end = cond_at(interp.t_end)
    last = torch.clamp_min(interp.num_steps.long() - 1, 0).reshape(1)
    g1 = torch.cat([g0[1:], g0[:1]]).index_put((last,), g_end.reshape(1))

    rising = (g0 < 0) & (g1 >= 0)
    falling = (g0 > 0) & (g1 <= 0)
    if direction > 0:
        crossed = rising
    elif direction < 0:
        crossed = falling
    else:
        crossed = rising | falling
    crossed = crossed & live

    fired = torch.any(crossed)
    # the first live crossing, as a (1,) index: a 0-d index tensor would
    # be read on the host
    j = torch.argmax(crossed.to(torch.int8)).reshape(1)

    t_lo, t_hi, g_lo = (b[j].reshape(()) for b in (node_t0, node_t1, g0))
    for _ in range(max_bisections):
        mid = 0.5 * (t_lo + t_hi)
        g_mid = cond_at(mid)
        same = torch.sign(g_mid) == torch.sign(g_lo)
        t_lo, t_hi, g_lo = (torch.where(same, mid, t_lo),
                            torch.where(same, t_hi, mid),
                            torch.where(same, g_mid, g_lo))
    t_event = 0.5 * (t_lo + t_hi)
    t_event = torch.where(fired, t_event,
                          torch.as_tensor(t_fallback, dtype=t_event.dtype,
                                          device=t_event.device))
    return t_event, fired
