"""Asynchronous Leapfrog (ALF) integrator primitives (Mutze 2013; MALI
paper Algo 2/3).

The ALF step psi_h maps the augmented state ``(z, v)`` — ``v`` tracks
``dz/dt`` — forward by ``h`` and is *explicitly invertible*, which is the
property MALI exploits to rebuild the forward trajectory in the backward
pass at O(1) memory in the number of steps.

All functions are pytree-generic in ``z``/``v`` (``repro_torch.tree_util``).
``eta`` is the damping coefficient of Appendix A.5 (``eta=1`` = plain
ALF); ``eta == 0.5`` makes the damped step non-invertible and is rejected.

Dynamics signature used across the package::

    f(params, z, t) -> dz/dt        # same pytree structure as z

``params`` is a dict of tensors, ``t`` a 0-d float32 tensor.

Under ``PerSample`` batching ``t`` and ``h`` are (B,) tensors, one step
per row of a state whose leaves carry the batch axis in front: ``h``
enters each leaf's algebra through :func:`~repro_torch.tree_util.rows_like`
and ``f`` is the per-sample map of the user's field.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.tree_util import rows_like

Pytree = Any
Dynamics = Callable[[Pytree, Pytree, torch.Tensor], Pytree]

_tm = pytree.tree_map


def tree_add(x, y):
    return _tm(torch.add, x, y)


def tree_sub(x, y):
    return _tm(torch.sub, x, y)


def tree_scale(a, x):
    return _tm(lambda xi: a * xi, x)


def tree_zeros_like(x):
    return _tm(torch.zeros_like, x)


def check_eta(eta: float) -> None:
    if not (0.0 < eta <= 1.0):
        raise ValueError(f"damping eta must be in (0, 1], got {eta}")
    if abs(eta - 0.5) < 1e-9:
        raise ValueError("eta == 0.5 makes the damped ALF step non-invertible")


# "cuda" is the port's name for the JAX package's "pallas" backend: the
# step's elementwise algebra runs as the fused kernels of kernels/alf_step.
BACKENDS = ("reference", "cuda")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown ALF backend {backend!r}; "
                         f"available: {BACKENDS}")


def _reference_step(f, params, z, v, t, h, eta):
    s1 = t + h / 2
    k1 = _tm(lambda zi, vi: zi + vi * (rows_like(h, zi) / 2), z, v)
    u1 = f(params, k1, s1)
    v_out = _tm(lambda vi, ui: vi + 2.0 * eta * (ui - vi), v, u1)
    z_out = _tm(lambda ki, vo: ki + vo * (rows_like(h, ki) / 2), k1, v_out)
    return z_out, v_out, u1


def _cuda_step(f, params, z, v, t, h, eta):
    from repro_torch.kernels.alf_step.ops import alf_midpoint, alf_update
    s1 = t + h / 2
    k1 = alf_midpoint(z, v, h)
    u1 = f(params, k1, s1)
    z_out, v_out = alf_update(k1, v, u1, h, eta=eta)
    return z_out, v_out, u1


def alf_step(
    f: Dynamics,
    params: Pytree,
    z: Pytree,
    v: Pytree,
    t: torch.Tensor,
    h: torch.Tensor,
    eta: float = 1.0,
    backend: str = "reference",
) -> Tuple[Pytree, Pytree]:
    """One (damped) ALF step: (z, v) at time t -> (z', v') at time t + h.

    Paper Algo 2 / Appendix Algo 2:
        s1    = t + h/2
        k1    = z + v * h/2
        u1    = f(k1, s1)
        v_out = v + 2*eta*(u1 - v)
        z_out = k1 + v_out * h/2

    ``backend='cuda'`` runs the elementwise algebra around the ``f``
    evaluation as two fused kernel launches; both ops carry reverse rules
    (themselves kernels), so autograd differentiates through the step.
    """
    step = _cuda_step if backend == "cuda" else _reference_step
    z_out, v_out, _ = step(f, params, z, v, t, h, eta)
    return z_out, v_out


def alf_inverse(
    f: Dynamics,
    params: Pytree,
    z_out: Pytree,
    v_out: Pytree,
    t_out: torch.Tensor,
    h: torch.Tensor,
    eta: float = 1.0,
    backend: str = "reference",
) -> Tuple[Pytree, Pytree]:
    """Exact inverse of :func:`alf_step` (paper Algo 3 / Appendix Algo 3).

    Rebuilds the step *input* (z, v) at time ``t_out - h`` from the step
    output; the midpoint ``k1`` is recovered algebraically, so ``f`` is
    re-evaluated at (numerically) the same point as in the forward step.

    ``backend='cuda'`` is two launches around ``f``: the midpoint kernel
    (``sign=-1``) for f's argument, then the one-pass ``alf_inverse``
    kernel for the whole (z_in, v_in) rebuild. Forward-only: it runs inside
    MALI's backward, which is never differentiated.
    """
    s1 = t_out - h / 2
    if backend == "cuda":
        from repro_torch.kernels.alf_step.ops import alf_inverse as inverse_op
        from repro_torch.kernels.alf_step.ops import alf_midpoint
        k1 = alf_midpoint(z_out, v_out, h, sign=-1.0)
        u1 = f(params, k1, s1)
        return inverse_op(z_out, v_out, u1, h, eta=eta)
    k1 = _tm(lambda zi, vi: zi - vi * (rows_like(h, zi) / 2), z_out, v_out)
    u1 = f(params, k1, s1)
    if eta == 1.0:
        v_in = _tm(lambda ui, vo: 2.0 * ui - vo, u1, v_out)
    else:
        inv = 1.0 / (1.0 - 2.0 * eta)
        v_in = _tm(lambda vo, ui: (vo - 2.0 * eta * ui) * inv, v_out, u1)
    z_in = _tm(lambda ki, vi: ki - vi * (rows_like(h, ki) / 2), k1, v_in)
    return z_in, v_in


def alf_step_with_error(
    f: Dynamics,
    params: Pytree,
    z: Pytree,
    v: Pytree,
    t: torch.Tensor,
    h: torch.Tensor,
    eta: float = 1.0,
    backend: str = "reference",
) -> Tuple[Pytree, Pytree, Pytree]:
    """ALF step + embedded local-error estimate ``h * (u1 - v)``: the
    difference between the midpoint update (``z + h*u1`` at eta=1) and the
    first-order Euler-with-v prediction ``z + h*v``."""
    step = _cuda_step if backend == "cuda" else _reference_step
    z_out, v_out, u1 = step(f, params, z, v, t, h, eta)
    err = _tm(lambda ui, vi: rows_like(h, ui) * (ui - vi), u1, v)
    return z_out, v_out, err


def init_velocity(f: Dynamics, params: Pytree, z0: Pytree,
                  t0: torch.Tensor) -> Pytree:
    """Paper Sec 3.1: initialize the augmented state with v0 = f(z0, t0)."""
    return f(params, z0, t0)
