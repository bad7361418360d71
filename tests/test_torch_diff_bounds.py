"""Differentiable integration bounds (``solve(..., diff_bounds=True)``) in
the port, against the JAX package's on the CPU.

Mirrors tests/test_diff_bounds.py: for all four gradient methods, under
both controllers and in both time directions, ``dL/dt1 = <g_T, f(z_T,
t1)>`` and ``dL/dt0 = -<a(t0), f(z0, t0)>`` hold to 1e-6 (self-
consistency) and equal the JAX package's values within 1e-5 relative;
every interior observation time gets ``<g_k, f(z_k, t_k)>``; central
differences pin the convention; without the flag the bound cotangents are
zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

torch.set_num_threads(1)

METHODS = {
    "mali": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF())),
    "mali_cuda": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF(backend="cuda"))),
    "naive": ((J.Naive(), J.ALF()), (T.Naive(), T.ALF())),
    "aca": ((J.ACA(), J.HeunEuler()), (T.ACA(), T.HeunEuler())),
    "adjoint": ((J.Backsolve(), J.Dopri5()), (T.Backsolve(), T.Dopri5())),
    "adjoint_alf_cuda": ((J.Backsolve(), J.ALF()),
                         (T.Backsolve(), T.ALF(backend="cuda"))),
}
CONTROLLERS = {
    "fixed": (J.ConstantSteps(16), T.ConstantSteps(16)),
    "adaptive": (J.AdaptiveController(), T.AdaptiveController()),
}
SPANS = {"forward": (0.0, 1.0), "reverse": (1.0, 0.2)}

Z0 = np.array([1.0, -0.5, 0.3], np.float32)


def _fj(params, z, t):
    # non-autonomous: a sign error in either boundary term cannot cancel
    return params["a"] * z * jnp.cos(t)


def _ft(params, z, t):
    return params["a"] * z * torch.cos(t)


def _tp():
    return {"a": torch.tensor(0.8)}


def _port_bounds(gradient, solver, controller, t0, t1, diff_bounds=True):
    a, b = (torch.tensor(t0, requires_grad=True),
            torch.tensor(t1, requires_grad=True))
    s = T.solve(_ft, _tp(), torch.tensor(Z0), a, b, solver=solver,
                controller=controller, gradient=gradient,
                diff_bounds=diff_bounds)
    g0, g1 = torch.autograd.grad(torch.sum(s.ys ** 2), [a, b])
    return float(g0), float(g1), s.ys.detach()


def _jax_bounds(gradient, solver, controller, t0, t1):
    def loss(a, b):
        return jnp.sum(J.solve(_fj, {"a": jnp.asarray(0.8)}, jnp.asarray(Z0),
                               a, b, solver=solver, controller=controller,
                               gradient=gradient, diff_bounds=True).ys ** 2)

    g0, g1 = jax.grad(loss, argnums=(0, 1))(t0, t1)
    return float(g0), float(g1)


@pytest.mark.parametrize("direction", sorted(SPANS))
@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_bound_gradients_match_analytic_and_jax(method, ctrl, direction):
    (gj, sj), (gt, st) = METHODS[method]
    cj, ct = CONTROLLERS[ctrl]
    t0, t1 = SPANS[direction]
    g_t0, g_t1, z_end = _port_bounds(gt, st, ct, t0, t1)

    # end-state loss: the swept adjoint at t0 is the total dL/dz0
    z0 = torch.tensor(Z0, requires_grad=True)
    s = T.solve(_ft, _tp(), z0, t0, t1, solver=st, controller=ct,
                gradient=gt)
    (g_z0,) = torch.autograd.grad(torch.sum(s.ys ** 2), [z0])
    want_t1 = float(torch.sum(2.0 * z_end * _ft(_tp(), z_end,
                                                 torch.tensor(t1))))
    want_t0 = -float(torch.sum(g_z0 * _ft(_tp(), torch.tensor(Z0),
                                          torch.tensor(t0))))
    np.testing.assert_allclose(g_t1, want_t1, rtol=1e-6)
    np.testing.assert_allclose(g_t0, want_t0, rtol=1e-6)

    j_t0, j_t1 = _jax_bounds(gj, sj, cj, t0, t1)
    np.testing.assert_allclose(g_t1, j_t1, rtol=1e-5)
    np.testing.assert_allclose(g_t0, j_t0, rtol=1e-5)


@pytest.mark.parametrize("method", ["mali", "naive", "aca", "adjoint"])
def test_bound_gradients_fd_parity(method):
    """Central differences over a fine fixed grid (agreement up to
    truncation error, hence 1e-2, as in the JAX package's test)."""
    _, (gradient, solver) = METHODS[method]
    ctrl = T.ConstantSteps(64)
    g_t0, g_t1, _ = _port_bounds(gradient, solver, ctrl, 0.0, 1.0)

    def loss(t0, t1):
        s = T.solve(_ft, _tp(), torch.tensor(Z0), t0, t1, solver=solver,
                    controller=ctrl, gradient=gradient)
        return float(torch.sum(s.ys.detach() ** 2))

    eps = 1e-3
    fd_t1 = (loss(0.0, 1.0 + eps) - loss(0.0, 1.0 - eps)) / (2 * eps)
    fd_t0 = (loss(eps, 1.0) - loss(-eps, 1.0)) / (2 * eps)
    np.testing.assert_allclose(g_t1, fd_t1, rtol=1e-2)
    np.testing.assert_allclose(g_t0, fd_t0, rtol=1e-2)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_grid_interior_cotangents_match_jax(method):
    """A weighted loss over a 5-point grid through
    ``GradientMethod.integrate(..., diff_bounds=True)``: row k >= 1 gets
    <g_k, f(z_k, t_k)>, row 0 the swept-adjoint term; every row equals
    the JAX package's within 1e-5."""
    (gj, sj), (gt, st) = METHODS[method]
    grid = np.linspace(0.0, 1.0, 5).astype(np.float32)
    w = np.array([0.3, 1.0, -0.5, 2.0, 0.7], np.float32)

    def loss_j(ts_):
        traj, _ = gj.integrate(_fj, {"a": jnp.asarray(0.8)}, jnp.asarray(Z0),
                               ts_, sj, J.ConstantSteps(8), True)
        return jnp.sum(jnp.asarray(w)[:, None] * traj ** 2)

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(grid)))
    ts = torch.tensor(grid, requires_grad=True)
    traj, _ = gt.integrate(_ft, _tp(), torch.tensor(Z0), ts, st,
                           T.ConstantSteps(8), True)
    (g_ts,) = torch.autograd.grad(
        torch.sum(torch.tensor(w)[:, None] * traj ** 2), [ts])
    traj = traj.detach()
    for k in range(1, 5):
        row = float(torch.sum(2.0 * w[k] * traj[k]
                              * _ft(_tp(), traj[k], torch.tensor(grid[k]))))
        np.testing.assert_allclose(float(g_ts[k]), row, rtol=1e-6,
                                   err_msg=f"row {k}")
    np.testing.assert_allclose(g_ts.numpy(), want, rtol=1e-5, atol=1e-7)


def test_methods_agree_on_bound_gradients():
    """One convention, not four: on one fixed grid every method's bound
    gradients agree with Naive's (5e-3, the JAX package's bar: the
    methods run different solvers); those sharing the forward
    discretization agree to 1e-5 on dL/dt1, and MALI and Naive (ALF),
    ACA and Naive (Heun-Euler) on both."""
    ctrl = T.ConstantSteps(32)
    g = {name: _port_bounds(gr, sv, ctrl, 0.0, 1.0)[:2]
         for name, (_, (gr, sv)) in METHODS.items()}
    g["naive_heun"] = _port_bounds(T.Naive(), T.HeunEuler(), ctrl, 0.0,
                                   1.0)[:2]
    for name, gg in g.items():
        np.testing.assert_allclose(gg, g["naive"], rtol=5e-3, err_msg=name)
    for name in ("mali", "mali_cuda"):
        np.testing.assert_allclose(g[name], g["naive"], rtol=1e-5)
    np.testing.assert_allclose(g["aca"], g["naive_heun"], rtol=1e-5)
    np.testing.assert_allclose(g["adjoint_alf_cuda"][1], g["naive"][1],
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["mali", "aca", "adjoint"])
def test_diff_bounds_off_keeps_zero_cotangents(method):
    _, (gradient, solver) = METHODS[method]
    g_t0, g_t1, _ = _port_bounds(gradient, solver, T.ConstantSteps(8), 0.0,
                                 1.0, diff_bounds=False)
    assert g_t0 == 0.0 and g_t1 == 0.0


@pytest.mark.parametrize("saveat", [T.SaveAt(steps=True),
                                    T.SaveAt(dense=True)],
                         ids=["steps", "dense"])
def test_diff_bounds_needs_an_observation_grid(saveat):
    with pytest.raises(ValueError, match="fixed observation grid"):
        T.solve(_ft, _tp(), torch.tensor(Z0), 0.0, 1.0, solver=T.ALF(),
                controller=T.ConstantSteps(4), gradient=T.MALI(),
                saveat=saveat, diff_bounds=True)


def test_diff_bounds_observation_grid_through_solve():
    ts = torch.linspace(0.0, 1.0, 4, requires_grad=True)
    s = T.solve(_ft, _tp(), torch.tensor(Z0), solver=T.ALF(),
                controller=T.ConstantSteps(8), gradient=T.MALI(),
                saveat=T.SaveAt(ts=ts), diff_bounds=True)
    (g,) = torch.autograd.grad(torch.sum(s.ys ** 2), [ts])
    assert torch.isfinite(s.ys).all() and torch.isfinite(g).all()
    assert bool((g != 0).all())
