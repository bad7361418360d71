"""Terminating events (``solve(..., event=Event(...))``) in the port,
against the JAX package on the CPU.

Ports the cases of tests/test_reverse_time.py's event section for all four
gradient methods (and MALI on the kernel backend, whose ops run their
plain versions on the CPU): event time and gradient, grid rows frozen
after the event, no firing in a short span, the direction filter, reverse
time, validation, the implicit-function-theorem gradient of
``stats.event_time`` and its zero when the event does not fire. Each case
holds the port to its analytic bar and to the JAX package: under
``ConstantSteps`` the event time within 2 f32 ulps and values and
gradients within 1e-5 relative; under ``AdaptiveController`` in f64 (f32
adaptive step sizes differ by the stage time's rounding between jitted
XLA and eager torch, see tests/rk_step_size_trace.py) the event time
within 2 f32 ulps and values and gradients within 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core.dense import locate_event
from repro_torch.core.solve import _record_span, _span_interpolation

torch.set_num_threads(1)

CONFIGS = {
    "mali": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF())),
    "mali_cuda": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF(backend="cuda"))),
    "naive": ((J.Naive(), J.ALF()), (T.Naive(), T.ALF())),
    "aca": ((J.ACA(), J.HeunEuler()), (T.ACA(), T.HeunEuler())),
    "adjoint": ((J.Backsolve(), J.Dopri5()), (T.Backsolve(), T.Dopri5())),
}
CONTROLLERS = {
    "fixed": (J.ConstantSteps(96), T.ConstantSteps(96)),
    "adaptive": (J.AdaptiveController(1e-4, 1e-5, 256),
                 T.AdaptiveController(1e-4, 1e-5, 256)),
}
# the event time against the JAX package's: 2 f32 ulps near t* ~ 1
T_ATOL = 2 * 2.0 ** -23
RTOL = {"fixed": 1e-5, "adaptive": 1e-6}

EV_A = 0.7
T_CROSS = math.log(2.0) / EV_A  # z0 = 1 decaying through 0.5


def _decay_j(params, z, t):
    return -params["a"] * z


def _decay_t(params, z, t):
    return -params["a"] * z


def _cond(z, t):
    return z[0] - 0.5


EV_J = J.Event(_cond, direction=-1)
EV_T = T.Event(_cond, direction=-1)


def _dtype(ctrl):
    # adaptive parity is held in f64 (see the module docstring)
    return np.float64 if ctrl == "adaptive" else np.float32


def _jax_run(fn, ctrl):
    """Run ``fn`` with JAX in f64 for the adaptive cases."""
    if ctrl != "adaptive":
        return jax.tree_util.tree_map(np.asarray, fn())
    jax.config.update("jax_enable_x64", True)
    try:
        return jax.tree_util.tree_map(np.asarray, fn())
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _port(method, ctrl, t1=3.0, event=EV_T, z0=None, saveat=None):
    """The port's event solve from fresh leaves; returns the solution and
    the leaves (a, z0)."""
    (_, _), (gradient, solver) = CONFIGS[method]
    dt = torch.float64 if ctrl == "adaptive" else torch.float32
    a = torch.tensor(EV_A, dtype=dt, requires_grad=True)
    z = (torch.ones(3, dtype=dt) if z0 is None else z0).requires_grad_(True)
    sol = T.solve(_decay_t, {"a": a}, z, 0.0, t1, solver=solver,
                  controller=CONTROLLERS[ctrl][1], gradient=gradient,
                  event=event, saveat=saveat)
    return sol, a, z


@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_event_time_and_gradient(method, ctrl):
    (gj, sj), _ = CONFIGS[method]
    cj = CONTROLLERS[ctrl][0]
    sol, a, z = _port(method, ctrl)
    assert bool(sol.stats.event_fired)
    assert abs(float(sol.stats.event_time) - T_CROSS) < 1e-3
    assert abs(float(sol.ys[0]) - 0.5) < 1e-3
    assert abs(float(sol.ts) - float(sol.stats.event_time)) < 1e-6
    loss = torch.sum(sol.ys ** 2)
    g_a, g_z = torch.autograd.grad(loss, [a, z])
    # frozen-t_event analytic gradient: d/da sum(3 * e^{-2 a t*}) at t*
    g_exact = -2.0 * T_CROSS * 3.0 * math.exp(-2.0 * EV_A * T_CROSS)
    np.testing.assert_allclose(float(g_a), g_exact, rtol=2e-2)

    dt = _dtype(ctrl)

    def jax_side():
        def loss_j(p, z0):
            s = J.solve(_decay_j, p, z0, 0.0, 3.0, solver=sj, controller=cj,
                        gradient=gj, event=EV_J)
            return jnp.sum(s.ys ** 2), s

        (l, s), g = jax.value_and_grad(loss_j, argnums=(0, 1),
                                       has_aux=True)(
            {"a": jnp.asarray(EV_A, dt)}, jnp.ones(3, dt))
        return l, s.stats.event_time, s.ys, g[0]["a"], g[1], s.stats

    l_j, t_j, ys_j, ga_j, gz_j, st_j = _jax_run(jax_side, ctrl)
    np.testing.assert_allclose(float(sol.stats.event_time), float(t_j),
                               rtol=0, atol=T_ATOL)
    rtol = RTOL[ctrl]
    _close(sol.ys.detach(), ys_j, rtol, "ys")
    _close(float(loss), l_j, rtol, "loss")
    _close(float(g_a), ga_j, rtol, "dL/da")
    _close(g_z, gz_j, rtol, "dL/dz0")
    # the accounting: re-solve + detection pass, exactly as the JAX package
    for k in ("n_accepted", "n_rejected", "n_fevals", "n_segments",
              "event_fired", "span_complete"):
        assert np.asarray(getattr(sol.stats, k)) == np.asarray(
            getattr(st_j, k)), k


@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
def test_event_grid_rows_frozen_after_event(ctrl):
    cj, ct = CONTROLLERS[ctrl]
    ts = np.linspace(0.0, 3.0, 7, dtype=np.float32)
    dt = torch.float64 if ctrl == "adaptive" else torch.float32
    sol = T.solve(_decay_t, {"a": torch.tensor(EV_A, dtype=dt)},
                  torch.ones(3, dtype=dt), solver=T.ALF(), controller=ct,
                  gradient=T.MALI(), saveat=T.SaveAt(ts=torch.tensor(ts)),
                  event=EV_T)
    t_ev = float(sol.stats.event_time)
    ts_out, ys_out = sol.ts.numpy(), sol.ys.numpy()
    assert bool(sol.stats.event_fired)
    # pre-event rows keep their grid time; post-event rows clamp to t_event
    pre = ts <= t_ev
    np.testing.assert_allclose(ts_out[pre], ts[pre], atol=1e-6)
    np.testing.assert_allclose(ts_out[~pre], t_ev, atol=1e-6)
    # ... and hold the frozen terminal state
    for row in ys_out[~pre]:
        np.testing.assert_allclose(row, ys_out[~pre][0], atol=1e-5)
    np.testing.assert_allclose(ys_out[~pre][:, 0], 0.5, atol=1e-3)

    dtn = _dtype(ctrl)
    s_j = _jax_run(lambda: J.solve(
        _decay_j, {"a": jnp.asarray(EV_A, dtn)}, jnp.ones(3, dtn),
        solver=J.ALF(), controller=cj, gradient=J.MALI(),
        saveat=J.SaveAt(ts=jnp.asarray(ts)), event=EV_J), ctrl)
    np.testing.assert_allclose(ts_out, s_j.ts, rtol=0, atol=T_ATOL)
    _close(ys_out, s_j.ys, RTOL[ctrl], "grid ys")


@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_event_does_not_fire_within_short_span(method):
    (gj, sj), (gt, st) = CONFIGS[method]
    sol = T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), 0.0,
                  0.2, solver=st, controller=T.ConstantSteps(16),
                  gradient=gt, event=EV_T)
    assert not bool(sol.stats.event_fired)
    assert abs(float(sol.stats.event_time) - 0.2) < 1e-6
    # no event => the plain end state
    plain = T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), 0.0,
                    0.2, solver=st, controller=T.ConstantSteps(16),
                    gradient=gt)
    np.testing.assert_allclose(sol.ys.numpy(), plain.ys.numpy(), atol=1e-6)
    s_j = J.solve(_decay_j, {"a": jnp.float32(EV_A)}, jnp.ones(3), 0.0, 0.2,
                  solver=sj, controller=J.ConstantSteps(16), gradient=gj,
                  event=EV_J)
    assert not bool(s_j.stats.event_fired)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(s_j.ys),
                               rtol=1e-6)
    assert float(sol.stats.event_time) == float(s_j.stats.event_time)


def _osc_t(params, z, t):
    return torch.stack([z[1], -z[0]])


def _osc_j(params, z, t):
    return jnp.stack([z[1], -z[0]])


@pytest.mark.parametrize("direction,want", [(-1, math.pi / 2),
                                            (+1, 3 * math.pi / 2),
                                            (0, math.pi / 2)])
def test_event_direction_filter(direction, want):
    # z[0](t) = cos t: zero crossings alternate falling (pi/2) then rising
    # (3 pi/2); a rising-only event must skip the first
    kw_t = dict(solver=T.ALF(), controller=T.ConstantSteps(160),
                gradient=T.MALI())
    sol = T.solve(_osc_t, {}, torch.tensor([1.0, 0.0]), 0.0, 5.0,
                  event=T.Event(lambda z, t: z[0], direction=direction),
                  **kw_t)
    assert bool(sol.stats.event_fired)
    assert abs(float(sol.stats.event_time) - want) < 5e-3
    s_j = J.solve(_osc_j, {}, jnp.asarray([1.0, 0.0]), 0.0, 5.0,
                  solver=J.ALF(), controller=J.ConstantSteps(160),
                  gradient=J.MALI(),
                  event=J.Event(lambda z, t: z[0], direction=direction))
    np.testing.assert_allclose(float(sol.stats.event_time),
                               float(s_j.stats.event_time), rtol=0,
                               atol=T_ATOL)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(s_j.ys),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_event_reverse_time(method):
    (gj, sj), (gt, st) = CONFIGS[method]
    z_end = math.exp(-EV_A * 3.0)
    ev_t = T.Event(_cond, direction=+1)
    sol = T.solve(_decay_t, {"a": torch.tensor(EV_A)},
                  torch.full((3,), z_end), 3.0, 0.0, solver=st,
                  controller=T.ConstantSteps(96), gradient=gt, event=ev_t)
    assert bool(sol.stats.event_fired)
    assert abs(float(sol.stats.event_time) - T_CROSS) < 2e-3
    s_j = J.solve(_decay_j, {"a": jnp.float32(EV_A)},
                  jnp.full((3,), z_end, jnp.float32), 3.0, 0.0, solver=sj,
                  controller=J.ConstantSteps(96), gradient=gj,
                  event=J.Event(_cond, direction=+1))
    np.testing.assert_allclose(float(sol.stats.event_time),
                               float(s_j.stats.event_time), rtol=0,
                               atol=T_ATOL)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(s_j.ys),
                               rtol=1e-5)


def test_event_validation():
    with pytest.raises(ValueError, match="direction"):
        T.Event(lambda z, t: z, direction=2)
    with pytest.raises(ValueError, match="max_bisections"):
        T.Event(lambda z, t: z, max_bisections=0)
    with pytest.raises(TypeError, match="callable"):
        T.Event(3.0)
    kw = dict(solver=T.ALF(), controller=T.ConstantSteps(4),
              gradient=T.MALI())
    with pytest.raises(ValueError, match="not supported"):
        T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), 0.0,
                1.0, event=EV_T, saveat=T.SaveAt(steps=True), **kw)
    with pytest.raises(ValueError, match="not supported"):
        T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), 0.0,
                1.0, event=EV_T, saveat=T.SaveAt(dense=True), **kw)
    for batching in (T.Lockstep(), T.PerSample()):
        with pytest.raises(ValueError, match="batching"):
            T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(4, 3),
                    0.0, 1.0, event=EV_T, batching=batching, **kw)
    with pytest.raises(TypeError, match="must be an Event"):
        T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), 0.0,
                1.0, event=_cond, **kw)
    # equality by field, cond_fn by identity (as the JAX package's)
    assert T.Event(_cond, direction=-1) == EV_T
    assert T.Event(lambda z, t: z[0], direction=-1) != EV_T


@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_event_time_gradient_matches_ift(method, ctrl):
    # c(z(t*; theta), t*) = 0 with z = z0 e^{-a t} and c = z[0] - 0.5 gives
    # t* = ln(2 z0[0]) / a, so dt*/da = -t*/a, dt*/dz0 = (1/(a z0[0]), 0, 0)
    (gj, sj), _ = CONFIGS[method]
    cj = CONTROLLERS[ctrl][0]
    sol, a, z = _port(method, ctrl)
    g_a, g_z = torch.autograd.grad(sol.stats.event_time, [a, z])
    np.testing.assert_allclose(float(g_a), -T_CROSS / EV_A, rtol=2e-2)
    np.testing.assert_allclose(g_z.numpy(), [1.0 / EV_A, 0.0, 0.0],
                               atol=2e-2)
    dt = _dtype(ctrl)

    def jax_side():
        def t_star(p, z0):
            return J.solve(_decay_j, p, z0, 0.0, 3.0, solver=sj,
                           controller=cj, gradient=gj,
                           event=EV_J).stats.event_time

        g = jax.grad(t_star, argnums=(0, 1))({"a": jnp.asarray(EV_A, dt)},
                                             jnp.ones(3, dt))
        return g[0]["a"], g[1]

    ga_j, gz_j = _jax_run(jax_side, ctrl)
    _close(float(g_a), ga_j, RTOL[ctrl], "dt*/da")
    _close(g_z, gz_j, RTOL[ctrl], "dt*/dz0")


def test_event_time_gradient_zero_when_unfired():
    # the IFT correction is gated on event_fired: an event-free span keeps
    # the plain span end with no parameter gradient
    a = torch.tensor(EV_A, requires_grad=True)
    sol = T.solve(_decay_t, {"a": a}, torch.ones(3), 0.0, 0.2,
                  solver=T.ALF(), controller=T.ConstantSteps(16),
                  gradient=T.MALI(), event=EV_T)
    (g,) = torch.autograd.grad(sol.stats.event_time, [a],
                               allow_unused=True)
    assert g is None or float(g) == 0.0


def test_event_with_diff_bounds_matches_jax():
    """dL/dt0 through an event solve (the re-solve keeps t0's gradient)."""
    t0 = torch.tensor(0.1, requires_grad=True)
    sol = T.solve(_decay_t, {"a": torch.tensor(EV_A)}, torch.ones(3), t0,
                  3.0, solver=T.ALF(), controller=T.ConstantSteps(96),
                  gradient=T.MALI(), event=EV_T, diff_bounds=True)
    (g_t,) = torch.autograd.grad(torch.sum(sol.ys ** 2), [t0])

    def loss(t):
        s = J.solve(_decay_j, {"a": jnp.float32(EV_A)}, jnp.ones(3), t, 3.0,
                    solver=J.ALF(), controller=J.ConstantSteps(96),
                    gradient=J.MALI(), event=EV_J, diff_bounds=True)
        return jnp.sum(s.ys ** 2)

    g_j = float(jax.grad(loss)(jnp.float32(0.1)))
    assert g_j != 0.0
    np.testing.assert_allclose(float(g_t), g_j, rtol=1e-5)


@pytest.mark.parametrize("solver", ["alf", "heun_euler"])
def test_locate_event_evaluates_no_dynamics(solver):
    """The bisection evaluates the interpolant, never ``f``; ``cond_fn`` is
    called once batched over the nodes, once at the span end and once per
    bisection. The result matches the JAX package's."""
    calls = {"f": 0, "cond": 0}

    def f(params, z, t):
        calls["f"] += 1
        return -params["a"] * z

    def cond(z, t):
        calls["cond"] += 1
        return z[0] - 0.5

    st = T.get_solver(solver)
    ct = T.AdaptiveController(1e-4, 1e-5, 256)
    p, z0 = {"a": torch.tensor(EV_A)}, torch.ones(3)
    with torch.no_grad():
        grid, res = _record_span(f, p, z0, 0.0, 3.0, st, ct)
        interp = _span_interpolation(f, p, st, grid, res)
        before = calls["f"]
        t_ev, fired = locate_event(interp, cond, -1, 20, grid[-1])
    assert calls["f"] == before
    assert calls["cond"] == 2 + 20
    assert bool(fired) and abs(float(t_ev) - T_CROSS) < 1e-3
    assert isinstance(fired, torch.Tensor) and fired.dtype == torch.bool
