"""The port's Runge-Kutta solvers against the JAX package's on the CPU.

The same numpy parameters and state go through ``repro.core`` and
``repro_torch.core``: every registry name's single step (value and
embedded error), the tableaus' coefficients, and Naive solves with each
tableau under both controllers on ascending and descending grids (``ys``,
gradients, ``Stats`` and the recorded ``(t_i, h_i)``). f32 values and
gradients agree within rtol 1e-5; step counts are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import integrate as jint
from repro.core import solvers as jsolvers
from repro_torch import params_from_numpy
from repro_torch.core import integrate as tint
from repro_torch.core import solvers as tsolvers

torch.set_num_threads(1)

D, W, B = 3, 8, 4
RTOL, ATOL = 1e-5, 1e-6


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"b1": np.zeros(W, f32),
            "b2": (0.1 * rng.standard_normal(D)).astype(f32),
            "bt": np.full(W, 0.3, f32),
            "w1": (0.5 * rng.standard_normal((D, W))).astype(f32),
            "w2": (0.5 * rng.standard_normal((W, D))).astype(f32)}


def _np_z0(seed=1):
    return np.random.default_rng(seed).standard_normal((B, D)).astype(
        np.float32)


def f_jax(p, z, t):
    return jnp.tanh(z @ p["w1"] + p["b1"] + t * p["bt"]) @ p["w2"] + p["b2"]


def f_torch(p, z, t):
    return torch.tanh(z @ p["w1"] + p["b1"] + t * p["bt"]) @ p["w2"] + p["b2"]


def _jp():
    return {k: jnp.asarray(v) for k, v in _np_params().items()}


def _tp(grad=False):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(grad)
    return p


RK_NAMES = sorted(n for n in J.SOLVERS if n != "alf")


def test_registry_names_and_aliases_match_jax():
    assert sorted(T.SOLVERS) == sorted(J.SOLVERS)
    for name, js in J.SOLVERS.items():
        ts = T.get_solver(name)
        assert ts.name == js.name, name
        assert (ts.order, ts.stages, ts.has_error_estimate) == (
            js.order, js.stages, js.has_error_estimate), name
        if name != "alf":
            assert ts.fsal == js.fsal
            assert ts.kernel_step_ops() == ()


@pytest.mark.parametrize("name", ["EULER", "HEUN2", "MIDPOINT", "BOSH3",
                                  "RK4", "DOPRI5"])
def test_tableau_coefficients_are_the_jax_floats(name):
    jt, tt = getattr(jsolvers, name), getattr(tsolvers, name)
    for field in ("name", "order", "c", "a", "b", "b_err", "fsal"):
        assert getattr(tt, field) == getattr(jt, field), field


@pytest.mark.parametrize("name", sorted(J.SOLVERS))
def test_single_step_matches_jax(name):
    """One trial step of every registry name at t = 0.3, h = 0.17: the
    next state and (for embedded pairs and ALF) the error ratio."""
    ctrl_j = J.AdaptiveController(1e-3, 1e-4) if J.SOLVERS[
        name].has_error_estimate else J.ConstantSteps(1)
    ctrl_t = T.AdaptiveController(1e-3, 1e-4) if ctrl_j.adaptive else \
        T.ConstantSteps(1)
    js, ts = J.get_solver(name), T.get_solver(name)
    pj, pt = _jp(), _tp()
    zj, zt = jnp.asarray(_np_z0()), torch.tensor(_np_z0())
    t, h = 0.3, 0.17
    sj = js.init_state(f_jax, pj, zj, jnp.float32(t))
    st = ts.init_state(f_torch, pt, zt, torch.tensor(t))
    (nj, rj) = js.trial_fn(f_jax, pj, ctrl_j)(sj, jnp.float32(t),
                                               jnp.float32(h))
    (nt, rt) = ts.trial_fn(f_torch, pt, ctrl_t)(st, torch.tensor(t),
                                                 torch.tensor(h))
    np.testing.assert_allclose(ts.output(nt).numpy(),
                               np.asarray(js.output(nj)), rtol=RTOL,
                               atol=ATOL)
    # The error estimate cancels (sum b_err_i = 0): a last-bit difference
    # of the stages moves the ratio by ~1e-6 absolute here.
    np.testing.assert_allclose(float(rt), float(rj), rtol=RTOL, atol=1e-5)
    if name != "alf":
        zn, err_t = ts.tableau.step(f_torch, pt, zt, torch.tensor(t),
                                    torch.tensor(h))
        zj1, err_j = js.tableau.step(f_jax, pj, zj, jnp.float32(t),
                                     jnp.float32(h))
        np.testing.assert_allclose(zn.numpy(), np.asarray(zj1), rtol=RTOL,
                                   atol=ATOL)
        assert (err_t is None) == (err_j is None)
        if err_t is not None:
            # ~1 ulp of the stages (f32 GEMMs) times h * sum |b_err|
            np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j),
                                       rtol=RTOL, atol=2e-8)


CASES = (
    [(n, "const") for n in RK_NAMES if n in ("euler", "midpoint", "rk4",
                                             "dopri5", "heun2")]
    + [(n, "adaptive") for n in ("heun2", "bosh3", "dopri5")])
GRIDS = {"asc": (0.0, 0.35, 0.7, 1.0), "desc": (1.0, 0.6, 0.2)}


def _controllers(kind):
    if kind == "const":
        return J.ConstantSteps(5), T.ConstantSteps(5)
    return J.AdaptiveController(1e-4, 1e-5, 48), \
        T.AdaptiveController(1e-4, 1e-5, 48)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,kind", CASES)
def test_rk_naive_solve_matches_jax(name, kind, grid):
    """Naive through each tableau: ys, gradients (params, z0) and Stats."""
    cj, ct = _controllers(kind)
    ts = GRIDS[grid]

    def loss_j(p, z):
        s = J.solve(f_jax, p, z, solver=name, controller=cj,
                    gradient=J.Naive(),
                    saveat=J.SaveAt(ts=jnp.asarray(ts, jnp.float32)))
        return jnp.sum(s.ys ** 2) + jnp.sum(jnp.sin(s.ys)), s

    (_, sj), (gpj, gzj) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(_jp(), jnp.asarray(_np_z0()))
    pt = _tp(grad=True)
    zt = torch.tensor(_np_z0(), requires_grad=True)
    st = T.solve(f_torch, pt, zt, solver=name, controller=ct,
                 gradient=T.Naive(), saveat=T.SaveAt(ts=ts))
    loss = torch.sum(st.ys ** 2) + torch.sum(torch.sin(st.ys))
    keys = sorted(pt)
    gt = torch.autograd.grad(loss, [pt[k] for k in keys] + [zt])
    np.testing.assert_allclose(st.ys.detach().numpy(), np.asarray(sj.ys),
                               rtol=RTOL, atol=ATOL)
    for field in ("n_accepted", "n_rejected", "n_fevals"):
        assert int(getattr(st.stats, field)) == int(getattr(sj.stats,
                                                            field)), field
    assert st.stats.residual_bytes == sj.stats.residual_bytes
    tol = dict(rtol=RTOL, atol=ATOL) if kind == "const" else \
        dict(rtol=2e-4, atol=2e-5)
    for k, g in zip(keys, gt[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gpj[k]),
                                   err_msg=k, **tol)
    np.testing.assert_allclose(gt[-1].numpy(), np.asarray(gzj), **tol)


# (solver, rtol, atol, rtol of the recorded h) on the f32, time-dependent
# field. Counts, accept/reject decisions and states are identical; h is
# not, for two reasons (tests/rk_step_size_trace.py prints the figures).
# (1) Jitted XLA rounds the stage time t + c_i*h (and in f32 the stage
# sums) once where eager torch rounds twice: one rk23 step at t = 0.0204,
# h = 0.0950 in f64 differs by 6e-11 in its error estimate between jitted
# and eager JAX, while eager JAX and torch agree to 3e-18. The embedded
# error estimate is a cancelling sum, so where the error ratio is small
# the ulp is a large part of it: dopri5 at 1e-4/1e-5 leaves the factor-10
# clip at trial 2 with ratio 1.23e-6 (torch) against 9.68e-7 (JAX), an
# error of ~1e-10, and h = 0.9 * ratio^(-1/6) * h differs by 4% at trial
# 3 (7.8% at most, descending grid). (2) A segment's clamped last step
# h = t1 - t carries t's absolute difference, relatively large when that
# step is short. heun_euler's h differs by at most 2.1e-4, rk23's by
# 4.5e-3. Without either source (an f64 state, an autonomous field) the
# controller and b_err are held to 1e-5 by
# test_rk_adaptive_step_sizes_match_jax_in_f64.
BUFFER_CASES = [("heun2", 1e-4, 1e-5, 1e-5), ("rk2", 1e-2, 1e-3, 1e-5),
                ("heun_euler", 1e-3, 1e-4, 1e-3),
                ("bosh3", 1e-2, 1e-3, 1e-5), ("rk23", 1e-4, 1e-5, 1e-2),
                ("dopri5", 1e-2, 1e-3, 1e-5), ("dopri5", 1e-4, 1e-5, 1e-1)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,rtol,atol,h_rtol", BUFFER_CASES)
def test_rk_adaptive_records_identical_step_buffers(name, rtol, atol,
                                                    h_rtol, grid):
    """The per-segment accepted counts, trial count and states of the
    adaptive grid driver equal the JAX driver's, and the recorded
    (t_i, h_i) buffers agree (padding slots included)."""
    cj = J.AdaptiveController(rtol, atol, 48)
    ct = T.AdaptiveController(rtol, atol, 48)
    ts = GRIDS[grid]
    pj, pt = _jp(), _tp()
    rj = jint.integrate_grid(J.get_solver(name).trial_fn(f_jax, pj, cj),
                             jnp.asarray(_np_z0()),
                             jnp.asarray(ts, jnp.float32), controller=cj,
                             order=J.get_solver(name).order)
    rt = tint.integrate_grid(T.get_solver(name).trial_fn(f_torch, pt, ct),
                             torch.tensor(_np_z0()), tint.as_time_grid(ts),
                             controller=ct, order=T.get_solver(name).order)
    np.testing.assert_array_equal(rt.n_accepted.numpy(),
                                  np.asarray(rj.n_accepted))
    assert int(rt.n_trials) == int(rj.n_trials)
    np.testing.assert_allclose(rt.ts.numpy(), np.asarray(rj.ts),
                               rtol=h_rtol, atol=1e-7)
    np.testing.assert_allclose(rt.hs.numpy(), np.asarray(rj.hs),
                               rtol=h_rtol, atol=1e-7)
    np.testing.assert_allclose(rt.state.numpy(), np.asarray(rj.state),
                               rtol=RTOL, atol=ATOL)


# four f32 ulps of t near 1: a clamped last step h = t1 - t carries t's
# absolute difference, which the f32 pow of the step-size factor (XLA's
# against libm's, an ulp apart) leaves in t
T_ULPS = 4 * 2.0 ** -23


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,rtol,atol", [c[:3] for c in BUFFER_CASES])
def test_rk_adaptive_step_sizes_match_jax_in_f64(name, rtol, atol, grid):
    """The step-size controller and the tableaus' b_err against the JAX
    package with both of the f32 case's sources of difference removed: an
    f64 state (the error estimate exact to f64) and an autonomous field
    (the stage times' rounding reaches no stage). The recorded (t_i, h_i)
    agree within 1e-5 relative or T_ULPS, counts exactly."""
    params = {k: (0 * v if k == "bt" else v).astype(np.float64)
              for k, v in _np_params().items()}
    z0 = _np_z0().astype(np.float64)
    ts = GRIDS[grid]
    cj = J.AdaptiveController(rtol, atol, 48)
    ct = T.AdaptiveController(rtol, atol, 48)
    jax.config.update("jax_enable_x64", True)
    try:
        pj = {k: jnp.asarray(v) for k, v in params.items()}
        rj = jint.integrate_grid(
            J.get_solver(name).trial_fn(f_jax, pj, cj), jnp.asarray(z0),
            jnp.asarray(ts, jnp.float32), controller=cj,
            order=J.get_solver(name).order)
        rj = jax.tree_util.tree_map(np.asarray, rj)
    finally:
        jax.config.update("jax_enable_x64", False)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    rt = tint.integrate_grid(T.get_solver(name).trial_fn(f_torch, pt, ct),
                             torch.tensor(z0), tint.as_time_grid(ts),
                             controller=ct, order=T.get_solver(name).order)
    np.testing.assert_array_equal(rt.n_accepted.numpy(), rj.n_accepted)
    assert int(rt.n_trials) == int(rj.n_trials)
    np.testing.assert_allclose(rt.ts.numpy(), rj.ts, rtol=1e-5,
                               atol=T_ULPS)
    np.testing.assert_allclose(rt.hs.numpy(), rj.hs, rtol=1e-5,
                               atol=T_ULPS)
    np.testing.assert_allclose(rt.state.numpy(), rj.state, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name,kind", [("dopri5", "const"),
                                       ("heun2", "adaptive")])
def test_integrate_span_matches_jax(name, kind):
    """The single-span driver, in reverse time."""
    cj, ct = _controllers(kind)
    pj, pt = _jp(), _tp()
    js, tsv = J.get_solver(name), T.get_solver(name)
    oj = jint.integrate_span(js.trial_fn(f_jax, pj, cj),
                             jnp.asarray(_np_z0()), jnp.float32(1.0),
                             jnp.float32(0.1), controller=cj, order=js.order)
    ot = tint.integrate_span(tsv.trial_fn(f_torch, pt, ct),
                             torch.tensor(_np_z0()), torch.tensor(1.0),
                             torch.tensor(0.1), controller=ct,
                             order=tsv.order)
    np.testing.assert_allclose(ot.state.numpy(), np.asarray(oj.state),
                               rtol=RTOL, atol=ATOL)
    assert int(ot.n_accepted) == int(oj.n_accepted)
    assert int(ot.n_trials) == int(oj.n_trials)


def test_rk_dense_output_matches_jax():
    """SaveAt(dense=True) with Heun-Euler: the default interpolant's two f
    passes (counted in n_fevals) and evaluate(t) against the JAX
    package's."""
    cj = J.AdaptiveController(1e-4, 1e-5, 96)
    ct = T.AdaptiveController(1e-4, 1e-5, 96)
    sj = J.solve(f_jax, _jp(), jnp.asarray(_np_z0()), 0.0, 1.0,
                 solver=J.HeunEuler(), controller=cj, gradient=J.Naive(),
                 saveat=J.SaveAt(dense=True))
    st = T.solve(f_torch, _tp(), torch.tensor(_np_z0()), 0.0, 1.0,
                 solver=T.HeunEuler(), controller=ct, gradient=T.Naive(),
                 saveat=T.SaveAt(dense=True))
    assert int(st.stats.n_fevals) == int(sj.stats.n_fevals)
    q = [0.0, 0.21, 0.5, 0.93, 1.0]
    np.testing.assert_allclose(
        st.evaluate(torch.tensor(q)).detach().numpy(),
        np.asarray(sj.evaluate(jnp.asarray(q))), rtol=RTOL, atol=ATOL)


def test_adaptive_refuses_a_tableau_without_error_estimate():
    for gradient in (T.Naive(), T.ACA(), T.Backsolve()):
        with pytest.raises(ValueError, match="embedded error estimate"):
            T.solve(f_torch, _tp(), torch.tensor(_np_z0()),
                    solver=T.Rk4(), controller=T.AdaptiveController(),
                    gradient=gradient)
