"""The port's ``odeint`` front door, its kwargs facades and
``OdeSettings.as_objects``, against the JAX package's on the CPU.

Mirrors tests/test_solve_api.py: ``odeint(strings)`` equals
``solve(objects).ys`` bit for bit (values and gradients) for every method
x {fixed, adaptive} x {scalar, grid}, and equals the JAX package's
``odeint`` within rtol 1e-5 (adaptive gradients: rtol 2e-4 / atol 2e-5);
the DeprecationWarning and the kwarg errors; the ``odeint_*`` facades and
``mali_forward_stats``; ``OdeSettings.as_objects`` lowering every method
and solver name as the JAX package's does, and ``ode_block``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import params_from_numpy

torch.set_num_threads(1)

D, W, B = 3, 6, 4
TS = (0.0, 0.2, 0.5, 0.75, 1.0)
TOL = dict(rtol=1e-5, atol=1e-6)
ADAPTIVE_TOL = dict(rtol=2e-4, atol=2e-5)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"b": (0.1 * rng.standard_normal(D)).astype(f32),
            "w1": (0.5 * rng.standard_normal((D, W))).astype(f32),
            "w2": (0.5 * rng.standard_normal((W, D))).astype(f32)}


def _np_z0():
    return np.random.default_rng(1).standard_normal((B, D)).astype(
        np.float32)


def f_jax(p, z, t):
    return jnp.tanh(z @ p["w1"]) @ p["w2"] * jnp.cos(t) + p["b"]


def f_torch(p, z, t):
    return torch.tanh(z @ p["w1"]) @ p["w2"] * torch.cos(t) + p["b"]


def _legacy_kwargs(fixed):
    return (dict(n_steps=4) if fixed else
            dict(n_steps=0, rtol=1e-4, atol=1e-5, max_steps=64))


def _objects(method, fixed):
    gradient = {"mali": T.MALI(), "naive": T.Naive(), "aca": T.ACA(),
                "adjoint": T.Backsolve()}[method]
    solver = {"mali": T.ALF(), "naive": T.ALF(), "aca": T.HeunEuler(),
              "adjoint": T.Dopri5()}[method]
    controller = (T.ConstantSteps(4) if fixed else
                  T.AdaptiveController(1e-4, 1e-5, 64))
    return gradient, solver, controller


def _port_grads(run):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(), requires_grad=True)
    out = run(p, z)
    loss = torch.sum(out ** 2) + torch.sum(torch.sin(out))
    keys = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [z])
    return out.detach(), dict(zip(keys, grads[:-1])), grads[-1]


@pytest.mark.parametrize("grid", [False, True], ids=["scalar", "grid"])
@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("method", T.METHODS)
def test_odeint_equals_solve_and_jax(method, fixed, grid):
    ts = TS if grid else None
    gradient, solver, controller = _objects(method, fixed)
    saveat = T.SaveAt(ts=ts) if grid else T.SaveAt()
    legacy = _port_grads(lambda p, z: T.odeint(
        f_torch, p, z, 0.0, 1.0, ts=ts, method=method,
        **_legacy_kwargs(fixed)))
    objects = _port_grads(lambda p, z: T.solve(
        f_torch, p, z, 0.0, 1.0, solver=solver, controller=controller,
        gradient=gradient, saveat=saveat).ys)
    np.testing.assert_array_equal(legacy[0].numpy(), objects[0].numpy())
    for k in legacy[1]:
        np.testing.assert_array_equal(legacy[1][k].numpy(),
                                      objects[1][k].numpy())
    np.testing.assert_array_equal(legacy[2].numpy(), objects[2].numpy())

    def loss_j(p, z):
        out = J.odeint(f_jax, p, z, 0.0, 1.0,
                       ts=None if ts is None else jnp.asarray(ts),
                       method=method, **_legacy_kwargs(fixed))
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(out)), out

    (_, out_j), (gp, gz) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in _np_params().items()},
        jnp.asarray(_np_z0()))
    tol = TOL if fixed else ADAPTIVE_TOL
    np.testing.assert_allclose(legacy[0].numpy(), np.asarray(out_j), **TOL)
    for k, g in legacy[1].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(gp[k]), err_msg=k,
                                   **tol)
    np.testing.assert_allclose(legacy[2].numpy(), np.asarray(gz), **tol)


def test_odeint_takes_a_solver_instance():
    """``solver=ALF(backend="cuda")`` (the plain path on CPU tensors)
    through Backsolve gives the reference backend's values."""
    out = [_port_grads(lambda p, z, s=s: T.odeint(
        f_torch, p, z, 0.0, 1.0, method="adjoint", solver=s, n_steps=4))
        for s in (T.ALF(backend="cuda"), T.ALF())]
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(), **TOL)
    np.testing.assert_allclose(out[0][2].numpy(), out[1][2].numpy(), **TOL)


@pytest.mark.parametrize("name", ["mali", "naive", "aca", "adjoint"])
def test_kwargs_facades_match_jax(name):
    """odeint_mali / odeint_naive / odeint_aca / odeint_adjoint with
    their own defaults (adaptive) and with n_steps, over a grid."""
    tf = getattr(T, f"odeint_{name}")
    jf = getattr(J, f"odeint_{name}")
    kw = dict(n_steps=5) if name in ("naive", "aca") else {}
    p_t = params_from_numpy(_np_params(), device="cpu")
    p_j = {k: jnp.asarray(v) for k, v in _np_params().items()}
    got = tf(f_torch, p_t, torch.tensor(_np_z0()), ts=TS, **kw)
    want = jf(f_jax, p_j, jnp.asarray(_np_z0()), ts=jnp.asarray(TS), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    end = tf(f_torch, p_t, torch.tensor(_np_z0()), 0.0, 1.0, **kw)
    np.testing.assert_allclose(end.detach().numpy(),
                               np.asarray(jf(f_jax, p_j,
                                             jnp.asarray(_np_z0()), 0.0,
                                             1.0, **kw)), **TOL)


def test_mali_forward_stats_matches_solution_stats_and_jax():
    p_t = params_from_numpy(_np_params(), device="cpu")
    p_j = {k: jnp.asarray(v) for k, v in _np_params().items()}
    sol = T.solve(f_torch, p_t, torch.tensor(_np_z0()), 0.0, 1.0,
                  gradient=T.MALI(),
                  controller=T.AdaptiveController(1e-3, 1e-4, 64))
    zT, n_acc, n_ev = T.mali_forward_stats(f_torch, p_t,
                                           torch.tensor(_np_z0()), 0.0, 1.0,
                                           rtol=1e-3, atol=1e-4)
    assert int(sol.stats.n_accepted) == int(n_acc)
    assert int(sol.stats.n_accepted) + int(sol.stats.n_rejected) == int(n_ev)
    np.testing.assert_array_equal(sol.ys.detach().numpy(), zT.numpy())
    jz, jacc, jev = J.mali_forward_stats(f_jax, p_j, jnp.asarray(_np_z0()),
                                         0.0, 1.0, rtol=1e-3, atol=1e-4)
    assert (int(n_acc), int(n_ev)) == (int(jacc), int(jev))
    np.testing.assert_allclose(zT.numpy(), np.asarray(jz), **TOL)


def test_odeint_deprecation_warning():
    with pytest.warns(DeprecationWarning, match="legacy string-keyed"):
        T.odeint(f_torch, params_from_numpy(_np_params(), device="cpu"),
                 torch.tensor(_np_z0()), n_steps=4)


@pytest.mark.parametrize("kw,match", [
    (dict(method="aca", eta=0.9, n_steps=4), "eta"),
    (dict(method="adjoint", solver="dopri5", eta=0.9, n_steps=4), "eta"),
    (dict(method="naive", fused_bwd=False, n_steps=4), "fused_bwd"),
    (dict(n_steps=-1), "n_steps"),
    (dict(method="nope"), "unknown method"),
    (dict(method="mali", solver="rk4", n_steps=4), "ALF"),
    (dict(method="aca", solver="alf", n_steps=4), "Runge-Kutta"),
], ids=["eta_aca", "eta_dopri5", "fused_bwd", "n_steps", "method",
        "mali_rk4", "aca_alf"])
def test_odeint_kwarg_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        T.odeint(f_torch, params_from_numpy(_np_params(), device="cpu"),
                 torch.tensor(_np_z0()), **kw)


def test_odeint_warns_on_tolerances_with_fixed_steps():
    p = params_from_numpy(_np_params(), device="cpu")
    with pytest.warns(UserWarning, match="fixed-step"):
        T.odeint(f_torch, p, torch.tensor(_np_z0()), n_steps=4, rtol=1e-3)
    out = T.odeint(f_torch, p, torch.tensor(_np_z0()), method="naive",
                   solver="alf", eta=0.9, n_steps=4)
    assert torch.isfinite(out).all()


def test_get_solver_unknown_name_lists_registry():
    with pytest.raises(ValueError, match="registered solver names") as ei:
        T.get_solver("rk45")
    for name in ("alf", "dopri5", "heun_euler"):
        assert name in str(ei.value)


# ---------------------------------------------------------------------------
# OdeSettings.as_objects and ode_block
# ---------------------------------------------------------------------------

def _describe(objs):
    """The lowered objects as comparable plain values, with the JAX
    backend name mapped to the port's."""
    solver, controller, gradient, saveat = objs
    s = (type(solver).__name__, solver.name)
    if hasattr(solver, "eta"):
        s += (solver.eta, {"pallas": "cuda"}.get(solver.backend,
                                                 solver.backend))
    c = (type(controller).__name__,) + tuple(
        getattr(controller, f.name) for f in dataclasses.fields(controller))
    g = (type(gradient).__name__,) + tuple(
        getattr(gradient, f.name) for f in dataclasses.fields(gradient))
    ts = None if saveat.ts is None else np.asarray(saveat.ts).tolist()
    return s, c, g, ts


SETTINGS = [dict(method=m, solver=s, n_steps=n)
            for m in ("mali", "naive", "aca", "adjoint")
            for s in sorted(J.SOLVERS)
            for n in (0, 3)
            if not (m == "mali" and s != "alf")
            and not (m == "aca" and s == "alf")
            and not (n == 0 and not J.SOLVERS[s].has_error_estimate)]


@pytest.mark.parametrize("kw", SETTINGS,
                         ids=[f"{k['method']}-{k['solver']}-{k['n_steps']}"
                              for k in SETTINGS])
def test_ode_settings_as_objects_match_jax(kw):
    extra = dict(eta=0.9, rtol=1e-3, atol=1e-4, max_steps=9,
                 obs_times=(0.0, 0.5, 1.0)) if kw["solver"] == "alf" else {}
    assert _describe(T.OdeSettings(**kw, **extra).as_objects()) == \
        _describe(J.OdeSettings(**kw, **extra).as_objects())


def test_ode_settings_pallas_backend_lowers_to_cuda():
    kw = dict(mode="per_block", method="adjoint", solver="alf", n_steps=4,
              backend="pallas")
    assert _describe(T.OdeSettings(**kw).as_objects()) == \
        _describe(J.OdeSettings(**kw).as_objects())
    assert T.OdeSettings(**kw).as_objects()[0] == T.ALF(backend="cuda")


@pytest.mark.parametrize("method", ["mali", "aca", "adjoint"])
def test_ode_block_equals_solve_and_reverse_block(method):
    solver = "heun_euler" if method == "aca" else "alf"
    settings = T.OdeSettings(mode="per_block", method=method, solver=solver,
                             n_steps=8, t0=1.0, t1=0.0)
    p = params_from_numpy(_np_params(), device="cpu")
    block = T.ode_block(f_torch, settings)
    s, c, g, _ = settings.as_objects()
    direct = T.solve(f_torch, p, torch.tensor(_np_z0()), 1.0, 0.0,
                     solver=s, controller=c, gradient=g).ys
    np.testing.assert_array_equal(block(p, torch.tensor(_np_z0())).numpy(),
                                  direct.numpy())
    jblock = J.ode_block(f_jax, J.OdeSettings(
        mode="per_block", method=method, solver=solver, n_steps=8, t0=1.0,
        t1=0.0))
    np.testing.assert_allclose(
        direct.numpy(), np.asarray(jblock({k: jnp.asarray(v) for k, v in
                                           _np_params().items()},
                                          jnp.asarray(_np_z0()))), **TOL)
