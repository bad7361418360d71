"""The port's ACA and Backsolve against the JAX package's on the CPU.

The same numpy inputs go through ``repro.core`` and ``repro_torch.core``:
ys, gradients (params, z0) and ``Stats`` of ACA (Runge-Kutta tableaus)
and Backsolve (Dopri5, and ALF on both of the port's backends) under both
controllers and in both time directions, on an array and a pytree state;
the analytic ``residual_bytes``; the bytes each method saves for backward
(``saved_tensors_hooks``: ACA grows with the steps, Backsolve is flat,
Naive > ACA > MALI at 64 steps); the op calls of Backsolve on the cuda
backend; and the Thm 2.1 analog (MALI reverse-accurate, Backsolve
drifting). f32 values and gradients agree within rtol 1e-5 (adaptive:
rtol 2e-4 / atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import params_from_numpy
from repro_torch.kernels.alf_step import ops as tops

torch.set_num_threads(1)

D, W, B = 3, 8, 4
TOL = dict(rtol=1e-5, atol=1e-6)
ADAPTIVE_TOL = dict(rtol=2e-4, atol=2e-5)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"b1": np.zeros(W, f32),
            "b2": (0.1 * rng.standard_normal(D)).astype(f32),
            "bt": np.full(W, 0.3, f32),
            "w1": (0.5 * rng.standard_normal((D, W))).astype(f32),
            "w2": (0.5 * rng.standard_normal((W, D))).astype(f32)}


def _np_z0(seed=1, rows=B):
    return np.random.default_rng(seed).standard_normal((rows, D)).astype(
        np.float32)


def f_jax(p, z, t):
    return jnp.tanh(z @ p["w1"] + p["b1"] + t * p["bt"]) @ p["w2"] + p["b2"]


def f_torch(p, z, t):
    return torch.tanh(z @ p["w1"] + p["b1"] + t * p["bt"]) @ p["w2"] + p["b2"]


def _controllers(kind):
    if kind == "const":
        return J.ConstantSteps(5), T.ConstantSteps(5)
    return (J.AdaptiveController(1e-3, 1e-4, 48),
            T.AdaptiveController(1e-3, 1e-4, 48))


GRIDS = {"fwd": (0.0, 0.4, 1.0), "rev": (1.0, 0.55, 0.0)}


def _jax_solve(gradient, solver, controller, grid):
    def loss(p, z):
        s = J.solve(f_jax, p, z, solver=solver, controller=controller,
                    gradient=gradient,
                    saveat=J.SaveAt(ts=jnp.asarray(grid, jnp.float32)))
        return jnp.sum(s.ys ** 2) + jnp.sum(jnp.sin(s.ys)), s

    p = {k: jnp.asarray(v) for k, v in _np_params().items()}
    (_, sol), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(_np_z0()))
    return sol, g


def _port_solve(gradient, solver, controller, grid):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(), requires_grad=True)
    sol = T.solve(f_torch, p, z, solver=solver, controller=controller,
                  gradient=gradient, saveat=T.SaveAt(ts=grid))
    loss = torch.sum(sol.ys ** 2) + torch.sum(torch.sin(sol.ys))
    keys = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [z])
    return sol, dict(zip(keys, grads[:-1])), grads[-1]


def _compare(jax_run, port_run, tol):
    (jsol, (jp, jz)), (tsol, tp, tz) = jax_run, port_run
    np.testing.assert_allclose(tsol.ys.detach().numpy(), np.asarray(jsol.ys),
                               **TOL)
    for name in ("n_accepted", "n_rejected", "n_fevals"):
        assert int(getattr(tsol.stats, name)) == \
            int(getattr(jsol.stats, name)), name
    assert tsol.stats.residual_bytes == jsol.stats.residual_bytes
    for k, g in tp.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jp[k]), err_msg=k,
                                   **tol)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), err_msg="z0",
                               **tol)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("solver,kind", [
    ("heun_euler", "const"), ("heun_euler", "adaptive"), ("rk4", "const"),
    ("dopri5", "adaptive")])
def test_aca_matches_jax(solver, kind, grid):
    cj, ct = _controllers(kind)
    _compare(_jax_solve(J.ACA(), solver, cj, GRIDS[grid]),
             _port_solve(T.ACA(), solver, ct, GRIDS[grid]),
             TOL if kind == "const" else ADAPTIVE_TOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("solver,kind", [
    ("dopri5", "const"), ("dopri5", "adaptive"), ("alf", "const"),
    ("alf_cuda", "const"), ("alf_cuda", "adaptive"), ("bosh3", "adaptive")])
def test_backsolve_matches_jax(solver, kind, grid):
    """Backsolve with Dopri5 and with ALF(eta=0.9): the cuda backend is
    the kernel op layer's plain path on CPU tensors, its reverse solve
    packing the aug state (z, a, g_params) into one buffer per op."""
    cj, ct = _controllers(kind)
    js, ts_ = solver, solver
    if solver.startswith("alf"):
        js = J.ALF(eta=0.9)
        ts_ = T.ALF(eta=0.9, backend="cuda" if solver == "alf_cuda"
                    else "reference")
    _compare(_jax_solve(J.Backsolve(), js, cj, GRIDS[grid]),
             _port_solve(T.Backsolve(), ts_, ct, GRIDS[grid]),
             TOL if kind == "const" else ADAPTIVE_TOL)


def _tree_problem():
    rng = np.random.default_rng(3)
    za = rng.standard_normal((4, 3)).astype(np.float32)
    zb = rng.standard_normal(5).astype(np.float32)
    pm = (0.4 * rng.standard_normal((3, 3))).astype(np.float32)

    def fj(p, z, t):
        return {"a": jnp.tanh(z["a"] @ p["m"]), "b": -p["k"] * z["b"] * t}

    def ft(p, z, t):
        return {"a": torch.tanh(z["a"] @ p["m"]), "b": -p["k"] * z["b"] * t}

    return za, zb, pm, fj, ft


@pytest.mark.parametrize("method,solver", [
    ("aca", "dopri5"), ("adjoint", "dopri5"), ("adjoint", "alf_cuda")])
def test_pytree_state_matches_jax(method, solver):
    """A dict state {a: (4, 3), b: (5,)} and dict params (keys inserted
    sorted, so both packages flatten them in one order)."""
    za, zb, pm, fj, ft = _tree_problem()
    gj = J.ACA() if method == "aca" else J.Backsolve()
    gt = T.ACA() if method == "aca" else T.Backsolve()
    sj = J.ALF() if solver == "alf_cuda" else solver
    st = T.ALF(backend="cuda") if solver == "alf_cuda" else solver

    def lj(p, z):
        s = J.solve(fj, p, z, 0.0, 1.0, solver=sj,
                    controller=J.ConstantSteps(5), gradient=gj)
        return jnp.sum(s.ys["a"] ** 2) + jnp.sum(s.ys["b"] ** 3)

    g_p, g_z = jax.grad(lj, argnums=(0, 1))(
        {"k": jnp.float32(0.7), "m": jnp.asarray(pm)},
        {"a": jnp.asarray(za), "b": jnp.asarray(zb)})
    pt = {"k": torch.tensor(0.7, requires_grad=True),
          "m": torch.tensor(pm, requires_grad=True)}
    zt = {"a": torch.tensor(za, requires_grad=True),
          "b": torch.tensor(zb, requires_grad=True)}
    s = T.solve(ft, pt, zt, 0.0, 1.0, solver=st,
                controller=T.ConstantSteps(5), gradient=gt)
    (torch.sum(s.ys["a"] ** 2) + torch.sum(s.ys["b"] ** 3)).backward()
    for k in ("k", "m"):
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g_p[k]),
                                   err_msg=k, **TOL)
    for k in ("a", "b"):
        np.testing.assert_allclose(zt[k].grad.numpy(), np.asarray(g_z[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("method,solver,kind", [
    (m, s, k) for m, s in (("mali", "alf"), ("naive", "alf"),
                           ("naive", "rk4"), ("aca", "bosh3"),
                           ("aca", "heun_euler"), ("adjoint", "dopri5"),
                           ("adjoint", "alf"))
    for k in ("const", "adaptive") if (s, k) != ("rk4", "adaptive")])
def test_residual_bytes_equal_jax(method, solver, kind):
    cj, ct = _controllers(kind)
    gj = {"mali": J.MALI(), "naive": J.Naive(), "aca": J.ACA(),
          "adjoint": J.Backsolve()}[method]
    gt = {"mali": T.MALI(), "naive": T.Naive(), "aca": T.ACA(),
          "adjoint": T.Backsolve()}[method]
    z = _np_z0(rows=7)
    for n_obs in (2, 5):
        assert gt.residual_bytes(torch.tensor(z), n_obs, T.get_solver(solver),
                                 ct) == gj.residual_bytes(
            jnp.asarray(z), n_obs, J.get_solver(solver), cj)


# ---------------------------------------------------------------------------
# Saved bytes for backward (the paper's Table 1 memory column, on the CPU)
# ---------------------------------------------------------------------------

def _saved_bytes(gradient, solver, n_steps, rows=256):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(seed=9, rows=rows))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        sol = T.solve(f_torch, p, z, solver=solver,
                      controller=T.ConstantSteps(n_steps), gradient=gradient)
        loss = torch.sum(sol.ys ** 2)
    torch.autograd.grad(loss, list(p.values()))
    return sum(saved)


@pytest.mark.parametrize("solver", ["heun_euler", "dopri5"])
def test_aca_saved_bytes_grow_with_steps(solver):
    """ACA saves every step's start state: from 8 to 64 steps its saved
    bytes grow by the 56 extra checkpointed states and their (t, h)."""
    b8 = _saved_bytes(T.ACA(), solver, 8)
    b64 = _saved_bytes(T.ACA(), solver, 64)
    state = 256 * D * 4
    assert b64 - b8 == (64 - 8) * (state + 2 * 4)
    assert b64 / b8 > 2.0


@pytest.mark.parametrize("solver", ["dopri5", "alf", "alf_cuda"])
def test_backsolve_saved_bytes_flat_in_steps(solver):
    """Backsolve saves the observation states, params and ts only: the
    same bytes at 8 and 64 steps."""
    sv = T.ALF(backend="cuda") if solver == "alf_cuda" else solver
    assert _saved_bytes(T.Backsolve(), sv, 8) == \
        _saved_bytes(T.Backsolve(), sv, 64)


def test_table1_memory_ordering_at_64_steps():
    """Naive > ACA > MALI in saved bytes at 64 steps (the JAX package's
    tests/test_memory_invariance.py ordering), with Naive and ACA on the
    same tableau, and Backsolve below ACA."""
    naive = _saved_bytes(T.Naive(), "heun_euler", 64)
    aca = _saved_bytes(T.ACA(), "heun_euler", 64)
    mali = _saved_bytes(T.MALI(), "alf", 64)
    back = _saved_bytes(T.Backsolve(), "alf", 64)
    assert naive > aca > mali, (naive, aca, mali)
    assert back < aca


# ---------------------------------------------------------------------------
# Op calls of Backsolve on the cuda backend; ACA calls none
# ---------------------------------------------------------------------------

def test_backsolve_cuda_op_calls_per_step():
    """ALF(backend='cuda') + Backsolve: 2 op calls (midpoint, update) per
    forward step and 2 per step of the reverse augmented solve, one call
    for the whole (z, a, g_params) tree; no reverse rule and no backward-
    sweep op (both solves run grad-free)."""
    n, grid = 4, (0.0, 0.5, 1.0)
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    tops.reset_op_calls()
    sol = T.solve(f_torch, p, torch.tensor(_np_z0()),
                  solver=T.ALF(backend="cuda"), controller=T.ConstantSteps(n),
                  gradient=T.Backsolve(), saveat=T.SaveAt(ts=grid))
    steps = n * (len(grid) - 1)
    rest = {k: 0 for k in tops.OP_CALLS if k not in ("alf_midpoint",
                                                     "alf_update")}
    assert tops.OP_CALLS == {"alf_midpoint": steps, "alf_update": steps,
                             **rest}
    torch.sum(sol.ys ** 2).backward()
    assert tops.OP_CALLS == {"alf_midpoint": 2 * steps,
                             "alf_update": 2 * steps, **rest}


def test_aca_and_rk_naive_call_no_kernel_op():
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    tops.reset_op_calls()
    for gradient in (T.ACA(), T.Naive()):
        sol = T.solve(f_torch, p, torch.tensor(_np_z0()),
                      solver=T.HeunEuler(), controller=T.ConstantSteps(4),
                      gradient=gradient)
        torch.sum(sol.ys).backward()
    assert all(v == 0 for v in tops.OP_CALLS.values())


def test_aca_refuses_alf():
    with pytest.raises(ValueError, match="Runge-Kutta"):
        T.solve(f_torch, params_from_numpy(_np_params(), device="cpu"),
                torch.tensor(_np_z0()), solver=T.ALF(),
                controller=T.ConstantSteps(4), gradient=T.ACA())


# ---------------------------------------------------------------------------
# Thm 2.1 analog (tests/test_reverse_time.py:155)
# ---------------------------------------------------------------------------

def _thm21_grad(gradient, solver):
    a = torch.tensor(8.0, requires_grad=True)
    sol = T.solve(lambda p, z, t: -p["a"] * z, {"a": a}, torch.ones(3),
                  0.0, 1.0, solver=solver, controller=T.ConstantSteps(128),
                  gradient=gradient)
    (g,) = torch.autograd.grad(torch.sum(sol.ys), [a])
    return float(g)


def _thm21_jax_backsolve():
    def loss(p):
        return jnp.sum(J.solve(lambda q, z, t: -q["a"] * z, p, jnp.ones(3),
                               0.0, 1.0, solver=J.ALF(eta=0.9),
                               controller=J.ConstantSteps(128),
                               gradient=J.Backsolve()).ys)

    return float(jax.grad(loss)({"a": jnp.float32(8.0)})["a"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_thm21_mali_exact_backsolve_drifts(backend):
    """Stiff decay a=8, ALF(eta=0.9), 128 steps: Naive on the reference
    backend is the exact discrete gradient; MALI reproduces it, Backsolve
    drifts by orders of magnitude more (paper Thm 2.1), and its drift is
    the JAX package's."""
    solver = T.ALF(eta=0.9, backend=backend)
    g_naive = _thm21_grad(T.Naive(), T.ALF(eta=0.9))
    g_mali = _thm21_grad(T.MALI(), solver)
    g_back = _thm21_grad(T.Backsolve(), solver)
    ref = abs(g_naive)
    assert ref > 0
    rel_mali = abs(g_mali - g_naive) / ref
    rel_back = abs(g_back - g_naive) / ref
    assert rel_mali < 1e-4, rel_mali
    assert rel_back > 1e-3, rel_back
    assert rel_back > 100 * rel_mali, (rel_mali, rel_back)
    np.testing.assert_allclose(g_back, _thm21_jax_backsolve(), rtol=1e-5)
