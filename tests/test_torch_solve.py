"""The port's ``solve()`` against the JAX package's on the CPU.

The same numpy parameters and initial state go through
``repro.core.solve`` (reference backend — bit-identical to its Pallas
backend, and fast) and ``repro_torch.core.solve``, across
{MALI, Naive} x {ConstantSteps, AdaptiveController} x {end state,
SaveAt(ts=)} x {forward, reverse time}, and the port's ``cuda`` backend on
CPU tensors (the op layer's plain path). Checked: ``ys``, gradients with
respect to params and z0, and the Stats counters. Step counts must be
identical; values and gradients agree within rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import params_from_numpy
from repro_torch.core import integrate as tint
from repro_torch.kernels.alf_step import alf_step as kernels
from repro_torch.kernels.alf_step import ops as tops

torch.set_num_threads(1)

D, W, B = 3, 8, 4
RTOL, ATOL = 1e-5, 1e-6


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"b1": np.zeros(W, f32), "b2": (0.1 * rng.standard_normal(D)
                                           ).astype(f32),
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


CONTROLLERS = {
    "const": (J.ConstantSteps(6), T.ConstantSteps(6)),
    "adaptive": (J.AdaptiveController(1e-3, 1e-4, 48),
                 T.AdaptiveController(1e-3, 1e-4, 48)),
}
GRADIENTS = {"mali": (J.MALI(), T.MALI()), "naive": (J.Naive(), T.Naive())}
SAVEATS = {"t1": None, "ts": (0.0, 0.35, 0.7, 1.0)}


def _jax_run(gradient, controller, saveat, t0, t1, eta):
    def loss(p, z):
        sol = J.solve(f_jax, p, z, t0, t1, solver=J.ALF(eta=eta),
                      controller=controller, gradient=gradient,
                      saveat=None if saveat is None else
                      J.SaveAt(ts=jnp.asarray(saveat, jnp.float32)))
        return jnp.sum(sol.ys ** 2) + jnp.sum(jnp.sin(sol.ys)), sol

    p = {k: jnp.asarray(v) for k, v in _np_params().items()}
    (_, sol), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(_np_z0()))
    return sol, g


def _compare(jsol, jg, tsol, tgrads, tkeys):
    np.testing.assert_allclose(tsol.ys.detach().numpy(), np.asarray(jsol.ys),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tsol.ts.numpy(), np.asarray(jsol.ts),
                               rtol=0, atol=0)
    for name in ("n_accepted", "n_rejected", "n_fevals"):
        assert int(getattr(tsol.stats, name)) == \
            int(getattr(jsol.stats, name)), name
    assert tsol.stats.n_segments == jsol.stats.n_segments
    assert tsol.stats.residual_bytes == jsol.stats.residual_bytes
    jp, jz = jg
    for k, g in zip(tkeys, tgrads[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tgrads[-1].numpy(), np.asarray(jz),
                               rtol=RTOL, atol=ATOL, err_msg="z0")


def _port(gradient, controller, saveat, t0, t1, eta, backend):
    p = params_from_numpy(_np_params(), device="cpu")
    keys = list(p)
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(), requires_grad=True)
    sol = T.solve(f_torch, p, z, t0, t1,
                  solver=T.ALF(eta=eta, backend=backend),
                  controller=controller, gradient=gradient,
                  saveat=None if saveat is None else T.SaveAt(ts=saveat))
    loss = torch.sum(sol.ys ** 2) + torch.sum(torch.sin(sol.ys))
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [z])
    return sol, grads, keys


def _span(direction, saveat):
    if direction == "fwd":
        return 0.0, 1.0, saveat
    rev = None if saveat is None else tuple(reversed(saveat))
    return 1.0, 0.0, rev


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("save", list(SAVEATS))
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
@pytest.mark.parametrize("grad", ["mali", "naive"])
def test_solve_matches_jax(grad, ctrl, save, direction):
    t0, t1, saveat = _span(direction, SAVEATS[save])
    jsol, jg = _jax_run(GRADIENTS[grad][0], CONTROLLERS[ctrl][0], saveat,
                        t0, t1, 0.9)
    tsol, tg, keys = _port(GRADIENTS[grad][1], CONTROLLERS[ctrl][1], saveat,
                           t0, t1, 0.9, "reference")
    _compare(jsol, jg, tsol, tg, keys)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("save", list(SAVEATS))
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_mali_cuda_backend_on_cpu_matches_jax(ctrl, save, direction):
    """ALF(backend='cuda') on CPU tensors: the kernel op layer (packing,
    the plain versions, the fused backward) against the JAX package."""
    t0, t1, saveat = _span(direction, SAVEATS[save])
    jsol, jg = _jax_run(J.MALI(), CONTROLLERS[ctrl][0], saveat, t0, t1, 1.0)
    tsol, tg, keys = _port(T.MALI(), CONTROLLERS[ctrl][1], saveat, t0, t1,
                           1.0, "cuda")
    _compare(jsol, jg, tsol, tg, keys)


@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_unfused_mali_matches_jax(ctrl):
    t0, t1, saveat = _span("fwd", SAVEATS["ts"])
    jsol, jg = _jax_run(J.MALI(fused_bwd=False), CONTROLLERS[ctrl][0],
                        saveat, t0, t1, 0.9)
    tsol, tg, keys = _port(T.MALI(fused_bwd=False), CONTROLLERS[ctrl][1],
                           saveat, t0, t1, 0.9, "reference")
    _compare(jsol, jg, tsol, tg, keys)


def test_adaptive_records_identical_step_buffers():
    """The recorded (t_i, h_i) replay buffers and per-segment counts of the
    port's grid driver equal the JAX driver's, padding slots included."""
    from repro.core import integrate as jint
    ctrl_j, ctrl_t = CONTROLLERS["adaptive"]
    ts = (0.0, 0.35, 0.7, 1.0)
    pj = {k: jnp.asarray(v) for k, v in _np_params().items()}
    zj = jnp.asarray(_np_z0())
    trial_j = J.ALF(eta=0.9).trial_fn(f_jax, pj, ctrl_j)
    rj = jint.integrate_grid(trial_j, (zj, f_jax(pj, zj, 0.0)),
                             jnp.asarray(ts, jnp.float32),
                             controller=ctrl_j, order=2)
    pt = params_from_numpy(_np_params(), device="cpu")
    zt = torch.tensor(_np_z0())
    grid = tint.as_time_grid(ts)
    trial_t = T.ALF(eta=0.9).trial_fn(f_torch, pt, ctrl_t)
    rt = tint.integrate_grid(trial_t, (zt, f_torch(pt, zt, grid[0])), grid,
                             controller=ctrl_t, order=2)
    np.testing.assert_array_equal(rt.n_accepted.numpy(),
                                  np.asarray(rj.n_accepted))
    assert int(rt.n_trials) == int(rj.n_trials)
    np.testing.assert_allclose(rt.ts.numpy(), np.asarray(rj.ts), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(rt.hs.numpy(), np.asarray(rj.hs), rtol=1e-5,
                               atol=1e-7)
    assert bool(rt.completed) and bool(rj.completed)


def test_budget_exhaustion_is_reported_like_jax():
    """A max_steps budget too small for the span: both drivers stop at the
    same point and flag the segment incomplete."""
    from repro.core import integrate as jint
    pj = {k: jnp.asarray(v) for k, v in _np_params().items()}
    zj = jnp.asarray(_np_z0())
    cj = J.AdaptiveController(1e-6, 1e-7, 5)
    rj = jint.integrate_grid(J.ALF().trial_fn(f_jax, pj, cj),
                             (zj, f_jax(pj, zj, 0.0)),
                             jnp.asarray([0.0, 1.0], jnp.float32),
                             controller=cj, order=2)
    pt = params_from_numpy(_np_params(), device="cpu")
    zt = torch.tensor(_np_z0())
    ct = T.AdaptiveController(1e-6, 1e-7, 5)
    grid = tint.as_time_grid([0.0, 1.0])
    rt = tint.integrate_grid(T.ALF().trial_fn(f_torch, pt, ct),
                             (zt, f_torch(pt, zt, grid[0])), grid,
                             controller=ct, order=2)
    assert not bool(rj.completed) and not bool(rt.completed)
    assert int(rt.n_trials) == int(rj.n_trials) == 5
    np.testing.assert_array_equal(rt.n_accepted.numpy(),
                                  np.asarray(rj.n_accepted))
    np.testing.assert_allclose(rt.state[0].numpy(), np.asarray(rj.state[0]),
                               rtol=RTOL, atol=ATOL)


def test_pytree_state_matches_jax():
    """A dict state {a: (4, 3), b: (5,)}: MALI on the cuda backend packs
    the whole tree into one buffer per op."""
    rng = np.random.default_rng(3)
    za, zb = (rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32))
    pa = rng.standard_normal((3, 3)).astype(np.float32) * 0.4

    def fj(p, z, t):
        return {"a": jnp.tanh(z["a"] @ p["m"]), "b": -p["k"] * z["b"] * t}

    def ft(p, z, t):
        return {"a": torch.tanh(z["a"] @ p["m"]), "b": -p["k"] * z["b"] * t}

    def lj(p, z):
        s = J.solve(fj, p, z, 0.0, 1.0, solver=J.ALF(),
                    controller=J.ConstantSteps(5), gradient=J.MALI())
        return jnp.sum(s.ys["a"] ** 2) + jnp.sum(s.ys["b"] ** 3)

    pj = {"k": jnp.float32(0.7), "m": jnp.asarray(pa)}
    zj = {"a": jnp.asarray(za), "b": jnp.asarray(zb)}
    gj = jax.grad(lj, argnums=(0, 1))(pj, zj)

    pt = {"k": torch.tensor(0.7, requires_grad=True),
          "m": torch.tensor(pa, requires_grad=True)}
    zt = {"a": torch.tensor(za, requires_grad=True),
          "b": torch.tensor(zb, requires_grad=True)}
    s = T.solve(ft, pt, zt, 0.0, 1.0, solver=T.ALF(backend="cuda"),
                controller=T.ConstantSteps(5), gradient=T.MALI())
    loss = torch.sum(s.ys["a"] ** 2) + torch.sum(s.ys["b"] ** 3)
    loss.backward()
    for k in ("k", "m"):
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(gj[0][k]),
                                   rtol=RTOL, atol=ATOL)
    for k in ("a", "b"):
        np.testing.assert_allclose(zt[k].grad.numpy(), np.asarray(gj[1][k]),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Launch accounting and saved-tensor memory
# ---------------------------------------------------------------------------

def _setup(rows=B):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(np.random.default_rng(9).standard_normal(
        (rows, D)).astype(np.float32))
    return p, z


def test_op_calls_two_per_forward_and_two_per_backward_step():
    """ALF(backend='cuda') + MALI: 2 op calls (midpoint, update) per
    forward step and 2 (bwd_pre, bwd_post) per backward step, as the JAX
    package's launch count asserts; no backward-sweep op in the forward."""
    n, ts = 5, (0.0, 0.5, 1.0)
    p, z = _setup()
    tops.reset_op_calls()
    sol = T.solve(f_torch, p, z, solver=T.ALF(backend="cuda"),
                  controller=T.ConstantSteps(n), gradient=T.MALI(),
                  saveat=T.SaveAt(ts=ts))
    steps = n * (len(ts) - 1)
    rest = {"alf_midpoint_vjp": 0, "alf_update_vjp": 0, "alf_inverse": 0,
            "alf_inverse_update": 0}
    assert tops.OP_CALLS == {"alf_midpoint": steps, "alf_update": steps,
                             "alf_bwd_pre": 0, "alf_bwd_post": 0, **rest}
    torch.sum(sol.ys ** 2).backward()
    assert tops.OP_CALLS == {"alf_midpoint": steps, "alf_update": steps,
                             "alf_bwd_pre": steps, "alf_bwd_post": steps,
                             **rest}
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_reference_backend_calls_no_kernel_op():
    p, z = _setup()
    tops.reset_op_calls()
    sol = T.solve(f_torch, p, z, solver=T.ALF(),
                  controller=T.ConstantSteps(4), gradient=T.MALI())
    torch.sum(sol.ys).backward()
    assert all(v == 0 for v in tops.OP_CALLS.values())


def _saved_bytes(gradient, n_steps, backend="reference"):
    p, z = _setup(rows=256)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        sol = T.solve(f_torch, p, z, solver=T.ALF(backend=backend),
                      controller=T.ConstantSteps(n_steps), gradient=gradient)
        loss = torch.sum(sol.ys ** 2)
    torch.autograd.grad(loss, list(p.values()))
    return sum(saved)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_mali_saved_bytes_flat_in_steps(backend):
    """MALI saves the per-observation (z, v) pairs, params and the
    (t_i, h_i) buffers: from 8 to 64 steps only the 2 x 56 recorded f32
    scalars are added, whatever the state size."""
    b8 = _saved_bytes(T.MALI(), 8, backend)
    b64 = _saved_bytes(T.MALI(), 64, backend)
    assert b64 - b8 == 2 * (64 - 8) * 4
    assert b64 / b8 <= 1.05


def test_naive_saved_bytes_grow_with_steps():
    b8 = _saved_bytes(T.Naive(), 8)
    b64 = _saved_bytes(T.Naive(), 64)
    m64 = _saved_bytes(T.MALI(), 64)
    assert b64 / b8 > 6.0
    assert b64 > 10 * m64


def test_naive_cuda_backend_saves_no_more_than_reference():
    """The reverse rules save h, and the state only where h needs a
    gradient: under ConstantSteps Naive on the cuda backend keeps no more
    bytes alive for backward than autograd through the plain step."""
    for n in (8, 64):
        assert (_saved_bytes(T.Naive(), n, "cuda")
                <= _saved_bytes(T.Naive(), n, "reference"))


# ---------------------------------------------------------------------------
# Axes of the JAX package that later slices port
# ---------------------------------------------------------------------------

def _plain_solve(**kw):
    p, z = _setup()
    kw = {"t0": 0.0, "t1": 1.0, "controller": T.ConstantSteps(4), **kw}
    return T.solve(f_torch, p, z, **kw)


@pytest.mark.parametrize("case", ["batching", "sharded"])
def test_unported_axes_raise(case):
    """The batching axes the port once refused, on this file's MLP field:
    ``PerSample()`` under ConstantSteps(4) warns as the JAX package does
    and equals its ys and per-row counters; ``Sharded()`` with no active
    mesh raises the JAX package's ValueError."""
    p, z = _setup()
    jp = {k: jnp.asarray(v) for k, v in _np_params().items()}
    jkw = dict(t0=0.0, t1=1.0, controller=J.ConstantSteps(4))
    if case == "sharded":
        with pytest.raises(ValueError, match="mesh context"):
            J.solve(f_jax, jp, jnp.asarray(z.numpy()),
                    batching=J.Sharded(), **jkw)
        with pytest.raises(ValueError, match="mesh context"):
            _plain_solve(batching=T.Sharded())
        return
    with pytest.warns(UserWarning, match="degenerates to"):
        want = J.solve(f_jax, jp, jnp.asarray(z.numpy()),
                       batching=J.PerSample(), **jkw)
    with pytest.warns(UserWarning, match="degenerates to"):
        got = _plain_solve(batching=T.PerSample())
    np.testing.assert_allclose(got.ys.detach().numpy(), np.asarray(want.ys),
                               rtol=RTOL, atol=ATOL)
    for c_t, c_j in zip(got.stats.per_sample, want.stats.per_sample):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("bad", [
    lambda: T.ALF(eta=0.5), lambda: T.ALF(eta=0.0),
    lambda: T.ALF(backend="pallas"), lambda: T.ConstantSteps(0),
    lambda: T.AdaptiveController(-1.0), lambda: T.AdaptiveController(
        max_steps=0),
    lambda: _plain_solve(t1=0.0), lambda: _plain_solve(
        saveat=T.SaveAt(ts=(0.0, 0.5, 0.4))),
    lambda: T.get_solver("nope"),
], ids=["eta_half", "eta_zero", "backend", "steps0", "rtol", "budget",
        "empty_span", "non_monotonic", "unknown_solver"])
def test_invalid_arguments_raise_value_error(bad):
    with pytest.raises(ValueError):
        bad()


def test_error_ratio_safe_sqrt_keeps_gradients_finite():
    """An exactly-zero error estimate (a trial where f == v) must give a
    zero, not NaN, gradient: Naive differentiates through the ratio."""
    from repro_torch.core.stepsize import error_ratio
    err = torch.zeros(4, requires_grad=True)
    z = torch.ones(4, requires_grad=True)
    r = error_ratio(err, z, z, 1e-3, 1e-4)
    g_err, g_z = torch.autograd.grad(r, [err, z])
    assert float(r.detach()) == 0.0
    assert torch.isfinite(g_err).all() and torch.isfinite(g_z).all()
