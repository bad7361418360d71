"""Direct backprop through the port's ALF kernel ops, on the CPU, against
the JAX package's Pallas path (interpret mode, as
tests/test_pallas_backward.py runs it).

Covers what ``ALF(backend="cuda")`` now offers every gradient consumer:

* autograd through ``alf_midpoint``/``alf_update`` (the reverse rules, h's
  cotangent included) against ``jax.vjp`` of the JAX ops, over f32, bf16,
  a mixed {f32, bf16} tree and f64; ``gradcheck`` in f64;
  ``torch.func.vjp``, with the launchers seeing plain tensors;
* ``Naive()`` and ``MALI(fused_bwd=False)`` on the cuda backend against
  their JAX counterparts on the pallas backend;
* ``SaveAt(steps=True)`` and ``SaveAt(dense=True)`` (``evaluate``);
* the reverse-rule registry and its refusal of a forward-only step op;
* op-call counts of one Naive and one unfused MALI step.

On CPU tensors the ops run their plain versions; ``chip_smoke.py`` holds
the CUDA kernels against those on the card. Tolerances: f32 rtol 1e-5 /
atol 1e-6; bf16 one bf16 ulp relative (2**-7); f64 rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.core as J
import repro_torch.core as T
from repro.kernels.alf_step import ops as jops
from repro_torch import params_from_numpy
from repro_torch.kernels.alf_step import alf_step as kernels
from repro_torch.kernels.alf_step import ops as tops
from repro_torch.kernels.alf_step import ref as tref

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TOL = {"f32": dict(rtol=RTOL, atol=ATOL),
       "bf16": dict(rtol=2.0 ** -7, atol=1e-6),
       "mixed": dict(rtol=2.0 ** -7, atol=1e-6),
       "f64": dict(rtol=1e-12, atol=1e-14)}


# ---------------------------------------------------------------------------
# The ops' reverse rules against jax.vjp of the JAX ops
# ---------------------------------------------------------------------------

def _np_trees(n, seed):
    # keys in sorted order: JAX flattens dicts by sorted key
    rng = np.random.default_rng(seed)
    return [{"a": rng.standard_normal((3, 70)), "b": rng.standard_normal(45)}
            for _ in range(n)]


def _leaf_dtypes(kind):
    return {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
            "mixed": ("float32", "bfloat16"),
            "f64": ("float64", "float64")}[kind]


def _torch_tree(t, kind, grad=False):
    da, db = (getattr(torch, d) for d in _leaf_dtypes(kind))
    out = {"a": torch.tensor(t["a"]).to(da), "b": torch.tensor(t["b"]).to(db)}
    return {k: v.requires_grad_(grad) for k, v in out.items()}


def _jax_tree(t, kind):
    da, db = (getattr(jnp, d) for d in _leaf_dtypes(kind))
    return {"a": jnp.asarray(t["a"]).astype(da),
            "b": jnp.asarray(t["b"]).astype(db)}


def _assert_close(got, want, kind):
    for g, w in zip(pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                             w.dtype)
        np.testing.assert_allclose(g.detach().double().numpy(),
                                   np.asarray(w, np.float64), **TOL[kind])


def _op_grads(op, n_in, kind, param, h=0.23, seed=0):
    """d(op)/d(inputs, h) under torch.autograd.grad and jax.vjp, the same
    cotangents fed to both."""
    x64 = kind == "f64"
    if x64:
        jax.config.update("jax_enable_x64", True)
    try:
        trees = _np_trees(n_in, seed)
        n_out = 1 if op == "alf_midpoint" else 2
        cots = _np_trees(n_out, seed + 1)
        key = "sign" if op == "alf_midpoint" else "eta"
        hd = torch.float64 if x64 else torch.float32
        tin = [_torch_tree(t, kind, grad=True) for t in trees]
        th = torch.tensor(h, dtype=hd, requires_grad=True)
        out = getattr(tops, op)(*tin, th, **{key: param})
        outs = out if isinstance(out, tuple) else (out,)
        tg = torch.autograd.grad(
            [l for o in outs for l in pytree.tree_leaves(o)],
            [l for t in tin for l in pytree.tree_leaves(t)] + [th],
            grad_outputs=[l for c in cots
                          for l in pytree.tree_leaves(_torch_tree(c, kind))])
        jin = [_jax_tree(t, kind) for t in trees]
        jh = jnp.asarray(h, jnp.float64 if x64 else jnp.float32)

        def fn(*args):
            return getattr(jops, op)(*args, **{key: param}, use_pallas=True)

        jout, vjp_fn = jax.vjp(fn, *jin, jh)
        jcot = [_jax_tree(c, kind) for c in cots]
        jg = vjp_fn(jcot[0] if n_out == 1 else tuple(jcot))
        return outs, jout, tg, jg
    finally:
        if x64:
            jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed", "f64"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_midpoint_grads_match_jax(kind, sign):
    outs, jout, tg, jg = _op_grads("alf_midpoint", 2, kind, sign)
    _assert_close(outs[0], jout, kind)
    _assert_close(list(tg[:-1]), list(jg[:-1]), kind)
    # h's cotangent: (sign/2) * <v, g>, one reduction at h's dtype
    np.testing.assert_allclose(float(tg[-1]), float(jg[-1]), **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16", "mixed", "f64"])
@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_update_grads_match_jax(kind, eta):
    outs, jout, tg, jg = _op_grads("alf_update", 3, kind, eta, h=-0.17)
    _assert_close(list(outs), list(jout), kind)
    _assert_close(list(tg[:-1]), list(jg[:-1]), kind)
    # h_bar = <v_out, g_z>/2. On a mixed tree the port reduces over the
    # packed f32 v_out, JAX over the leaves' stored (bf16-rounded) v_out.
    tol = TOL["bf16"] if kind == "mixed" else TOL[kind]
    np.testing.assert_allclose(float(tg[-1]), float(jg[-1]), **tol)


def _f64_inputs(n, seed=2):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 7, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(n)]


def test_gradcheck_midpoint_and_update_in_f64():
    z, v = _f64_inputs(2)
    h = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda z, v, h: tops.alf_midpoint(z, v, h, sign=-1.0), (z, v, h))
    k1, v, u1 = _f64_inputs(3, seed=3)
    assert torch.autograd.gradcheck(
        lambda k1, v, u1, h: tops.alf_update(k1, v, u1, h, eta=0.9),
        (k1, v, u1, h))


def test_reverse_rules_are_once_differentiable():
    z, v = _f64_inputs(2)
    k1 = tops.alf_midpoint(z, v, torch.tensor(0.3, dtype=torch.float64))
    g = torch.ones_like(k1, requires_grad=True)
    (gv,) = torch.autograd.grad(k1, [v], grad_outputs=g, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gv.sum().backward()


def test_torch_func_vjp_through_both_ops():
    """torch.func.vjp (what the unfused MALI replay uses) gives the same
    cotangents as torch.autograd.grad."""
    z, v, u = (x.detach().float() for x in _f64_inputs(3, seed=4))
    h = torch.tensor(-0.2)
    g = torch.randn(2, 7, generator=torch.Generator().manual_seed(5))

    def step(z, v, u, h):
        k1 = tops.alf_midpoint(z, v, h)
        return tops.alf_update(k1, v, u, h, eta=0.9)

    (zo, vo), vjp_fn = torch.func.vjp(step, z, v, u, h)
    got = vjp_fn((g, 2 * g))
    leaves = [x.clone().requires_grad_(True) for x in (z, v, u, h)]
    want = torch.autograd.grad(step(*leaves), leaves,
                               grad_outputs=(g, 2 * g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launchers_get_plain_tensors_under_torch_func(monkeypatch):
    """Inside torch.func.vjp the Functions' forward and backward receive
    plain tensors with storage, so the launchers' data_ptr() is valid.
    Shown with stand-in launchers that read data_ptr() on CPU tensors."""
    seen = []

    def plain_only(fn):
        def launcher(*bufs, **kw):
            for b in bufs:
                assert not torch._C._functorch.is_functorch_wrapped_tensor(b)
                b.data_ptr()
            seen.append(fn.__name__)
            return fn(*bufs, *kw.values())
        return launcher

    monkeypatch.setattr(tops, "_on_cuda", lambda name, dev: True)
    for call, fn in (("midpoint_call", tref.midpoint_ref),
                     ("update_call", tref.update_ref),
                     ("midpoint_vjp_call", tref.midpoint_vjp_ref),
                     ("update_vjp_call", tref.update_vjp_ref)):
        monkeypatch.setattr(kernels, call, plain_only(fn))
    z, v, u = (torch.randn(6) for _ in range(3))
    h = torch.tensor(0.1)

    def step(z, v):
        k1 = tops.alf_midpoint(z, v, h)
        return tops.alf_update(k1, v, u, h)

    _, vjp_fn = torch.func.vjp(step, z, v)
    vjp_fn((torch.ones(6), torch.ones(6)))
    assert seen == ["midpoint_ref", "update_ref", "update_vjp_ref",
                    "midpoint_vjp_ref"]


def test_h_cotangent_only_when_h_needs_it():
    """With a constant h (ConstantSteps) the rules skip the reduction and
    return no h cotangent; a v that needs no gradient skips the kernel."""
    z = torch.randn(5, requires_grad=True)
    v = torch.randn(5)
    h = torch.tensor(0.2)
    tops.reset_op_calls()
    k1 = tops.alf_midpoint(z, v, h)
    (gz,) = torch.autograd.grad(k1.sum(), [z])
    assert torch.equal(gz, torch.ones(5))
    assert tops.OP_CALLS["alf_midpoint_vjp"] == 0


# ---------------------------------------------------------------------------
# Gradient consumers on the cuda backend against the JAX pallas backend
# ---------------------------------------------------------------------------

D, W, B = 3, 8, 4


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


CONTROLLERS = {
    "const": (J.ConstantSteps(6), T.ConstantSteps(6)),
    "adaptive": (J.AdaptiveController(1e-3, 1e-4, 48),
                 T.AdaptiveController(1e-3, 1e-4, 48)),
}
GRID = (0.0, 0.35, 0.7, 1.0)


def _readout(sol, mode, xp):
    if mode == "dense":
        return sol.evaluate(xp.asarray(np.array([0.37, 0.8, 0.05],
                                                np.float32)))
    return sol.ys


def _jax(gradient, controller, saveat, t0, t1, mode="ys", eta=0.9):
    def loss(p, z):
        sol = J.solve(f_jax, p, z, t0, t1,
                      solver=J.ALF(eta=eta, backend="pallas"),
                      controller=controller, gradient=gradient,
                      saveat=saveat)
        y = _readout(sol, mode, jnp)
        return jnp.sum(y ** 2) + jnp.sum(jnp.sin(y)), (sol, y)

    p = {k: jnp.asarray(v) for k, v in _np_params().items()}
    (_, (sol, y)), g = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(p, jnp.asarray(
                                              _np_z0()))
    return sol, y, g


def _port(gradient, controller, saveat, t0, t1, mode="ys", eta=0.9):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(), requires_grad=True)
    sol = T.solve(f_torch, p, z, t0, t1,
                  solver=T.ALF(eta=eta, backend="cuda"),
                  controller=controller, gradient=gradient, saveat=saveat)
    y = _readout(sol, mode, torch)
    loss = torch.sum(y ** 2) + torch.sum(torch.sin(y))
    keys = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [z])
    return sol, y, dict(zip(keys + ["z0"], grads))


def _compare(jax_run, port_run, counters=True, grad_tol=None):
    jsol, jy, (jp, jz) = jax_run
    tsol, ty, tg = port_run
    grad_tol = grad_tol or dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    if counters:
        for name in ("n_accepted", "n_rejected", "n_fevals"):
            assert int(getattr(tsol.stats, name)) == \
                int(getattr(jsol.stats, name)), name
        assert tsol.stats.residual_bytes == jsol.stats.residual_bytes
    for k, g in tg.items():
        want = jz if k == "z0" else jp[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=k,
                                   **grad_tol)


def _span(direction, saveat):
    if direction == "fwd":
        return 0.0, 1.0, saveat
    return 1.0, 0.0, None if saveat is None else tuple(reversed(saveat))


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("save", ["t1", "ts"])
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_naive_cuda_matches_jax_naive_pallas(ctrl, save, direction):
    """Naive x ALF('cuda') against JAX Naive x ALF('pallas'), eta=0.9. Under
    AdaptiveController both differentiate through the step sizes, so h's
    cotangent is in the gradients."""
    t0, t1, grid = _span(direction, GRID if save == "ts" else None)
    jc, tc = CONTROLLERS[ctrl]
    _compare(_jax(J.Naive(), jc, None if grid is None else J.SaveAt(
                 ts=jnp.asarray(grid, jnp.float32)), t0, t1),
             _port(T.Naive(), tc, None if grid is None else T.SaveAt(
                 ts=grid), t0, t1))


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_unfused_mali_cuda_matches_jax(ctrl, direction):
    t0, t1, grid = _span(direction, GRID)
    jc, tc = CONTROLLERS[ctrl]
    _compare(_jax(J.MALI(fused_bwd=False), jc,
                  J.SaveAt(ts=jnp.asarray(grid, jnp.float32)), t0, t1),
             _port(T.MALI(fused_bwd=False), tc, T.SaveAt(ts=grid), t0, t1))


def test_naive_cuda_is_the_mali_oracle_in_the_port():
    """Naive and MALI run the identical forward on the cuda backend, so
    their gradients agree (the JAX package's bar for the pair)."""
    t0, t1, grid = _span("fwd", GRID)
    tc = CONTROLLERS["const"][1]
    _, _, gn = _port(T.Naive(), tc, T.SaveAt(ts=grid), t0, t1)
    _, _, gm = _port(T.MALI(), tc, T.SaveAt(ts=grid), t0, t1)
    for k in gn:
        np.testing.assert_allclose(gn[k].numpy(), gm[k].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_saveat_steps_matches_jax(ctrl, direction):
    """SaveAt(steps=True): the padded per-step buffer (zero rows past the
    live ones), its times, n_live, step_mask and the gradients."""
    t0, t1, _ = _span(direction, None)
    jc, tc = CONTROLLERS[ctrl]
    jrun = _jax(J.Naive(), jc, J.SaveAt(steps=True), t0, t1)
    trun = _port(T.Naive(), tc, T.SaveAt(steps=True), t0, t1)
    # Under adaptive control every recorded state is an output, so the
    # loss moves with each step size and the gradient runs through the
    # controller's error ratios: the JAX package's own pallas and
    # reference backends differ there by up to 7e-5 relative. Gradients
    # are held to the repo's MALI-vs-Naive bar (tests/test_core_gradients
    # .py:76) in that case; values, times and counts stay exact or 1e-5.
    _compare(jrun, trun, grad_tol=dict(rtol=2e-4, atol=2e-5)
             if ctrl == "adaptive" else None)
    jsol, tsol = jrun[0], trun[0]
    np.testing.assert_allclose(tsol.ts.detach().numpy(), np.asarray(jsol.ts),
                               rtol=RTOL, atol=ATOL)
    assert int(tsol.n_live) == int(jsol.n_live)
    assert int(tsol.num_steps) == int(jsol.num_steps)
    np.testing.assert_array_equal(tsol.step_mask.numpy(),
                                  np.asarray(jsol.step_mask))
    assert bool(tsol.stats.span_complete) and bool(jsol.stats.span_complete)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
@pytest.mark.parametrize("ctrl", list(CONTROLLERS))
def test_saveat_dense_evaluate_matches_jax(ctrl, direction):
    """SaveAt(dense=True): evaluate() at a vector of query times, in either
    direction, and its gradients through the recorded steps."""
    t0, t1, _ = _span(direction, None)
    jc, tc = CONTROLLERS[ctrl]
    jrun = _jax(J.Naive(), jc, J.SaveAt(dense=True), t0, t1, mode="dense")
    trun = _port(T.Naive(), tc, T.SaveAt(dense=True), t0, t1, mode="dense")
    _compare(jrun, trun)
    np.testing.assert_allclose(trun[0].ys.detach().numpy(),
                               np.asarray(jrun[0].ys), rtol=RTOL, atol=ATOL)


def test_dense_evaluate_scalar_clamps_and_calls():
    p = params_from_numpy(_np_params(), device="cpu")
    z = torch.tensor(_np_z0())
    sol = T.solve(f_torch, p, z, 1.0, 0.0, solver=T.ALF(backend="cuda"),
                  controller=T.ConstantSteps(5), gradient=T.Naive(),
                  saveat=T.SaveAt(dense=True))
    jsol = J.solve(f_jax, {k: jnp.asarray(v) for k, v in _np_params().items()},
                   jnp.asarray(_np_z0()), 1.0, 0.0,
                   solver=J.ALF(backend="pallas"),
                   controller=J.ConstantSteps(5), gradient=J.Naive(),
                   saveat=J.SaveAt(dense=True))
    for t in (0.37, -0.5, 1.7, 1.0, 0.0):
        got = sol.evaluate(t)
        assert got.shape == (B, D)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(jsol.evaluate(t)), rtol=RTOL,
                                   atol=ATOL)
    # clamped into the span, both ends exact
    torch.testing.assert_close(sol.evaluate(-3.0), sol.ys)
    torch.testing.assert_close(sol(1.0), z)
    assert sol.interpolation.num_steps.dtype == torch.int32


def test_dense_span_complete_reports_a_truncated_span():
    p = params_from_numpy(_np_params(), device="cpu")
    z = torch.tensor(_np_z0())
    ctrl = T.AdaptiveController(1e-7, 1e-8, 4)
    sol = T.solve(f_torch, p, z, 0.0, 1.0, solver=T.ALF(backend="cuda"),
                  controller=ctrl, gradient=T.Naive(),
                  saveat=T.SaveAt(dense=True))
    jsol = J.solve(f_jax, {k: jnp.asarray(v) for k, v in _np_params().items()},
                   jnp.asarray(_np_z0()), 0.0, 1.0,
                   solver=J.ALF(backend="pallas"),
                   controller=J.AdaptiveController(1e-7, 1e-8, 4),
                   gradient=J.Naive(), saveat=J.SaveAt(dense=True))
    assert not bool(sol.stats.span_complete)
    assert not bool(jsol.stats.span_complete)
    assert int(sol.num_steps) == int(jsol.num_steps)
    reached = float(sol.interpolation.t0s[-1] + sol.interpolation.hs[-1])
    assert 0.0 < reached < 1.0
    np.testing.assert_allclose(sol.evaluate(0.6 * reached).numpy(),
                               np.asarray(jsol.evaluate(0.6 * reached)),
                               rtol=RTOL, atol=ATOL)


def test_evaluate_without_dense_raises():
    p = params_from_numpy(_np_params(), device="cpu")
    sol = T.solve(f_torch, p, torch.tensor(_np_z0()), 0.0, 1.0,
                  solver=T.ALF(backend="cuda"), controller=T.ConstantSteps(3),
                  gradient=T.Naive())
    with pytest.raises(ValueError, match="SaveAt\\(dense=True\\)"):
        sol.evaluate(0.5)
    assert sol.n_live is None and sol.step_mask.dim() == 0


def test_record_states_buffer_matches_jax_including_padding():
    """integrate_grid(record_states=True): the port's loop stops each
    segment early, yet its (T-1, max_steps, ...) start-state buffer equals
    the JAX scan's, zero padding rows included."""
    from repro.core import integrate as jint
    from repro_torch.core import integrate as tint
    jc, tc = CONTROLLERS["adaptive"]
    pj = {k: jnp.asarray(v) for k, v in _np_params().items()}
    zj = jnp.asarray(_np_z0())
    rj = jint.integrate_grid(J.ALF(eta=0.9).trial_fn(f_jax, pj, jc),
                             (zj, f_jax(pj, zj, 0.0)),
                             jnp.asarray(GRID, jnp.float32), controller=jc,
                             order=2, record_states=True)
    pt = params_from_numpy(_np_params(), device="cpu")
    zt = torch.tensor(_np_z0())
    grid = tint.as_time_grid(GRID)
    rt = tint.integrate_grid(T.ALF(eta=0.9).trial_fn(f_torch, pt, tc),
                             (zt, f_torch(pt, zt, grid[0])), grid,
                             controller=tc, order=2, record_states=True)
    np.testing.assert_array_equal(rt.n_accepted.numpy(),
                                  np.asarray(rj.n_accepted))
    for got, want in zip(rt.state_traj, rj.state_traj):
        assert got.shape == want.shape == (3, 48, B, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        for k, n in enumerate(rt.n_accepted.tolist()):
            assert not got[k, n:].any()
    const = tint.integrate_grid(
        T.ALF().trial_fn(f_torch, pt, T.ConstantSteps(3)),
        (zt, f_torch(pt, zt, grid[0])), grid, controller=T.ConstantSteps(3),
        order=2, record_states=True)
    assert const.state_traj[0].shape == (3, 3, B, D)
    torch.testing.assert_close(const.state_traj[0][1, 0], const.traj[0][1])


def test_default_interpolant_matches_jax():
    """Solver.interpolant's default (f re-evaluated at both endpoints,
    batched with torch.func.vmap) against the JAX default, on an ALF
    record whose last two rows are padding."""
    from repro.core.solvers import Solver as JSolver
    rng = np.random.default_rng(11)
    bound, n_live = 5, 3
    zs = rng.standard_normal((bound, B, D)).astype(np.float32)
    vs = rng.standard_normal((bound, B, D)).astype(np.float32)
    zs[n_live:], vs[n_live:] = 0.0, 0.0
    ze, ve = (rng.standard_normal((B, D)).astype(np.float32)
              for _ in range(2))
    ts = np.array([0.0, 0.2, 0.5, 0.0, 0.0], np.float32)
    hs = np.array([0.2, 0.3, 0.5, 0.0, 0.0], np.float32)
    pj = {k: jnp.asarray(v) for k, v in _np_params().items()}
    want = JSolver.interpolant(
        J.ALF(), f_jax, pj, (jnp.asarray(zs), jnp.asarray(vs)),
        (jnp.asarray(ze), jnp.asarray(ve)), jnp.asarray(ts), jnp.asarray(hs),
        jnp.int32(n_live))
    pt = params_from_numpy(_np_params(), device="cpu")
    got = T.Solver.interpolant(
        T.ALF(), f_torch, pt, (torch.tensor(zs), torch.tensor(vs)),
        (torch.tensor(ze), torch.tensor(ve)), torch.tensor(ts),
        torch.tensor(hs), torch.tensor(n_live, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert T.Solver().interpolant_fevals(7) == 14
    assert T.ALF().interpolant_fevals(7) == 0


def test_hermite_coefficients_reproduce_a_cubic():
    """The fitted cubic reproduces a cubic exactly from endpoint values and
    slopes, on a signed (reverse) step."""
    c = torch.tensor([0.5, -1.0, 2.0, 0.25], dtype=torch.float64)

    def y(t):
        return c[0] + t * (c[1] + t * (c[2] + t * c[3]))

    def dy(t):
        return c[1] + t * (2 * c[2] + 3 * t * c[3])

    t0, h = torch.tensor([0.8], dtype=torch.float64), -0.6
    hs = torch.tensor([h], dtype=torch.float64)
    coef = T.hermite_coefficients(y(t0), dy(t0), y(t0 + h), dy(t0 + h), hs)
    interp = T.DenseInterpolation(t0s=t0, hs=hs, c0=coef[0], c1=coef[1],
                                  c2=coef[2], c3=coef[3],
                                  num_steps=torch.tensor(1),
                                  t_start=t0[0], t_end=t0[0] + h)
    tq = torch.tensor([0.8, 0.5, 0.3, 0.2], dtype=torch.float64)
    torch.testing.assert_close(interp.evaluate(tq), y(tq))
    assert float(interp.direction) == -1.0


# ---------------------------------------------------------------------------
# Registry contract and the direct-backprop refusal
# ---------------------------------------------------------------------------

def test_registry_lists_the_backward_sweep_ops_only():
    from repro_torch.kernels.registry import no_reverse_reason
    assert no_reverse_reason("alf_step.alf_midpoint") is None
    assert no_reverse_reason("alf_step.alf_update") is None
    for op in ("alf_step.alf_inverse", "alf_step.alf_inverse_update",
               "alf_step.alf_bwd_pre", "alf_step.alf_bwd_post"):
        reason = no_reverse_reason(op)
        assert reason is not None and len(reason) >= 20, op
    T.check_direct_backprop(T.ALF(backend="cuda"), "Naive()")
    T.Naive().validate(T.ALF(backend="cuda"), T.ConstantSteps(4))
    assert T.ALF().kernel_step_ops() == ()


class _FrankenALF(T.ALF):
    """An ALF whose step claims a forward-only op."""

    def kernel_step_ops(self):
        return ("alf_step.alf_bwd_pre",)


@pytest.mark.parametrize("consumer", ["check", "naive", "steps", "dense"])
def test_forward_only_step_op_is_still_refused(consumer):
    """Every direct-backprop consumer refuses a solver whose step launches
    an op listed in NO_REVERSE_RULE, quoting the reason; SaveAt(steps|dense)
    runs its own check even with gradient=MALI()."""
    solver = _FrankenALF(backend="cuda")
    p = params_from_numpy(_np_params(), device="cpu")
    z = torch.tensor(_np_z0())
    if consumer == "check":
        with pytest.raises(ValueError, match="NO_REVERSE_RULE"):
            T.check_direct_backprop(solver, "Naive()")
    elif consumer == "naive":
        with pytest.raises(ValueError, match="fused head"):
            T.Naive().validate(solver, T.ConstantSteps(4))
    else:
        saveat = T.SaveAt(**{consumer: True})
        with pytest.raises(ValueError, match=f"SaveAt\\({consumer}=True\\)"):
            T.solve(f_torch, p, z, 0.0, 1.0, solver=solver,
                    controller=T.ConstantSteps(4), gradient=T.MALI(),
                    saveat=saveat)


# ---------------------------------------------------------------------------
# Op calls per step on the CPU (the launches chip_smoke.py counts)
# ---------------------------------------------------------------------------

def _one_step_calls(gradient):
    p = params_from_numpy(_np_params(), device="cpu")
    for v in p.values():
        v.requires_grad_(True)
    z = torch.tensor(_np_z0(), requires_grad=True)
    tops.reset_op_calls()
    sol = T.solve(f_torch, p, z, 0.0, 1.0, solver=T.ALF(backend="cuda"),
                  controller=T.ConstantSteps(1), gradient=gradient)
    fwd = dict(tops.OP_CALLS)
    torch.sum(sol.ys ** 2).backward()
    return fwd, {k: v - fwd[k] for k, v in tops.OP_CALLS.items()}


def test_one_naive_step_is_two_forward_and_two_backward_calls():
    fwd, bwd = _one_step_calls(T.Naive())
    assert {k: v for k, v in fwd.items() if v} == {"alf_midpoint": 1,
                                                   "alf_update": 1}
    assert {k: v for k, v in bwd.items() if v} == {"alf_midpoint_vjp": 1,
                                                   "alf_update_vjp": 1}
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_one_unfused_mali_step_calls():
    """Backward of one unfused MALI step: psi^-1 (midpoint with sign -1 +
    alf_inverse), then the step replayed under torch.func.vjp (midpoint +
    update) and differentiated through their reverse rules."""
    fwd, bwd = _one_step_calls(T.MALI(fused_bwd=False))
    assert {k: v for k, v in fwd.items() if v} == {"alf_midpoint": 1,
                                                   "alf_update": 1}
    assert {k: v for k, v in bwd.items() if v} == {
        "alf_midpoint": 2, "alf_update": 1, "alf_inverse": 1,
        "alf_midpoint_vjp": 1, "alf_update_vjp": 1}


def test_alf_inverse_cuda_backend_rebuilds_the_step_input():
    """core.alf_inverse(backend='cuda') (two launches around f) inverts
    alf_step and matches the reference backend."""
    p = params_from_numpy(_np_params(), device="cpu")
    z = torch.tensor(_np_z0())
    v = f_torch(p, z, torch.tensor(0.2))
    t, h = torch.tensor(0.2), torch.tensor(0.15)
    zo, vo = T.alf_step(f_torch, p, z, v, t, h, 0.9, "cuda")
    tops.reset_op_calls()
    zi, vi = T.alf_inverse(f_torch, p, zo, vo, t + h, h, 0.9, "cuda")
    assert tops.OP_CALLS["alf_midpoint"] == 1
    assert tops.OP_CALLS["alf_inverse"] == 1
    zr, vr = T.alf_inverse(f_torch, p, zo, vo, t + h, h, 0.9)
    torch.testing.assert_close(zi, zr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(vi, vr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(zi, z, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vi, v, rtol=1e-5, atol=1e-5)
