"""Two public JAX names and their counterparts in the port, on the CPU:
``repro_torch.kernels.registry.forward_only_ops`` against
``repro.kernels.registry.forward_only_ops`` for every kernel package,
and ``repro_torch.core.integrate.integrate_fixed`` against
``repro.core.integrate.integrate_fixed`` with the ALF step on a float32
and a float64 state, forward and reverse time.

The same numpy inputs feed both. Tolerances: float32 rtol 1e-5 (the
repo's bar); float64 rtol 1e-13, not bit-equal: the JAX function is one
jitted ``lax.scan``, and XLA on the CPU contracts the step's ``a*b + c``
into fused multiply-adds and computes ``tanh`` and the product ``z @ w``
its own way, each a last-bit difference (on this field 4e-16 to 9e-15
after 8 steps; with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, no FMA, an
elementwise linear field agrees bit for bit). The grids themselves,
``fixed_grid_times``, are bit-equal in both dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alf import alf_step as jax_alf_step
from repro.core.integrate import fixed_grid_times as jax_fixed_grid_times
from repro.core.integrate import integrate_fixed as jax_integrate_fixed
from repro.kernels import forward_only_ops as jax_forward_only_ops
from repro_torch import kernels as tkernels
from repro_torch.core.alf import alf_step
from repro_torch.core.integrate import fixed_grid_times, integrate_fixed
from repro_torch.kernels import registry

torch.set_num_threads(1)

B, D, N_STEPS = 4, 6, 8


@pytest.mark.parametrize("package", tkernels.PACKAGES + ("no_such_package",))
def test_forward_only_ops_match_jax(package):
    got = registry.forward_only_ops(package)
    assert got == jax_forward_only_ops(package)
    assert got == sorted(got)


def test_forward_only_ops_of_alf_step_and_export():
    assert registry.forward_only_ops("alf_step") == [
        "alf_bwd_post", "alf_bwd_pre", "alf_inverse", "alf_inverse_update"]
    # exported where the JAX package exports it: from the kernels package
    assert tkernels.forward_only_ops is registry.forward_only_ops
    assert tkernels.no_reverse_reason is registry.no_reverse_reason
    assert tkernels.NO_REVERSE_RULE is registry.NO_REVERSE_RULE


def _problem(seed):
    rng = np.random.default_rng(seed)
    return {"w": 0.6 * rng.standard_normal((D, D)),
            "b": 0.3 * rng.standard_normal(D),
            "z": rng.standard_normal((B, D)),
            "v": rng.standard_normal((B, D))}


def _field(mod):
    def f(p, z, t):
        return mod.tanh(z @ p["w"]) + t * p["b"]
    return f


def _run_both(data, dtype, t0, t1, eta, backend):
    """(port's end state, JAX's end state) as numpy, from the same
    numpy inputs in ``dtype``."""
    np_dt = np.dtype(dtype)
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[
        np_dt.type]
    jdt = {np.float32: jnp.float32, np.float64: jnp.float64}[np_dt.type]
    tp = {k: torch.tensor(data[k], dtype=tdt) for k in ("w", "b")}
    jp = {k: jnp.asarray(data[k], jdt) for k in ("w", "b")}
    tf, jf = _field(torch), _field(jnp)

    def tstep(s, t, h):
        return alf_step(tf, tp, s[0], s[1], t, h, eta=eta, backend=backend)

    def jstep(s, t, h):
        return jax_alf_step(jf, jp, s[0], s[1], t, h, eta=eta)

    got = integrate_fixed(
        tstep, (torch.tensor(data["z"], dtype=tdt),
                torch.tensor(data["v"], dtype=tdt)),
        torch.tensor(t0, dtype=tdt), torch.tensor(t1, dtype=tdt), N_STEPS)
    want = jax_integrate_fixed(
        jstep, (jnp.asarray(data["z"], jdt), jnp.asarray(data["v"], jdt)),
        jnp.asarray(t0, jdt), jnp.asarray(t1, jdt), N_STEPS)
    for g, w in zip(got, want):
        assert g.dtype == tdt and w.dtype == jdt
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


SPANS = {"forward": (0.0, 1.5), "reverse": (1.5, -0.25)}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("eta", [1.0, 0.9])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_integrate_fixed_f32_matches_jax(span, eta, backend):
    got, want = _run_both(_problem(0), np.float32, *SPANS[span], eta,
                          backend)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("eta", [1.0, 0.9])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_integrate_fixed_f64_matches_jax(span, eta, backend):
    jax.config.update("jax_enable_x64", True)
    try:
        got, want = _run_both(_problem(1), np.float64, *SPANS[span], eta,
                              backend)
    finally:
        jax.config.update("jax_enable_x64", False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_fixed_grid_times_match_jax(span, dtype):
    t0, t1 = SPANS[span]
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        jts, jh = jax_fixed_grid_times(jnp.asarray(t0, dtype),
                                       jnp.asarray(t1, dtype), N_STEPS)
        jts, jh = np.asarray(jts), np.asarray(jh)
    finally:
        jax.config.update("jax_enable_x64", False)
    ts, h = fixed_grid_times(torch.tensor(t0, dtype=getattr(
        torch, np.dtype(dtype).name)), torch.tensor(t1, dtype=getattr(
            torch, np.dtype(dtype).name)), N_STEPS)
    assert ts.numpy().dtype == jts.dtype
    np.testing.assert_array_equal(ts.numpy(), jts)
    np.testing.assert_array_equal(h.numpy(), jh)


def test_integrate_fixed_takes_number_bounds():
    """Python-number bounds become float32 on the state's device, as the
    JAX function's weak-typed numbers do without x64."""
    data = _problem(2)
    tp = {k: torch.tensor(data[k], dtype=torch.float32) for k in ("w", "b")}
    state = (torch.tensor(data["z"], dtype=torch.float32),
             torch.tensor(data["v"], dtype=torch.float32))

    def step(s, t, h):
        assert t.dtype == torch.float32 and h.dtype == torch.float32
        return alf_step(_field(torch), tp, s[0], s[1], t, h)

    by_number = integrate_fixed(step, state, 0.0, 1.5, N_STEPS)
    by_tensor = integrate_fixed(step, state, torch.tensor(0.0),
                                torch.tensor(1.5), N_STEPS)
    for a, b in zip(by_number, by_tensor):
        assert torch.equal(a, b)
