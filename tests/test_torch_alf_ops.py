"""The port's fused ALF ops (``repro_torch.kernels.alf_step.ops``) on CPU
tensors against the JAX package's ops on the Pallas path in interpret
mode (``use_pallas=True``, as tests/test_kernels.py runs them), and the
plain versions of the two reverse-rule kernels against the JAX Pallas
kernels on the packed buffer.

The same numpy inputs feed both. On CPU tensors the port's ops run the
plain version over the packed buffer; the CUDA kernels are held against
that plain version on the card by ``chip_smoke.py``.

Tolerances: f32 rtol 1e-5 / atol 1e-6 (the Pallas kernel multiplies by
1/(1-2*eta) where the plain version divides: ulp-level differences);
bf16 one bf16 ulp relative (2**-7) — an ulp-level f32 difference may flip
the final rounding; f64 rtol 1e-13.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.kernels.alf_step import ops as jops
from repro_torch.kernels.alf_step import alf_step as kernels
from repro_torch.kernels.alf_step import ops as tops
from repro_torch.kernels.alf_step import ref as tref

torch.set_num_threads(1)

STATES = {
    "lane": {"z": (128,)},
    "ragged": {"z": (3, 200)},
    # keys in sorted order: JAX flattens dicts by sorted key, torch's
    # pytree by insertion order, and the leaves are compared in order
    "tree": {"w": (257,), "z": (2, 64, 64)},
    "tail": {"z": (1500 * 128 + 37,)},   # 1501 rows: a ragged last block
}

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
       "bf16": dict(rtol=2.0 ** -7, atol=1e-6)}


def _np_trees(shapes, n, seed):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _to_torch(tree, dt):
    return {k: torch.tensor(v).to(TORCH_DT[dt]) for k, v in tree.items()}


def _to_jax(tree, dt):
    return {k: jnp.asarray(v).astype(JAX_DT[dt]) for k, v in tree.items()}


def _check(got, want, dt):
    g_leaves, w_leaves = pytree.tree_leaves(got), jax.tree_util.tree_leaves(
        want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == TORCH_DT[dt]
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TOL[dt])


def _run(op, trees_np, dt, h, **kw):
    got = getattr(tops, op)(*[_to_torch(t, dt) for t in trees_np],
                            torch.tensor(h), **kw)
    want = getattr(jops, op)(*[_to_jax(t, dt) for t in trees_np],
                             jnp.float32(h), use_pallas=True, **kw)
    return got, want


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_midpoint_matches_jax(state, dt, sign):
    trees = _np_trees(STATES[state], 2, seed=1)
    got, want = _run("alf_midpoint", trees, dt, 0.23, sign=sign)
    _check(got, want, dt)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_update_matches_jax(state, dt, eta):
    trees = _np_trees(STATES[state], 3, seed=2)
    got, want = _run("alf_update", trees, dt, 0.23, eta=eta)
    _check(got, want, dt)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_bwd_pre_matches_jax(state, dt, eta):
    trees = _np_trees(STATES[state], 4, seed=3)
    got, want = _run("alf_bwd_pre", trees, dt, -0.17, eta=eta)
    _check(got, want, dt)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_bwd_post_matches_jax(state, dt, eta):
    trees = _np_trees(STATES[state], 6, seed=4)
    got, want = _run("alf_bwd_post", trees, dt, 0.31, eta=eta)
    _check(got, want, dt)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [1.0, 0.8])
@pytest.mark.parametrize("op", ["alf_inverse", "alf_inverse_update"])
def test_inverse_ops_match_jax(op, state, dt, eta):
    trees = _np_trees(STATES[state], 3, seed=8)
    got, want = _run(op, trees, dt, -0.29, eta=eta)
    _check(got, want, dt)


def _vjp_pair(name, trees_np, dt, h, param):
    """A reverse-rule kernel's plain version (the port's, on the packed
    buffer) and the JAX Pallas kernel (interpret mode, on the [rows, 128]
    buffer), on the same cotangent trees."""
    from repro.kernels.alf_step import alf_step as jk
    cd = TORCH_DT[dt]
    tbufs = [tops._flatten(_to_torch(t, dt), cd) for t in trees_np]
    jbufs = [jops._flatten(_to_jax(t, dt), JAX_DT[dt]) for t in trees_np]
    n = jbufs[0][3]
    if name == "midpoint_vjp":
        got = (tref.midpoint_vjp_ref(tbufs[0], torch.tensor(h), param),)
        want = (jk.midpoint_vjp_call(jbufs[0][0], jnp.float32(h),
                                     sign=param),)
    else:
        got = tref.update_vjp_ref(tbufs[0], tbufs[1], torch.tensor(h), param)
        want = jk.update_vjp_call(jbufs[0][0], jbufs[1][0], jnp.float32(h),
                                  eta=param)
    for g, w in zip(got, want):
        assert g.dtype == cd and g.shape == (n,)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32).reshape(-1)[:n],
            **TOL[dt])


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_midpoint_vjp_matches_jax(state, dt, sign):
    _vjp_pair("midpoint_vjp", _np_trees(STATES[state], 1, seed=9), dt, 0.23,
              sign)


@pytest.mark.parametrize("state", list(STATES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_update_vjp_matches_jax(state, dt, eta):
    _vjp_pair("update_vjp", _np_trees(STATES[state], 2, seed=10), dt, -0.31,
              eta)


def test_mixed_dtype_tree_restores_leaf_dtypes():
    """A {f32, bf16} tree packs at the promoted f32 and every output leaf
    comes back in its own dtype, as in the JAX package."""
    rng = np.random.default_rng(5)
    mk = lambda: {"big": rng.standard_normal((2, 128)).astype(np.float32),
                  "small": rng.standard_normal((63,)).astype(np.float32)}
    trees = [mk() for _ in range(6)]

    def tt(t):
        return {"big": torch.tensor(t["big"]),
                "small": torch.tensor(t["small"]).to(torch.bfloat16)}

    def jt(t):
        return {"big": jnp.asarray(t["big"]),
                "small": jnp.asarray(t["small"]).astype(jnp.bfloat16)}

    for op, kw, n in (("alf_midpoint", {"sign": 1.0}, 2),
                      ("alf_update", {"eta": 0.9}, 3),
                      ("alf_bwd_pre", {"eta": 0.9}, 4),
                      ("alf_bwd_post", {"eta": 0.9}, 6),
                      ("alf_inverse", {"eta": 0.9}, 3),
                      ("alf_inverse_update", {"eta": 0.9}, 3)):
        got = getattr(tops, op)(*[tt(t) for t in trees[:n]],
                                torch.tensor(0.2), **kw)
        want = getattr(jops, op)(*[jt(t) for t in trees[:n]],
                                 jnp.float32(0.2), use_pallas=True, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g["big"].dtype == torch.float32
            assert g["small"].dtype == torch.bfloat16
            np.testing.assert_allclose(g["big"].numpy(),
                                       np.asarray(w["big"]), **TOL["f32"])
            np.testing.assert_allclose(g["small"].float().numpy(),
                                       np.asarray(w["small"], np.float32),
                                       **TOL["bf16"])


def test_float64_state_stays_float64():
    """f64 trees stay f64 end to end (h rides at f64), matching the JAX
    package under x64 to ~1e-15."""
    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(6)
        trees = [{"s": rng.standard_normal(200)} for _ in range(6)]
        h = 0.1
        t = [{"s": torch.tensor(x["s"], dtype=torch.float64)} for x in trees]
        j = [{"s": jnp.asarray(x["s"], jnp.float64)} for x in trees]
        hj = jnp.float64(h)
        pairs = [
            (tops.alf_midpoint(*t[:2], h),
             jops.alf_midpoint(*j[:2], hj, use_pallas=True)),
            (tops.alf_update(*t[:3], h, eta=0.8),
             jops.alf_update(*j[:3], hj, eta=0.8, use_pallas=True)),
            (tops.alf_bwd_pre(*t[:4], h, eta=0.8),
             jops.alf_bwd_pre(*j[:4], hj, eta=0.8, use_pallas=True)),
            (tops.alf_bwd_post(*t, h, eta=0.8),
             jops.alf_bwd_post(*j, hj, eta=0.8, use_pallas=True)),
            (tops.alf_inverse(*t[:3], h, eta=0.8),
             jops.alf_inverse(*j[:3], hj, eta=0.8, use_pallas=True)),
            (tops.alf_inverse_update(*t[:3], h, eta=0.8),
             jops.alf_inverse_update(*j[:3], hj, eta=0.8, use_pallas=True)),
        ]
        for got, want in pairs:
            for g, w in zip(pytree.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                assert g.dtype == torch.float64
                assert w.dtype == jnp.float64
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-13, atol=1e-15)
        # an f32 round trip would miss this by ~1e-8
        want = trees[0]["s"] + trees[1]["s"] * 0.05
        np.testing.assert_allclose(pairs[0][0]["s"].numpy(), want,
                                   rtol=1e-14)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_step_size_rides_at_least_f32():
    """A bf16 state still gets an f32 h (a bf16 h would quantize small
    adaptive steps); f64 states get an f64 h."""
    assert tops._as_h(0.1, torch.bfloat16, torch.device("cpu")).dtype == \
        torch.float32
    assert tops._as_h(torch.tensor(0.1), torch.float64,
                      torch.device("cpu")).dtype == torch.float64
    h = tops._as_h(torch.tensor(0.1), torch.float32, torch.device("cpu"))
    assert h.dim() == 0


def test_single_leaf_is_packed_without_copy():
    z = torch.randn(4, 5)
    flat = tops._flatten(z, torch.float32)
    assert flat.data_ptr() == z.data_ptr() and flat.shape == (20,)
    mixed = tops._flatten({"a": z, "b": torch.ones(3)}, torch.float32)
    assert mixed.shape == (23,)


def test_op_calls_count_and_cpu_launches_nothing():
    """One count per op call, whatever the tree; CPU tensors take the
    plain version and launch no kernel."""
    tops.reset_op_calls()
    kernels.reset_launches()
    z = {"a": torch.randn(3, 4), "b": [torch.randn(5), torch.randn(2)]}
    h = torch.tensor(0.1)
    k1 = tops.alf_midpoint(z, z, h)
    tops.alf_update(k1, z, z, h, eta=0.9)
    tops.alf_bwd_pre(z, z, z, z, h)
    tops.alf_bwd_post(z, z, z, z, z, z, h)
    tops.alf_inverse(z, z, z, h)
    tops.alf_inverse_update(z, z, z, h, eta=0.9)
    assert tops.OP_CALLS == {"alf_midpoint": 1, "alf_update": 1,
                             "alf_bwd_pre": 1, "alf_bwd_post": 1,
                             "alf_midpoint_vjp": 0, "alf_update_vjp": 0,
                             "alf_inverse": 1, "alf_inverse_update": 1}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert pytree.tree_structure(k1) == pytree.tree_structure(z)


def test_ops_refuse_devices_without_a_version():
    """A device with neither a kernel nor a plain version is refused; the
    meta device takes the plain version, which computes only shapes (what
    the op cost counter and the dry run count a step on)."""
    from repro_torch.kernels import on_cuda
    with pytest.raises(ValueError, match="no kernel or plain version"):
        on_cuda("alf_midpoint", torch.device("xpu"))
    z = torch.empty(8, device="meta")
    k1 = tops.alf_midpoint(z, z, torch.tensor(0.1, device="meta"))
    assert k1.is_meta and k1.shape == z.shape and k1.dtype == z.dtype


def test_launchers_refuse_cpu_buffers():
    """The launchers take CUDA buffers only — they never fall back to the
    plain version, and they check before building or loading anything."""
    z = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.midpoint_call(z, z, torch.tensor(0.1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.bwd_post_call(z, z, z, z, z, z, torch.tensor(0.1))
    for call, n in ((kernels.midpoint_vjp_call, 1),
                    (kernels.update_vjp_call, 2),
                    (kernels.inverse_call, 3),
                    (kernels.inverse_update_call, 3)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(*[z] * n, torch.tensor(0.1))


def test_plain_versions_round_once_at_the_write():
    """bf16 inputs accumulate in f32 and are rounded once at the write:
    the bf16 result equals the f32 computation on the upcast inputs,
    rounded to bf16."""
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(1000, generator=g).to(torch.bfloat16) for _ in range(6)]
    up = [x.float() for x in xs]
    h = torch.tensor(0.37)
    for fn, n, kw in ((tref.midpoint_ref, 2, (-1.0,)),
                      (tref.update_ref, 3, (0.9,)),
                      (tref.bwd_pre_ref, 4, (0.9,)),
                      (tref.bwd_post_ref, 6, (0.9,)),
                      (tref.inverse_ref, 3, (0.9,)),
                      (tref.inverse_update_ref, 3, (0.9,)),
                      (tref.midpoint_vjp_ref, 1, (-1.0,)),
                      (tref.update_vjp_ref, 2, (0.9,))):
        got = fn(*xs[:n], h, *kw)
        want = fn(*up[:n], h, *kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, b.to(torch.bfloat16))
