"""``None`` in the port's trees, against the JAX package's treatment on
the CPU.

``torch.utils._pytree`` counts ``None`` as a leaf and ``torch.func``
refuses it; JAX flattens it as an empty node. ``repro_torch.tree_util``
gives the port JAX's treatment, and the ALF ops' packing, the drivers'
``tree_where``, the tree maps of ``core/`` and ``torch.func``'s transforms
go through it. These tests pack, ``tree_where`` and map a tree holding
``None`` exactly as JAX does (bit-equal), and run solves over such a
state (the CNF's ``(z, logdet, kinetic, None)`` under the exact trace
estimator) bit-equal to the same solve without the ``None``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import tree_util
from repro_torch.core.integrate import tree_where
from repro_torch.kernels.alf_step import ops

torch.set_num_threads(1)


def _np_tree():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 2)).astype(np.float32), None,
            {"a": rng.standard_normal(4).astype(np.float32), "b": None},
            [None, rng.standard_normal(()).astype(np.float32)])


def _torch_tree(np_tree):
    return jax.tree_util.tree_map(torch.tensor, np_tree)


def test_flatten_map_and_leaves_match_jax():
    np_tree = _np_tree()
    tt = _torch_tree(np_tree)
    leaves, spec = tree_util.tree_flatten(tt)
    j_leaves = jax.tree_util.tree_leaves(np_tree)
    assert len(leaves) == len(j_leaves) == 3
    for a, b in zip(leaves, j_leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    back = tree_util.tree_unflatten(leaves, spec)
    assert back[1] is None and back[2]["b"] is None and back[3][0] is None
    assert back[0] is tt[0]
    doubled = tree_util.tree_map(lambda x, y: x + 2 * y, tt, tt)
    j_doubled = jax.tree_util.tree_map(lambda x, y: x + 2 * y, np_tree,
                                       np_tree)
    assert (jax.tree_util.tree_structure(j_doubled)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda t: t.numpy(), doubled)))
    for a, b in zip(tree_util.tree_leaves(doubled),
                    jax.tree_util.tree_leaves(j_doubled)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_leaves_with_keys_match_jax():
    np_tree = _np_tree()
    got = tree_util.tree_leaves_with_keys(_torch_tree(np_tree))
    want = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    # the batch-size check names leaves by these keys, as the JAX package's
    tree = (np.ones((4, 2), np.float32), None,
            {"a": np.ones((3,), np.float32)})
    with pytest.raises(ValueError) as port:
        T.batch_size(_torch_tree(tree))
    with pytest.raises(ValueError) as ref:
        J.batch_size(tree)
    assert str(port.value) == str(ref.value)


def test_pack_of_a_tree_holding_none_matches_jax():
    """The ALF ops pack every leaf into one buffer: the leaves JAX sees,
    in JAX's order, and ``unpack`` puts the ``None`` nodes back."""
    np_tree = _np_tree()
    packed = ops._Tree(_torch_tree(np_tree)).pack(torch.float32)
    want = np.concatenate([np.reshape(l, -1)
                           for l in jax.tree_util.tree_leaves(np_tree)])
    np.testing.assert_array_equal(packed.numpy(), want)
    back = ops._Tree(_torch_tree(np_tree)).unpack(packed)
    assert back[1] is None and back[2]["b"] is None
    np.testing.assert_array_equal(back[2]["a"].numpy(), np_tree[2]["a"])


@pytest.mark.parametrize("pred", [True, False])
def test_tree_where_matches_jax(pred):
    a, b = _np_tree(), jax.tree_util.tree_map(lambda x: -x, _np_tree())
    got = tree_where(torch.tensor(pred), _torch_tree(a), _torch_tree(b))
    want = jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)
    assert got[1] is None and got[2]["b"] is None
    for x, y in zip(tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_alf_op_on_a_tree_holding_none():
    """One ``alf_midpoint`` over the tree equals the op over its leaves
    alone, with the ``None`` nodes kept."""
    np_tree = _np_tree()
    z, v = _torch_tree(np_tree), _torch_tree(np_tree)
    out = ops.alf_midpoint(z, v, torch.tensor(0.3))
    alone = ops.alf_midpoint(tree_util.tree_leaves(z),
                             tree_util.tree_leaves(v), torch.tensor(0.3))
    assert out[1] is None and out[3][0] is None
    for a, b in zip(tree_util.tree_leaves(out), alone):
        assert torch.equal(a, b)


def test_vjp_and_vmap_pass_none_through():
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))

    def f(p, s):
        z, e = s
        return (z * p, None if e is None else e)

    out, pull = tree_util.vjp(f, torch.tensor(2.0), (x, None))
    assert out[1] is None
    g_p, (g_z, g_e) = pull((torch.ones_like(x), None))
    assert g_e is None
    np.testing.assert_allclose(float(g_p), float(x.sum()), rtol=1e-6)
    assert torch.equal(g_z, torch.full_like(x, 2.0))
    mapped = tree_util.vmap(lambda z, e: (z.sum(), e))(x, None)
    assert mapped[1] is None and torch.allclose(mapped[0], x.sum(1))


@pytest.mark.parametrize("method,solver", [
    ("mali", T.ALF()), ("mali_cuda", T.ALF(backend="cuda")),
    ("naive", T.ALF()), ("aca", T.HeunEuler()), ("adjoint", T.Dopri5())])
def test_solve_over_a_state_holding_none(method, solver):
    """A solve over ``(z, None)`` is bit-equal, in values and gradients,
    to the same solve over ``z`` alone."""
    gradient = {"mali": T.MALI(), "mali_cuda": T.MALI(), "naive": T.Naive(),
                "aca": T.ACA(), "adjoint": T.Backsolve()}[method]

    def f_pair(p, s, t):
        return (-p["a"] * s[0] * torch.cos(t), None)

    def f_alone(p, z, t):
        return -p["a"] * z * torch.cos(t)

    out = []
    for f, wrap in ((f_pair, lambda z: (z, None)), (f_alone, lambda z: z)):
        a = torch.tensor(0.8, requires_grad=True)
        z0 = torch.tensor([1.0, -0.5, 0.3], requires_grad=True)
        sol = T.solve(f, {"a": a}, wrap(z0), 0.0, 1.0, solver=solver,
                      controller=T.AdaptiveController(1e-4, 1e-5, 64),
                      gradient=gradient,
                      saveat=T.SaveAt(ts=torch.linspace(0.0, 1.0, 3)))
        ys = sol.ys[0] if isinstance(sol.ys, tuple) else sol.ys
        if isinstance(sol.ys, tuple):
            assert sol.ys[1] is None
        out.append((ys, torch.autograd.grad(torch.sum(ys ** 2), [a, z0]),
                    int(sol.stats.n_fevals)))
    (y1, g1, n1), (y2, g2, n2) = out
    assert torch.equal(y1, y2) and n1 == n2
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
