"""The eight fused ALF ops with a per-row step size (``PerSample``
batching) on CPU tensors: a (B,) ``h`` over a batch equals B separate
calls with each row's scalar ``h`` on that row, bit for bit (the plain
versions see the row-major packed buffer as (B, D) beside h as (B, 1));
the per-row ``h`` cotangent of the two differentiable ops equals the JAX
package's ``vmap(grad)`` over the rows; the row-major packing and its
inverse are exact.

Row lengths D: 1 (one element a row), 2 (a mixed {f32, bf16} row) and
1570, the image CNF's augmented row (784 z + logdet + kinetic + 784
probe). Tolerance against JAX: f32 rtol 1e-5 / atol 1e-6, as in
tests/test_torch_alf_ops.py (ulp-level differences of the two
implementations' reductions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.kernels.alf_step import ops as jops
from repro_torch.kernels.alf_step import ops as tops

torch.set_num_threads(1)

B = 3
H = np.asarray([0.23, -0.11, 0.37], np.float32)
# row shapes (after the batch axis) per leaf, keys in sorted order
ROWS = {
    1: {"z": ()},
    2: {"a": (1,), "b": ()},            # "b" is bf16 in the mixed case
    1570: {"e": (784,), "k": (), "l": (), "z": (784,)},
}
# op: (trees it takes, keyword, value)
OPS = {
    "alf_midpoint": (2, "sign", -1.0),
    "alf_update": (3, "eta", 0.9),
    "alf_inverse": (3, "eta", 0.9),
    "alf_inverse_update": (3, "eta", 1.0),
    "alf_bwd_pre": (4, "eta", 0.9),
    "alf_bwd_post": (6, "eta", 0.9),
}
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_trees(d, n, seed):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal((B,) + s).astype(np.float32)
             for k, s in ROWS[d].items()} for _ in range(n)]


def _torch_tree(tree, kind):
    out = {k: torch.tensor(v) for k, v in tree.items()}
    if kind == "f64":
        out = {k: v.double() for k, v in out.items()}
    elif kind == "mixed":
        out["b" if "b" in out else "z"] = out[
            "b" if "b" in out else "z"].to(torch.bfloat16)
    return out


def _row(tree, i):
    return {k: v[i] for k, v in tree.items()}


def _h(kind):
    return torch.tensor(H, dtype=torch.float64 if kind == "f64"
                        else torch.float32)


def _equal(got, want):
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", sorted(ROWS))
@pytest.mark.parametrize("kind", ["f32", "mixed", "f64"])
@pytest.mark.parametrize("op", list(OPS))
def test_per_row_op_equals_scalar_calls(op, kind, d):
    """One call with a (B,) h == B calls with row i's h on row i."""
    n, key, value = OPS[op]
    trees = [_torch_tree(t, kind) for t in _np_trees(d, n, seed=d + n)]
    h = _h(kind)
    got = getattr(tops, op)(*trees, h, **{key: value})
    got = got if isinstance(got, tuple) else (got,)
    for i in range(B):
        want = getattr(tops, op)(*[_row(t, i) for t in trees], h[i],
                                 **{key: value})
        want = want if isinstance(want, tuple) else (want,)
        _equal([_row(g, i) for g in got], want)


@pytest.mark.parametrize("d", sorted(ROWS))
@pytest.mark.parametrize("kind", ["f32", "mixed"])
@pytest.mark.parametrize("op", ["alf_midpoint", "alf_update"])
def test_per_row_reverse_rules_equal_scalar_calls(op, kind, d):
    """The two reverse-rule kernels (alf_midpoint_vjp, alf_update_vjp) and
    the per-row h_bar, through autograd: the batch's gradients equal each
    row's own."""
    n, key, value = OPS[op]
    trees = [_torch_tree(t, kind) for t in _np_trees(d, n, seed=5 + d)]

    def grads(ins, h):
        ins = [pytree.tree_map(lambda x: x.clone().requires_grad_(True), t)
               for t in ins]
        h = h.clone().requires_grad_(True)
        out = getattr(tops, op)(*ins, h, **{key: value})
        out = out if isinstance(out, tuple) else (out,)
        loss = sum((l.float() * (1.0 + k)).pow(2).sum() for k, l in
                   enumerate(pytree.tree_leaves(out)))
        leaves = [l for t in ins for l in pytree.tree_leaves(t)]
        return torch.autograd.grad(loss, leaves + [h])

    batched = grads(trees, _h(kind))
    for i in range(B):
        single = grads([_row(t, i) for t in trees], _h(kind)[i])
        for g, w in zip(batched[:-1], single[:-1]):
            assert torch.equal(g[i], w)
        torch.testing.assert_close(batched[-1][i], single[-1], rtol=1e-6,
                                   atol=1e-6)


def _jax_loss(op, key, value):
    def loss(trees, h):
        out = getattr(jops, op)(*trees, h, use_pallas=True, **{key: value})
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum((l * (1.0 + k)) ** 2) for k, l in
                   enumerate(jax.tree_util.tree_leaves(out)))
    return loss


@pytest.mark.parametrize("d", sorted(ROWS))
@pytest.mark.parametrize("op", ["alf_midpoint", "alf_update"])
def test_per_row_h_cotangent_matches_jax_vmap_grad(op, d):
    """The per-row h_bar (a (B,) reduction at h's dtype) against
    ``jax.vmap(jax.grad(...))`` over the rows, with the Pallas kernels in
    interpret mode; the values too."""
    n, key, value = OPS[op]
    trees_np = _np_trees(d, n, seed=11 + d)
    loss = _jax_loss(op, key, value)
    want_h = jax.vmap(jax.grad(loss, argnums=1))(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees_np],
        jnp.asarray(H))
    want_out = jax.vmap(lambda trees, h: getattr(jops, op)(
        *trees, h, use_pallas=True, **{key: value}))(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees_np],
        jnp.asarray(H))

    trees = [_torch_tree(t, "f32") for t in trees_np]
    h = _h("f32").requires_grad_(True)
    out = getattr(tops, op)(*trees, h, **{key: value})
    out = out if isinstance(out, tuple) else (out,)
    total = sum((l * (1.0 + k)).pow(2).sum() for k, l in
                enumerate(pytree.tree_leaves(out)))
    (got_h,) = torch.autograd.grad(total, [h])
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    for g, w in zip(pytree.tree_leaves(out),
                    jax.tree_util.tree_leaves(want_out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("d", sorted(ROWS))
@pytest.mark.parametrize("kind", ["f32", "mixed"])
def test_row_major_packing_round_trip(kind, d):
    """Per-row packing puts row b of every leaf in row b of the buffer,
    and unpacking restores every leaf (shape, dtype, values); a single
    contiguous leaf packs as a view."""
    (tree,) = [_torch_tree(t, kind) for t in _np_trees(d, 1, seed=d)]
    t = tops._Tree(tree)
    cd = torch.float32
    flat = t.pack(cd, B)
    rows = flat.view(B, -1)
    assert rows.shape[1] == d
    for i in range(B):
        want = torch.cat([v[i].reshape(-1).to(cd) for v in tree.values()])
        assert torch.equal(rows[i], want)
    _equal(t.unpack(flat, B), tree)
    single = torch.randn(B, 5)
    assert tops._Tree(single).pack(cd, B).data_ptr() == single.data_ptr()


def test_per_row_h_needs_the_batch_axis_on_every_leaf():
    z = {"a": torch.ones(3, 2), "b": torch.ones(2)}
    with pytest.raises(ValueError, match="batch axis"):
        tops.alf_midpoint(z, z, torch.ones(3))
