"""The grad-free path of the forward ALF ops (``alf_midpoint``,
``alf_update`` in ``repro_torch.kernels.alf_step.ops``) on the CPU.

When autograd is off, or no input needs a gradient, the two ops call the
launcher (on the CPU, the plain version) directly on the packed buffers,
with no ``autograd.Function``. These tests hold that path to the
grad-enabled path bit for bit (the same function on the same buffers) on
f32, bf16, f64 and mixed {f32, bf16} trees, show that it reaches neither
Function, and hold it to the JAX package's ops on the Pallas path in
interpret mode with the tolerances of tests/test_torch_alf_ops.py: f32
rtol 1e-5 / atol 1e-6, bf16 one bf16 ulp relative (2**-7) / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.kernels.alf_step import ops as jops
from repro_torch.kernels.alf_step import alf_step as kernels
from repro_torch.kernels.alf_step import ops as tops

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f64": torch.float64}
KINDS = ["f32", "bf16", "f64", "mixed", "bare"]
TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
       "bf16": dict(rtol=2.0 ** -7, atol=1e-6)}


def _trees(kind: str, n_trees: int, seed: int):
    """``n_trees`` states of one kind from a numpy seed: a tree {w, z} of
    one dtype, a mixed {f32, bf16} tree, or a bare f32 tensor."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_trees):
        w = rng.standard_normal((3, 70)).astype(np.float32)
        z = rng.standard_normal((257,)).astype(np.float32)
        if kind == "bare":
            out.append(torch.tensor(w))
        elif kind == "mixed":
            out.append({"w": torch.tensor(w),
                        "z": torch.tensor(z).to(torch.bfloat16)})
        else:
            dt = DTYPES[kind]
            out.append({"w": torch.tensor(w).to(dt),
                        "z": torch.tensor(z).to(dt)})
    return out


def _call(op, trees, h, param, grad: bool):
    """One op call on fresh copies of ``trees``: with grad, every leaf and
    h require a gradient (the Function path); without, under
    ``torch.no_grad()``."""
    kw = {"sign": param} if op == "alf_midpoint" else {"eta": param}
    if grad:
        trees = [pytree.tree_map(
            lambda x: x.detach().clone().requires_grad_(True), t)
            for t in trees]
        h = h.detach().clone().requires_grad_(True)
        out = getattr(tops, op)(*trees, h, **kw)
    else:
        with torch.no_grad():
            out = getattr(tops, op)(*trees, h, **kw)
    return out if isinstance(out, tuple) else (out,)


def _h(kind):
    return torch.tensor(0.23, dtype=torch.float64 if kind == "f64"
                        else torch.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_midpoint_grad_free_is_bit_equal_to_the_function_path(kind, sign):
    trees = _trees(kind, 2, 11)
    free = _call("alf_midpoint", trees, _h(kind), sign, grad=False)
    with_grad = _call("alf_midpoint", trees, _h(kind), sign, grad=True)
    for a, b in zip(pytree.tree_leaves(free), pytree.tree_leaves(with_grad)):
        assert a.grad_fn is None and b.grad_fn is not None
        assert a.dtype == b.dtype and torch.equal(a, b.detach())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_update_grad_free_is_bit_equal_to_the_function_path(kind, eta):
    trees = _trees(kind, 3, 12)
    free = _call("alf_update", trees, _h(kind), eta, grad=False)
    with_grad = _call("alf_update", trees, _h(kind), eta, grad=True)
    for a, b in zip(pytree.tree_leaves(free), pytree.tree_leaves(with_grad)):
        assert a.grad_fn is None and b.grad_fn is not None
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    # each output keeps its input tree's structure and leaf dtypes
    for out, tree in zip(free, trees[:2]):
        assert pytree.tree_structure(out) == pytree.tree_structure(tree)
        for a, b in zip(pytree.tree_leaves(out), pytree.tree_leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op,param", [("alf_midpoint", 1.0),
                                      ("alf_midpoint", -1.0),
                                      ("alf_update", 1.0),
                                      ("alf_update", 0.9)])
def test_grad_free_ops_match_jax(op, param, dt):
    rng = np.random.default_rng(13)
    n = 2 if op == "alf_midpoint" else 3
    np_trees = [{"w": rng.standard_normal((3, 70)).astype(np.float32),
                 "z": rng.standard_normal((257,)).astype(np.float32)}
                for _ in range(n)]
    kw = {"sign": param} if op == "alf_midpoint" else {"eta": param}
    with torch.no_grad():
        got = getattr(tops, op)(
            *[{k: torch.tensor(v).to(DTYPES[dt]) for k, v in t.items()}
              for t in np_trees], 0.23, **kw)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    want = getattr(jops, op)(
        *[{k: jnp.asarray(v).astype(jdt) for k, v in t.items()}
          for t in np_trees], jnp.float32(0.23), use_pallas=True, **kw)
    got = pytree.tree_leaves(got)
    want = [np.asarray(w, np.float32) for w in
            (want if isinstance(want, tuple) else (want,))
            for w in (w["w"], w["z"])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dt]
        np.testing.assert_allclose(g.float().numpy(), w, **TOL[dt])


@pytest.mark.parametrize("grad_enabled", [False, True],
                         ids=["no_grad", "no_input_requires_grad"])
def test_grad_free_path_reaches_no_function(monkeypatch, grad_enabled):
    """Under no_grad, or with grad on but no input (nor h) requiring one,
    neither _Midpoint.apply nor _Update.apply is reached; the outputs have
    no grad_fn and OP_CALLS rises by one per call."""
    def refuse(*args, **kwargs):
        raise AssertionError("autograd.Function reached on the grad-free "
                             "path")

    monkeypatch.setattr(tops._Midpoint, "apply", refuse)
    monkeypatch.setattr(tops._Update, "apply", refuse)
    z, v, u = _trees("mixed", 3, 14)
    h = torch.tensor(0.1)
    tops.reset_op_calls()
    kernels.reset_launches()
    with torch.set_grad_enabled(grad_enabled):
        k1 = tops.alf_midpoint(z, v, h)
        assert tops.OP_CALLS["alf_midpoint"] == 1
        zo, vo = tops.alf_update(k1, v, u, h, eta=0.9)
        assert tops.OP_CALLS["alf_update"] == 1
        tops.alf_midpoint(zo["w"], vo["w"], 0.1)
    assert tops.OP_CALLS["alf_midpoint"] == 2
    assert tops.OP_CALLS["alf_update"] == 1
    for leaf in pytree.tree_leaves((k1, zo, vo)):
        assert leaf.grad_fn is None and not leaf.requires_grad
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("needs", ["z", "v", "h"])
def test_an_input_that_needs_a_gradient_takes_the_function(monkeypatch,
                                                          needs):
    """With grad on, one input (or h) that requires a gradient sends the
    call through the Function, whose backward gives that gradient."""
    calls = {"_Midpoint": 0, "_Update": 0}
    for name in calls:
        fn = getattr(tops, name)
        orig = fn.apply

        def counted(*args, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*args)

        monkeypatch.setattr(fn, "apply", counted)
    z, v, u = (t.clone() for t in _trees("bare", 3, 15))
    h = torch.tensor(0.1)
    {"z": z, "v": v, "h": h}[needs].requires_grad_(True)
    k1 = tops.alf_midpoint(z, v, h)
    zo, vo = tops.alf_update(k1, v, u, h)
    assert calls == {"_Midpoint": 1, "_Update": 1}
    assert zo.grad_fn is not None
    src = {"z": z, "v": v, "h": h}[needs]
    (g,) = torch.autograd.grad(zo.sum() + vo.sum(), src)
    assert g.shape == src.shape and bool(torch.isfinite(g).all())


def test_a_bare_contiguous_leaf_is_not_copied():
    """A single contiguous leaf in the common dtype goes straight to the
    kernel as a view, and comes back in its own shape."""
    z = torch.randn(4, 6)
    t = tops._Tree(z)
    assert t.spec is None
    flat = t.pack(torch.float32)
    assert flat.data_ptr() == z.data_ptr() and flat.shape == (24,)
    back = t.unpack(flat)
    assert back.shape == (4, 6) and back.data_ptr() == z.data_ptr()
    with torch.no_grad():
        k1 = tops.alf_midpoint(z, z, 0.5)
    assert isinstance(k1, torch.Tensor) and k1.shape == (4, 6)
    assert torch.equal(k1, (z + z * 0.25))


def test_step_size_tensor_of_the_right_kind_is_used_as_is():
    h = torch.tensor(0.3)
    assert tops._as_h(h, torch.float32, torch.device("cpu")) is h
    assert tops._as_h(h, torch.float64, torch.device("cpu")).dtype == \
        torch.float64
