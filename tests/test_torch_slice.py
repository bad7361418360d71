"""The slice as a whole: the paper's Sec 4.2 model
(examples/image_recognition.py) — y = x + int_0^1 f(z) dt with MALI,
a norm and a linear head — in both packages, at D=16 and batch 64.

The JAX side runs ALF on its reference backend and on its Pallas backend
(interpret mode); the port runs the matching ``reference`` and ``cuda``
backends on CPU tensors, with MALI and with Naive (direct backprop through
the kernel ops). Loss and gradients agree within rtol 1e-5 /
atol 1e-6, and a few Adam steps (the example's own update) keep the two
loss traces together.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, HIDDEN, N_CLASS, BATCH, N_SUB = 16, 16, 3, 64, 4
RTOL, ATOL = 1e-5, 1e-6
BACKENDS = {"reference": "reference", "pallas": "cuda"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((N_CLASS, D)) * 0.6
    y = rng.integers(0, N_CLASS, BATCH)
    x = protos[y] + rng.standard_normal((BATCH, D)) * 0.8
    return x.astype(np.float32), y


def _params(seed=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"f": {"w1": (0.3 * rng.standard_normal((D, HIDDEN))).astype(f32),
                  "b1": np.zeros(HIDDEN, f32),
                  "w2": (0.3 * rng.standard_normal((HIDDEN, D))).astype(f32),
                  "b2": np.zeros(D, f32)},
            "norm": np.ones(D, f32),
            "head": (0.3 * rng.standard_normal((D, N_CLASS))).astype(f32),
            "bh": np.zeros(N_CLASS, f32)}


def field_jax(fp, z, t):
    return jnp.tanh(z @ fp["w1"] + fp["b1"]) @ fp["w2"] + fp["b2"]


def field_torch(fp, z, t):
    return torch.tanh(z @ fp["w1"] + fp["b1"]) @ fp["w2"] + fp["b2"]


def loss_jax(p, x, y, backend, gradient=None):
    z = J.solve(field_jax, p["f"], x, 0.0, 1.0,
                solver=J.ALF(eta=1.0, backend=backend),
                controller=J.ConstantSteps(N_SUB),
                gradient=gradient or J.MALI()).ys
    logits = (z * p["norm"]) @ p["head"] + p["bh"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, y[:, None], 1).mean()


def loss_torch(p, x, y, backend, gradient=None):
    z = T.solve(field_torch, p["f"], x, 0.0, 1.0,
                solver=T.ALF(eta=1.0, backend=backend),
                controller=T.ConstantSteps(N_SUB),
                gradient=gradient or T.MALI()).ys
    logits = (z * p["norm"]) @ p["head"] + p["bh"]
    return torch.nn.functional.cross_entropy(logits, y)


def _torch_params(np_params):
    p = params_from_numpy(np_params, device="cpu")
    for leaf in torch.utils._pytree.tree_leaves(p):
        leaf.requires_grad_(True)
    return p


def _jax_params(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _assert_tree_close(got_torch, want_jax):
    got = params_to_numpy(got_torch)
    for path in (("f", "w1"), ("f", "b1"), ("f", "w2"), ("f", "b2"),
                 ("norm",), ("head",), ("bh",)):
        g, w = got, want_jax
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("jax_backend", list(BACKENDS))
def test_model_loss_and_gradients_match_jax(jax_backend):
    x, y = _data()
    lj, gj = jax.value_and_grad(loss_jax)(_jax_params(_params()),
                                          jnp.asarray(x), jnp.asarray(y),
                                          jax_backend)
    p = _torch_params(_params())
    lt = loss_torch(p, torch.tensor(x), torch.tensor(y),
                    BACKENDS[jax_backend])
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    grads = torch.utils._pytree.tree_map(lambda t: t.grad, p)
    _assert_tree_close(grads, gj)


def test_model_naive_cuda_matches_jax_naive_pallas():
    """Direct backprop through the kernel ops on the model: Naive x
    ALF('cuda') in the port against Naive x ALF('pallas') in JAX."""
    x, y = _data()
    lj, gj = jax.value_and_grad(loss_jax)(_jax_params(_params()),
                                          jnp.asarray(x), jnp.asarray(y),
                                          "pallas", J.Naive())
    p = _torch_params(_params())
    lt = loss_torch(p, torch.tensor(x), torch.tensor(y), "cuda", T.Naive())
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    _assert_tree_close(torch.utils._pytree.tree_map(lambda t: t.grad, p), gj)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_model_mali_matches_naive_in_the_port(backend):
    """The port's own oracle: MALI on either backend against Naive on the
    reference backend, at the JAX package's bar for pytree dynamics."""
    x, y = torch.tensor(_data()[0]), torch.tensor(_data()[1])
    p = _torch_params(_params())
    leaves = torch.utils._pytree.tree_leaves(p)
    gm = torch.autograd.grad(loss_torch(p, x, y, backend), leaves)
    gn = torch.autograd.grad(loss_torch(p, x, y, "reference", T.Naive()),
                             leaves)
    for a, b in zip(gm, gn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def _adam_jax(p, g, m, v, i, lr=3e-3):
    tm = jax.tree_util.tree_map
    m = tm(lambda a, b: 0.9 * a + 0.1 * b, m, g)
    v = tm(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
    t = i + 1.0
    p = tm(lambda pp, mm, vv: pp - lr * (mm / (1 - 0.9 ** t)) /
           (jnp.sqrt(vv / (1 - 0.999 ** t)) + 1e-8), p, m, v)
    return p, m, v


def test_adam_training_traces_match_jax():
    """Three training steps of the example's Adam update on the kernel
    path of both packages: the loss traces agree."""
    x, y = _data()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    pj = _jax_params(_params())
    mj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    vj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    pt = _torch_params(_params())
    leaves = torch.utils._pytree.tree_leaves(pt)
    mt = [torch.zeros_like(l) for l in leaves]
    vt = [torch.zeros_like(l) for l in leaves]
    xt, yt = torch.tensor(x), torch.tensor(y)
    lr = 3e-3
    for i in range(3):
        lj, gj = jax.value_and_grad(loss_jax)(pj, xj, yj, "pallas")
        pj, mj, vj = _adam_jax(pj, gj, mj, vj, float(i), lr)
        lt = loss_torch(pt, xt, yt, "cuda")
        gt = torch.autograd.grad(lt, leaves)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
        t = i + 1.0
        with torch.no_grad():
            for leaf, g, m, v in zip(leaves, gt, mt, vt):
                m.mul_(0.9).add_(0.1 * g)
                v.mul_(0.999).add_(0.001 * g * g)
                leaf.sub_(lr * (m / (1 - 0.9 ** t))
                          / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8))
    final = loss_torch(pt, xt, yt, "cuda").item()
    np.testing.assert_allclose(final, float(loss_jax(pj, xj, yj, "pallas")),
                               rtol=RTOL)


def test_chip_smoke_makes_data_as_the_example_does():
    """The port's Sec 4.2 example (whose data, widths and field
    chip_smoke.py imports; the port may not import the JAX example) gives
    the JAX example's images and labels."""
    from repro_torch.examples import image_recognition as port
    example = _load("image_recognition", ROOT / "examples" /
                    "image_recognition.py")
    xs, ys = port.make_data(256, seed=0, device="cpu")
    xe, ye = example.make_data(256, seed=0)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xe))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ye).astype(np.int64))
    assert (port.D, port.HIDDEN, port.N_CLASS) == (
        example.D, example.HIDDEN, example.N_CLASS)
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert smoke.make_data is port.make_data and smoke.field is port.field


def test_chip_smoke_refuses_to_run_without_a_card():
    """With no CUDA device chip_smoke.main() exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert smoke.main() != 0


def test_default_device_is_the_card_or_raises():
    from repro_torch import default_device
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.ones(3, np.float32)})


def test_params_round_trip_keeps_structure():
    tree = {"a": [np.arange(3, dtype=np.float32), (np.ones((2, 2)),)],
            "b": np.float32(2.5)}
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    np.testing.assert_array_equal(back["a"][0], tree["a"][0])
    assert back["a"][1][0].dtype == np.float64
    bf = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["b"].dtype == torch.bfloat16
    assert params_to_numpy(bf)["b"].dtype == np.float32
    with pytest.raises(TypeError):
        params_from_numpy({"x": "not an array"}, device="cpu")
