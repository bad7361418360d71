"""The port's examples (``repro_torch.examples``) against the JAX package's
example programs (``examples/*.py``) on the CPU.

The JAX side is the example file itself, loaded by path (``quickstart.py``
runs at import, so its figures come from ``repro.core`` directly). Weights
are the JAX examples' own draws, carried over through numpy; data is drawn
with numpy by both, and must be equal. Probes and base draws come from
JAX keys and are handed to the port. Bars: values and gradients within
rtol 1e-5 / atol 1e-6 (the CNFs 1e-5 / 1e-5), counters exactly.

The quickstart's figures come from ``tests/jax_quickstart_figures.py`` run
without FMA (``XLA_FLAGS=--xla_cpu_max_isa=AVX``): XLA then rounds every
product, as the JAX package does op by op and as the port does. With FMA
the stiffest ``PerSample`` row takes 103 accepted steps where without it
it takes 125 (ROADMAP queue 3, F2).
"""
import ast
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cnf as JC
import repro.core as J
import repro_torch.cnf as TC
import repro_torch.core as T
from repro_torch import params_from_numpy, params_to_numpy, tree_util
from repro_torch.examples import (cnf_image, cnf_toy, image_recognition,
                                  lm_continuous_depth, quickstart,
                                  time_series_latent_ode)
from repro_torch.examples._common import Adam

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
CNF_RTOL, CNF_ATOL = 1e-5, 1e-5
NAMES = ("quickstart", "image_recognition", "time_series_latent_ode",
         "cnf_toy", "cnf_image", "lm_continuous_depth")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jex():
    """The JAX example modules of the paper's experiments (the quickstart
    is a module-level script; the LM driver's JAX Trainer is no
    oracle)."""
    return {name: _load(name) for name in NAMES[1:-1]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tp(np_tree):
    return params_from_numpy(np_tree, device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """Every leaf of a torch tree and of a JAX or numpy tree (sorted keys)
    within the bar."""
    g = jax.tree_util.tree_leaves(params_to_numpy(got))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=what)


def _torch_grads(loss_of, params):
    """The loss of ``params`` and its gradient tree."""
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss = loss_of(tree_util.tree_unflatten(leaves, spec))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_util.tree_unflatten(list(grads), spec)


def _jax_adam(p, g, m, v, i, lr):
    tm = jax.tree_util.tree_map
    m = tm(lambda a, b: 0.9 * a + 0.1 * b, m, g)
    v = tm(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
    t = i + 1.0
    p = tm(lambda pp, mm, vv: pp - lr * (mm / (1 - 0.9 ** t)) /
           (jnp.sqrt(vv / (1 - 0.999 ** t)) + 1e-8), p, m, v)
    return p, m, v


# ---------------------------------------------------------------------------
# Paper Sec 4.2: image_recognition
# ---------------------------------------------------------------------------

IR_N = 256


@pytest.fixture(scope="module")
def ir(jex):
    ex = jex["image_recognition"]
    xj, yj = ex.make_data(IR_N, seed=0)
    p_np = _np(ex.init_params(jax.random.PRNGKey(0)))
    return ex, xj, yj, p_np


def test_image_data_as_the_example_makes_it(ir):
    ex, xj, yj, _ = ir
    xt, yt = image_recognition.make_data(IR_N, seed=0, device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (image_recognition.D, image_recognition.HIDDEN,
            image_recognition.N_CLASS) == (ex.D, ex.HIDDEN, ex.N_CLASS)


def _ir_loss_jax(ex, p, x, y, mode):
    logp = jax.nn.log_softmax(ex.forward(p, x, mode))
    return -jnp.take_along_axis(logp, y[:, None], 1).mean()


@pytest.mark.parametrize("mode", ["resnet", "node"])
def test_image_loss_and_gradients(ir, mode):
    ex, xj, yj, p_np = ir
    lj, gj = jax.value_and_grad(
        lambda p: _ir_loss_jax(ex, p, xj, yj, mode))(
            jax.tree_util.tree_map(jnp.asarray, p_np))
    xt, yt = image_recognition.make_data(IR_N, seed=0, device="cpu")
    lt, gt = _torch_grads(
        lambda p: image_recognition.loss_fn(p, xt, yt, mode), _tp(p_np))
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    _close(gt, gj, what=f"{mode} gradients")


@pytest.mark.parametrize("mode", ["resnet", "node"])
def test_image_train_steps_and_invariance(ir, mode):
    """5 Adam steps of ``train`` in both packages: the last loss and the
    weights; on those weights the five invariance solvers' accuracies
    equal."""
    ex, xj, yj, p_np = ir
    pj, lj = ex.train(jax.tree_util.tree_map(jnp.asarray, p_np), xj, yj,
                      mode, 5)
    xt, yt = image_recognition.make_data(IR_N, seed=0, device="cpu")
    pt, lt = image_recognition.train(_tp(p_np), xt, yt, mode, 5)
    np.testing.assert_allclose(lt, lj, rtol=RTOL)
    _close(pt, pj, rtol=1e-4, atol=1e-5, what="weights after 5 steps")
    if mode == "resnet":
        assert image_recognition.accuracy(pt, xt, yt, "resnet") == \
            ex.accuracy(pj, xj, yj, "resnet")
        return
    same = _tp(_np(pj))
    for solver, n in image_recognition.INVARIANCE:
        assert image_recognition.accuracy(
            same, xt, yt, "node", solver=solver, n_steps=n) == \
            ex.accuracy(pj, xj, yj, "node", solver=solver, n_steps=n), \
            (solver, n)


# ---------------------------------------------------------------------------
# Paper Sec 4.3: time_series_latent_ode
# ---------------------------------------------------------------------------

TS_B = 16


@pytest.fixture(scope="module")
def ts(jex):
    ex = jex["time_series_latent_ode"]
    sj, tsj = ex.make_series(TS_B, seed=0)
    p_np = _np(ex.init_params(jax.random.PRNGKey(0)))
    return ex, sj, tsj, p_np


def test_series_as_the_example_makes_it(ts):
    ex, sj, tsj, _ = ts
    st, tst = time_series_latent_ode.make_series(TS_B, seed=0, device="cpu")
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(tsj))


def _ts_loss_jax(ex, p, data, ts_, method):
    z0 = ex.encode(p, data[:, :ex.T_OBS])
    zs = ex.rollout(p, z0, ts_, method=method)
    return jnp.mean((ex.decode(p, jnp.moveaxis(zs, 0, 1)) - data) ** 2)


@pytest.mark.parametrize("method", ["mali", "naive", "aca", "adjoint"])
def test_latent_ode_loss_and_gradients(ts, method):
    """The loss in float32, and the loss and every gradient in float64
    (both packages), within rtol 1e-5 / atol 1e-6. The float32 gradients
    sit at the model's own rounding floor: the GRU encoder and the latent
    flow amplify a summation order's rounding, so moving every weight by
    one float32 rounding moves the JAX package's own gradients by up to
    8.7e-5 of a leaf's largest entry, and the port's lie up to 5.3e-5
    from them (ROADMAP queue 3, F3)."""
    ex, sj, tsj, p_np = ts
    st, tst = time_series_latent_ode.make_series(TS_B, seed=0, device="cpu")
    lj = _ts_loss_jax(ex, jax.tree_util.tree_map(jnp.asarray, p_np), sj,
                      tsj, method)
    lt = time_series_latent_ode.loss_fn(_tp(p_np), st, tst, method)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)

    p64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64), p_np)
    s64 = np.asarray(sj).astype(np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        lj, gj = jax.value_and_grad(lambda p: _ts_loss_jax(
            ex, p, jnp.asarray(s64), tsj, method))(
                jax.tree_util.tree_map(jnp.asarray, p64))
        lj, gj = float(lj), _np(gj)
    finally:
        jax.config.update("jax_enable_x64", False)
    lt, gt = _torch_grads(
        lambda p: time_series_latent_ode.loss_fn(p, torch.as_tensor(s64),
                                                 tst, method),
        params_from_numpy(p64, device="cpu"))
    np.testing.assert_allclose(float(lt), lj, rtol=RTOL)
    _close(gt, gj, what=f"{method} gradients (float64)")


def test_latent_ode_three_adam_steps(ts):
    """The example's loop, three steps: the losses within rtol 1e-5 (the
    weights move apart at the float32 floor of the gradients, above)."""
    ex, sj, tsj, p_np = ts
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    mj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    vj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    vg = jax.jit(jax.value_and_grad(
        lambda p: _ts_loss_jax(ex, p, sj, tsj, "mali")))
    st, tst = time_series_latent_ode.make_series(TS_B, seed=0, device="cpu")
    opt = Adam(_tp(p_np), 5e-3)
    for i in range(3):
        lj, gj = vg(pj)
        pj, mj, vj = _jax_adam(pj, gj, mj, vj, i, 5e-3)
        lt = time_series_latent_ode.loss_fn(opt.params, st, tst, "mali")
        opt.step(opt.grads(lt), i)
        np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)


# ---------------------------------------------------------------------------
# Paper Sec 4.4: cnf_toy
# ---------------------------------------------------------------------------

TOY_N = 256


@pytest.fixture(scope="module")
def toy(jex):
    """The JAX example's perturbed weights ``fq`` (its bias check's: every
    leaf nonzero), and the 256 moons."""
    ex = jex["cnf_toy"]
    fp = ex.init_mlp_vfield(jax.random.PRNGKey(0), dim=2, hidden=ex.HID,
                            depth=2)
    fq = jax.tree_util.tree_map(
        lambda a, k: a + 0.3 * jax.random.normal(k, a.shape), fp,
        jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(fp),
            list(jax.random.split(jax.random.PRNGKey(7),
                                  len(jax.tree_util.tree_leaves(fp))))))
    return ex, ex.make_moons(TOY_N, seed=0), _np(fq)


def test_moons_as_the_example_makes_them(toy):
    ex, xj, _ = toy
    xt = cnf_toy.make_moons(TOY_N, seed=0, device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert cnf_toy.HID == ex.HID and cnf_toy.KINETIC_REG == ex.KINETIC_REG


@pytest.mark.parametrize("case", ["mali", "naive", "fine"])
def test_toy_nll_and_gradients(toy, case):
    ex, xj, q_np = toy
    kw = ({"method": "naive", "solver_n": ("rk4", 64)} if case == "fine"
          else {"method": case, "reg": ex.KINETIC_REG})
    lj, gj = jax.value_and_grad(lambda p: ex.nll(p, xj, **kw))(
        jax.tree_util.tree_map(jnp.asarray, q_np))
    xt = cnf_toy.make_moons(TOY_N, seed=0, device="cpu")
    lt, gt = _torch_grads(lambda p: cnf_toy.nll(p, xt, **kw), _tp(q_np))
    np.testing.assert_allclose(float(lt), float(lj), rtol=CNF_RTOL)
    _close(gt, gj, rtol=CNF_RTOL, atol=CNF_ATOL, what=f"{case} gradients")


def test_toy_end_time_cotangent(toy):
    ex, xj, q_np = toy
    gj = jax.grad(lambda t1: JC.nll_nats(ex.FLOW.log_prob(
        jax.tree_util.tree_map(jnp.asarray, q_np), xj,
        controller=J.ConstantSteps(8), t1=t1, diff_bounds=True)))(
            jnp.asarray(1.0))
    t1 = torch.tensor(1.0, requires_grad=True)
    (gt,) = torch.autograd.grad(TC.nll_nats(cnf_toy.FLOW.log_prob(
        _tp(q_np), cnf_toy.make_moons(TOY_N, seed=0, device="cpu"),
        solver=T.ALF(backend="cuda"), controller=T.ConstantSteps(8), t1=t1,
        diff_bounds=True)), t1)
    np.testing.assert_allclose(float(gt), float(gj), rtol=CNF_RTOL,
                               atol=CNF_ATOL)


def test_toy_flow_path_from_the_same_base_draws(toy, monkeypatch):
    """``flow_path`` (``CNF.sample`` over a descending grid) from the JAX
    example's base draws: the port's ``torch.randn`` in the flow module is
    swapped for the JAX draw."""
    ex, _, q_np = toy
    key = jax.random.PRNGKey(2)
    flow_ts = jnp.linspace(1.0, 0.0, 5)
    want = ex.FLOW.sample(jax.tree_util.tree_map(jnp.asarray, q_np), key, 8,
                          controller=J.ConstantSteps(2),
                          saveat=J.SaveAt(ts=flow_ts)).ys[0]
    base = torch.as_tensor(np.asarray(jax.random.normal(
        jax.random.split(key)[0], (8, 2))))
    flow_mod = importlib.import_module("repro_torch.cnf.flow")

    class _Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def randn(shape, generator=None, device=None):
            assert tuple(shape) == (8, 2)
            return base.clone()

    monkeypatch.setattr(flow_mod, "torch", _Torch())
    got = cnf_toy.flow_path(_tp(q_np), torch.Generator().manual_seed(2),
                            torch.linspace(1.0, 0.0, 5))
    assert tuple(got.shape) == (5, 8, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=CNF_RTOL, atol=CNF_ATOL)


def test_toy_estimator_bias_with_the_jax_probes(toy):
    """The example's bias check on its own states, weights and 64 probes
    (the JAX draws)."""
    ex, _, q_np = toy
    xs = ex.make_moons(1024, seed=0)[:100]
    fq = jax.tree_util.tree_map(jnp.asarray, q_np)
    hutch = JC.Hutchinson()
    probes = [hutch.init_noise(k, xs)
              for k in jax.random.split(jax.random.PRNGKey(0), 64)]
    trace_at = lambda est, zi, ei: est.value_and_trace(  # noqa: E731
        lambda zz: ex.mlp_vfield(fq, zz, 0.3), zi, ei)[1]
    ld_exact = jax.vmap(lambda zi: trace_at(JC.Exact(), zi, None))(xs)
    ld_h = jnp.stack([jax.vmap(lambda zi, ei: trace_at(hutch, zi, ei))(
        xs, e) for e in probes])
    want = float(jnp.abs(ld_h.mean(0) - ld_exact).mean())
    got = cnf_toy.trace_bias(_tp(q_np), torch.as_tensor(np.asarray(xs)),
                             torch.as_tensor(np.asarray(jnp.stack(probes))))
    np.testing.assert_allclose(got, want, rtol=CNF_RTOL)


# ---------------------------------------------------------------------------
# Paper Sec 4.4 at image scale: cnf_image
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FixedProbe(TC.Hutchinson):
    """Hutchinson with a given probe: hands the JAX draw to the port."""
    probe: Any = None

    def init_noise(self, generator, x):
        return self.probe


def test_image_cnf_two_training_steps(jex):
    """Batch 4, hidden 16: two steps of the example's update with the same
    dequantization noise and probes; loss and bits/dim within 1e-5
    relative to the largest entry."""
    ex = jex["cnf_image"]
    from repro.data import DataConfig as JDataConfig
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_host_mesh

    batch, hidden, n_steps = 4, 16, 8
    fp_np = _np(ex.init_mlp_vfield(jax.random.PRNGKey(0), ex.DIM,
                                   hidden=hidden, depth=2))
    flow_j = JC.CNF(ex.mlp_vfield, dim=ex.DIM, estimator=JC.Hutchinson())
    batching_j = J.Sharded(axis="data", inner=J.Lockstep())

    def loss_j(p, x, key):
        res = flow_j.log_prob(p, x, key, solver=J.ALF(),
                              controller=J.ConstantSteps(n_steps),
                              gradient=J.MALI(), batching=batching_j)
        return JC.cnf_loss(res, kinetic_reg=ex.KINETIC_REG), res

    pj = jax.tree_util.tree_map(jnp.asarray, fp_np)
    mj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    vj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    opt = Adam(_tp(fp_np), cnf_image.LR)
    batching_t = T.Sharded(axis="data", inner=T.Lockstep())
    vg_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))
    jmesh = jax_host_mesh()
    if jmesh.shape["data"] != 1:
        pytest.skip("the JAX host mesh has several devices")
    for i in range(2):
        xj = ex.dequantized_batch(JDataConfig(seed=0, global_batch=batch), i,
                                  rng_j)
        xt = cnf_image.dequantized_batch(DataConfig(seed=0,
                                                    global_batch=batch),
                                         i, rng_t, "cpu")
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        key = jax.random.PRNGKey(i)
        with jmesh:
            (lj, res_j), gj = vg_j(pj, xj, key)
        pj, mj, vj = _jax_adam(pj, gj, mj, vj, i, 1e-3)
        probe = torch.as_tensor(np.asarray(JC.Hutchinson().init_noise(key,
                                                                      xj)))
        flow_t = TC.CNF(cnf_image.mlp_vfield, dim=cnf_image.DIM,
                        estimator=FixedProbe(probe=probe))
        with make_host_mesh("cpu"):
            lt, res_t = cnf_image.train_step(flow_t, opt, xt, None, i,
                                             n_steps, batching_t)
        for got, want in ((lt, lj),
                          (TC.bits_per_dim(res_t, cnf_image.DIM),
                           JC.bits_per_dim(res_j, ex.DIM))):
            assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    _close(opt.params, pj, rtol=1e-4, atol=1e-5, what="weights")


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def jax_quickstart():
    """``tests/jax_quickstart_figures.py`` without FMA (module docstring),
    started with the module's first test so that it runs beside them."""
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_quickstart_figures.py")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_cpu_max_isa=AVX"})
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def qs(jax_quickstart):
    """The port's figures and the JAX package's."""
    got = quickstart.main(["--device", "cpu"])
    out, err = jax_quickstart.communicate(timeout=300)
    assert jax_quickstart.returncode == 0, err
    return got, json.loads(out.splitlines()[-1])


def test_quickstart_figures_at_their_printed_precision(qs):
    got, want = qs
    assert f"{got['z_T']:.6f}" == f"{want['z_T']:.6f}" == "2.143163"
    assert [f"{v:.4f}" for v in got["trajectory"]] == \
        [f"{v:.4f}" for v in want["trajectory"]]
    for name in ("mali", "naive", "aca", "adjoint"):
        assert f"{got['dalpha'][name]:.5f}" == \
            f"{want['dalpha'][name]:.5f}", name
    assert got["mali_naive_rel"] == 0.0
    assert f"{got['z_back']:.6f}" == f"{want['z_back']:.6f}" == "1.300000"
    assert [f"{v:.5f}" for v in got["dense"]] == \
        [f"{v:.5f}" for v in want["dense"]] == \
        ["1.44392", "1.66922", "1.96866"]
    assert f"{got['event']['time']:.5f}" == \
        f"{want['event']['time']:.5f}" == "0.86171"
    assert f"{got['event']['z']:.5f}" == f"{want['event']['z']:.5f}"


def test_quickstart_counters_exactly(qs):
    got, want = qs
    assert (got["steps"], got["fevals"]) == (want["steps"], want["fevals"]) \
        == (16, 17)
    assert got["residual_bytes"] == want["residual_bytes"]
    assert got["batching"] == want["batching"]
    assert got["batching"]["lockstep"] == {"fevals": 1168,
                                           "per_row_accepted": [143] * 8}
    assert got["event"]["fired"] is want["event"]["fired"] is True


def test_quickstart_memory_bounds_on_saved_bytes(qs):
    """Sec 3a on the CPU: the bytes saved for the backward from 8 to 64
    steps stay within 1.05x for MALI and grow past 2x for Naive (the JAX
    example's XLA temp bytes: x1.0 against x6.8)."""
    mem = qs[0]["memory"]
    mali = [m["saved_bytes"] for m in mem["mali"]]
    naive = [m["saved_bytes"] for m in mem["naive"]]
    assert mali[1] / mali[0] <= 1.05
    assert naive[1] / naive[0] > 2.0


# ---------------------------------------------------------------------------
# lm_continuous_depth
# ---------------------------------------------------------------------------

def test_lm_continuous_depth_runs_and_recovers():
    """The three trainers and the serve; the example's own assertion (the
    recovered loss trace equals the clean one) holds. The JAX Trainer is
    no oracle here (tests/test_torch_trainer.py)."""
    out = lm_continuous_depth.main(["--steps", "6", "--device", "cpu"])
    assert len(out["clean"]) == len(out["discrete"]) == 6
    assert out["faulted"] == out["clean"]
    assert all(math.isfinite(v) for v in out["clean"] + out["discrete"])
    assert out["serve_tokens"].shape == (2, 8)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _flags(path: Path):
    tree = ast.parse(path.read_text())
    return sorted(node.args[0].value for node in ast.walk(tree)
                  if isinstance(node, ast.Call)
                  and getattr(node.func, "attr", "") == "add_argument")


@pytest.mark.parametrize("name", NAMES)
def test_cli_takes_the_jax_flags_plus_device(name):
    port = ROOT / "src" / "repro_torch" / "examples" / f"{name}.py"
    assert _flags(port) == sorted(_flags(ROOT / "examples" / f"{name}.py")
                                  + ["--device"])
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert callable(mod.main)


@pytest.mark.parametrize("name", NAMES)
def test_cli_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
