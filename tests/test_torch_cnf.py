"""The port's continuous normalizing flow (``repro_torch.cnf``), its vector
field (``repro_torch.models.vfield``) and synthetic data
(``repro_torch.data``), against the JAX package on the CPU.

Ports the cases of tests/test_cnf.py (estimator algebra, ``PerSample``
batching, fixed noise per solve, the analytic linear flow for
every gradient method, sampling, the losses), then holds ``log_prob``,
its MALI gradient and ``sample`` to the JAX package with the same
weights and the same probe, at DIM = 16 and at the image CNF's DIM = 784
(hidden 8): log densities within 1e-5 relative, gradients within 1e-5
relative to their largest entry. The two packages draw probes from
different generators, so the JAX probe is handed to the port's
``_state0`` through an estimator that returns it; the port's own draw is
checked for its distribution only.
"""
import dataclasses
import math
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
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jax_make_batch
from repro.data import make_image_batch as jax_make_image_batch
from repro.models import mlp_vfield as mlp_j
from repro_torch import params_from_numpy, params_to_numpy
from repro_torch import tree_util
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, make_batch, make_image_batch
from repro_torch.models import init_mlp_vfield, mlp_vfield

torch.set_num_threads(1)

D = 4
RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {
    "mali": (T.MALI(), T.ALF()),
    "mali_cuda": (T.MALI(), T.ALF(backend="cuda")),
    "naive": (T.Naive(), T.ALF()),
    "aca": (T.ACA(), T.HeunEuler()),
    "adjoint": (T.Backsolve(), T.Dopri5()),
}
JAX_CONFIGS = {
    "mali": (J.MALI(), J.ALF()), "mali_cuda": (J.MALI(), J.ALF()),
    "naive": (J.Naive(), J.ALF()), "aca": (J.ACA(), J.HeunEuler()),
    "adjoint": (J.Backsolve(), J.Dopri5()),
}


@dataclasses.dataclass(frozen=True, eq=False)
class FixedProbe(TC.Hutchinson):
    """Hutchinson with a given probe: hands the JAX package's draw to the
    port's ``_state0``."""
    probe: Any = None

    def init_noise(self, generator, x):
        return self.probe


def _linear_field(params, z, t):
    return params["a"] * z


def _np_vfield(dim, hidden, seed=3, scale=0.3):
    """Seeded numpy weights of an MLP field, every leaf nonzero (the init
    zeroes the output layer, which makes the trace vanish)."""
    rng = np.random.default_rng(seed)
    widths = [dim + 1, hidden, hidden, dim]
    return {"layers": [
        {"b": (scale * rng.standard_normal(b)).astype(np.float32),
         "w": (scale * rng.standard_normal((a, b)) / math.sqrt(a))
         .astype(np.float32)}
        for a, b in zip(widths[:-1], widths[1:])]}


def _tp(np_params):
    return params_from_numpy(np_params, device="cpu")


def _jp(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _mlp_params(scale=0.3):
    return _tp(_np_vfield(D, 16, scale=scale))


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

def test_exact_trace_recovers_jacobian_trace():
    a = torch.randn(D, D, generator=torch.Generator().manual_seed(1))

    def f(z):
        return z @ a.T

    z = torch.randn(D, generator=torch.Generator().manual_seed(2))
    fz, tr = TC.Exact().value_and_trace(f, z, None)
    np.testing.assert_allclose(fz.numpy(), f(z).numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(tr), float(torch.trace(a)), rtol=1e-5)


def test_hutchinson_rademacher_exact_on_diagonal_field():
    # sign probes square to one: eps^T diag(d) eps == tr for any eps
    diag = torch.tensor([0.5, -1.0, 2.0, 0.25])
    z = torch.ones(D)
    est = TC.Hutchinson()
    eps = est.init_noise(torch.Generator().manual_seed(0), z)
    assert set(eps.tolist()) <= {-1.0, 1.0}
    _, tr = est.value_and_trace(lambda zz: diag * zz, z, eps)
    np.testing.assert_allclose(float(tr), float(torch.sum(diag)), rtol=1e-6)


def test_hutchinson_probe_distributions():
    """The port's own draws: Rademacher signs balanced, Gaussian unit
    variance, both unbiased for the trace of a random matrix."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(D, D, generator=gen)
    x = torch.zeros(8192, D)
    for est in (TC.get_estimator("hutchinson"),
                TC.get_estimator("hutchinson_gaussian")):
        eps = est.init_noise(gen, x)
        assert eps.shape == x.shape and eps.dtype == x.dtype
        assert abs(float(eps.mean())) < 0.03
        assert abs(float(eps.var()) - 1.0) < 0.05
        trs = torch.func.vmap(lambda e: est.value_and_trace(
            lambda z: z @ a.T, torch.zeros(D), e)[1])(eps)
        np.testing.assert_allclose(float(trs.mean()), float(torch.trace(a)),
                                   atol=0.25)
    rad = TC.Hutchinson().init_noise(gen, x)
    assert set(torch.unique(rad).tolist()) == {-1.0, 1.0}


def test_hutchinson_requires_generator():
    with pytest.raises(ValueError, match="probe per solve"):
        TC.Hutchinson().init_noise(None, torch.zeros(D))
    with pytest.raises(ValueError, match="rademacher"):
        TC.Hutchinson(dist="sobol")


def test_estimator_registry():
    assert set(TC.TRACE_ESTIMATORS) == {"exact", "hutchinson",
                                        "hutchinson_gaussian"}
    assert isinstance(TC.get_estimator("exact"), TC.Exact)
    assert TC.get_estimator("hutchinson_gaussian").dist == "gaussian"
    est = TC.Hutchinson()
    assert TC.get_estimator(est) is est
    with pytest.raises(ValueError, match="unknown trace estimator"):
        TC.get_estimator("cholesky")
    assert TC.Exact().trace_fevals(D) == D
    assert TC.Hutchinson().trace_fevals(D) == 1


# ---------------------------------------------------------------------------
# Flow densities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_log_prob_matches_analytic_linear_flow(method):
    gradient, solver = CONFIGS[method]
    a = 0.4
    flow = TC.CNF(_linear_field, D, estimator=TC.Exact())
    x = torch.randn(6, D, generator=torch.Generator().manual_seed(5))
    r = flow.log_prob({"a": torch.tensor(a)}, x, solver=solver,
                      controller=T.ConstantSteps(64), gradient=gradient)
    z_t1 = x.numpy() * math.exp(a)
    want_logp = (-0.5 * np.sum(z_t1 ** 2, -1)
                 - 0.5 * D * math.log(2 * math.pi) + D * a)
    np.testing.assert_allclose(r.logdet.numpy(), np.full((6,), D * a),
                               rtol=1e-4)
    np.testing.assert_allclose(r.logp.numpy(), want_logp, rtol=1e-3)


def test_identity_init_logdet_zero():
    # the zero output layer => f == 0 => the flow is the identity and
    # log_prob is exactly the base density
    fp = init_mlp_vfield(torch.Generator().manual_seed(3), D, hidden=16,
                         device="cpu")
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Exact())
    x = torch.randn(5, D, generator=torch.Generator().manual_seed(6))
    r = flow.log_prob(fp, x, controller=T.ConstantSteps(4))
    np.testing.assert_allclose(r.logdet.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(r.logp.numpy(), flow._base_logp(x).numpy(),
                               rtol=1e-6)


def test_fixed_noise_same_generator_bit_equal_under_adaptive():
    fp = _mlp_params()
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Hutchinson())
    x = torch.randn(8, D, generator=torch.Generator().manual_seed(7))
    runs = [flow.log_prob(fp, x, torch.Generator().manual_seed(s),
                          controller=T.AdaptiveController())
            for s in (0, 0, 77)]
    # bit-equal: the probe lives in the solve's state, so the estimate is
    # a function of (params, x, probe) under any step schedule
    assert torch.equal(runs[0].logdet, runs[1].logdet)
    assert torch.equal(runs[0].logp, runs[1].logp)
    assert bool(torch.any(runs[0].logdet != runs[2].logdet))


def test_hutchinson_mean_approaches_exact():
    fp = _mlp_params()
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(8))
    exact = TC.CNF(mlp_vfield, D, estimator=TC.Exact()).log_prob(
        fp, x, controller=T.ConstantSteps(8)).logdet
    hflow = TC.CNF(mlp_vfield, D, estimator=TC.Hutchinson())
    gen = torch.Generator().manual_seed(0)
    hs = torch.stack([hflow.log_prob(fp, x, gen,
                                     controller=T.ConstantSteps(8)).logdet
                      for _ in range(64)])
    bias = float((hs.mean(0) - exact).abs().mean())
    spread = float(hs.std(0).mean())
    assert bias < 3.0 * spread / math.sqrt(64) + 5e-2, (bias, spread)


def test_per_sample_batching_and_string_estimator():
    """The string estimator resolves and runs (under Lockstep, equal to
    the unbatched solve); ``log_prob`` with ``PerSample()`` and an
    adaptive controller (each sample's ``_aug`` takes its unbatched
    branch under the per-row vmap) equals the JAX package's, given the
    JAX probe, with per-row counters equal."""
    fp = _mlp_params()
    flow = TC.CNF(mlp_vfield, D, estimator="hutchinson")
    assert isinstance(flow.estimator, TC.Hutchinson)
    x = torch.randn(6, D, generator=torch.Generator().manual_seed(10))
    kw = dict(controller=T.AdaptiveController())
    r = flow.log_prob(fp, x, torch.Generator().manual_seed(0),
                      batching=T.Lockstep(), **kw)
    plain = flow.log_prob(fp, x, torch.Generator().manual_seed(0), **kw)
    assert r.logp.shape == (6,)
    assert torch.equal(r.logp, plain.logp)
    assert tuple(r.solution.stats.per_sample.n_fevals.shape) == (6,)

    np_params = _np_vfield(D, 16)
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax.random.rademacher(key, x.shape, jnp.float32))
    jflow, tflow = _flows(D, "hutchinson", eps)
    want = jflow.log_prob(_jp(np_params), jnp.asarray(x.numpy()), key,
                          batching=J.PerSample(),
                          controller=J.AdaptiveController())
    got = tflow.log_prob(_tp(np_params), x, batching=T.PerSample(), **kw)
    assert got.logp.shape == (6,)
    assert _rel(got.logp.detach(), want.logp) <= RTOL
    for c_t, c_j in zip(got.solution.stats.per_sample,
                        want.solution.stats.per_sample):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_diff_bounds_through_log_prob():
    fp = _mlp_params()
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Hutchinson())
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(11))
    t1 = torch.tensor(1.0, requires_grad=True)
    r = flow.log_prob(fp, x, torch.Generator().manual_seed(0),
                      controller=T.ConstantSteps(8), t1=t1, diff_bounds=True)
    (g,) = torch.autograd.grad(TC.nll_nats(r), [t1])
    assert math.isfinite(float(g)) and float(g) != 0.0


# ---------------------------------------------------------------------------
# Sampling & losses
# ---------------------------------------------------------------------------

def test_sample_shapes_and_flow_path():
    fp = _mlp_params()
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Hutchinson())
    sol = flow.sample(fp, torch.Generator().manual_seed(0), 5,
                      controller=T.ConstantSteps(4))
    assert sol.ys[0].shape == (5, D)
    path = flow.sample(fp, torch.Generator().manual_seed(0), 5,
                       controller=T.ConstantSteps(2),
                       saveat=T.SaveAt(ts=torch.linspace(1.0, 0.0, 3)))
    assert path.ys[0].shape == (3, 5, D)


def test_sample_log_prob_round_trip():
    fp = _mlp_params(scale=0.1)
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Exact())
    xs = flow.sample(fp, torch.Generator().manual_seed(0), 16,
                     controller=T.ConstantSteps(16)).ys[0]
    r = flow.log_prob(fp, xs, controller=T.ConstantSteps(16))
    assert bool(torch.isfinite(r.logp).all())
    assert float(r.logp.mean()) > -10.0 * D


def test_losses_bookkeeping():
    fp = _mlp_params()
    flow = TC.CNF(mlp_vfield, D, estimator=TC.Exact())
    x = torch.randn(8, D, generator=torch.Generator().manual_seed(12))
    r = flow.log_prob(fp, x, controller=T.ConstantSteps(4))
    nll = float(TC.nll_nats(r))
    np.testing.assert_allclose(nll, -float(r.logp.mean()), rtol=1e-6)
    np.testing.assert_allclose(
        float(TC.bits_per_dim(r, D, n_bins=256)),
        nll / (D * math.log(2.0)) + math.log2(256.0), rtol=1e-6)
    assert float(TC.cnf_loss(r, kinetic_reg=0.0)) == pytest.approx(nll)
    assert float(TC.cnf_loss(r, kinetic_reg=0.5)) > float(
        TC.cnf_loss(r, kinetic_reg=0.0))
    assert float(r.kinetic.min()) >= 0.0


# ---------------------------------------------------------------------------
# Against the JAX package: same weights, same probe
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flows(dim, estimator, eps_np):
    if estimator == "exact":
        return (JC.CNF(mlp_j, dim, estimator=JC.Exact()),
                TC.CNF(mlp_vfield, dim, estimator=TC.Exact()))
    return (JC.CNF(mlp_j, dim, estimator=JC.Hutchinson()),
            TC.CNF(mlp_vfield, dim,
                   estimator=FixedProbe(probe=torch.tensor(eps_np))))


# (dim, hidden, batch, estimator, method): DIM 16 for every method and
# both estimators, the image CNF's DIM 784 with Hutchinson (the exact
# trace there is 784 JVPs a state)
PARITY = ([(16, 8, 6, est, m) for est in ("exact", "hutchinson")
           for m in sorted(CONFIGS)]
          + [(784, 8, 4, "hutchinson", m) for m in ("mali", "mali_cuda",
                                                    "naive")])


@pytest.mark.parametrize("dim,hidden,batch,estimator,method", PARITY,
                         ids=[f"d{d}-{e}-{m}" for d, _, _, e, m in PARITY])
def test_log_prob_and_gradient_match_jax(dim, hidden, batch, estimator,
                                         method):
    """``cnf_loss(log_prob)`` and its gradient, the JAX probe handed to
    the port."""
    np_params = _np_vfield(dim, hidden)
    x = np.random.default_rng(1).standard_normal((batch, dim)).astype(
        np.float32)
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax.random.rademacher(key, x.shape, jnp.float32))
    flow_j, flow_t = _flows(dim, estimator, eps)
    gj, sj = JAX_CONFIGS[method]
    gt, st = CONFIGS[method]

    def loss_j(p):
        r = flow_j.log_prob(p, jnp.asarray(x), key, solver=sj,
                            controller=J.ConstantSteps(8), gradient=gj)
        return JC.cnf_loss(r, kinetic_reg=0.05), r

    (l_j, r_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        _jp(np_params))
    params = _tp(np_params)
    leaves = tree_util.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    r_t = flow_t.log_prob(params, torch.tensor(x), None, solver=st,
                          controller=T.ConstantSteps(8), gradient=gt)
    l_t = TC.cnf_loss(r_t, kinetic_reg=0.05)
    g_t = tree_util.tree_unflatten(
        torch.autograd.grad(l_t, leaves), tree_util.tree_flatten(params)[1])
    for name in ("logp", "logdet", "kinetic"):
        assert _rel(getattr(r_t, name).detach(), getattr(r_j, name)) <= RTOL
    assert _rel(float(l_t.detach()), float(l_j)) <= RTOL
    # the same sorted-key trees: compare leaf by leaf
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(g_t)),
                    jax.tree_util.tree_leaves(g_j)):
        assert _rel(a, b) <= RTOL
    assert int(r_t.solution.stats.n_fevals) == int(
        r_j.solution.stats.n_fevals)


@pytest.mark.parametrize("dim,hidden", [(16, 8), (784, 8)])
def test_sample_matches_jax(dim, hidden):
    """``sample``: the port's draw (z from the generator, then the probe)
    integrated in reverse time, against the JAX package's solve of its
    own augmented dynamics from the same z and probe."""
    np_params = _np_vfield(dim, hidden)
    n = 4
    eps = np.asarray(jax.random.rademacher(jax.random.PRNGKey(2), (n, dim),
                                           jnp.float32))
    flow_j, flow_t = _flows(dim, "hutchinson", eps)
    ts = (1.0, 0.5, 0.0)
    sol_t = flow_t.sample(_tp(np_params), torch.Generator().manual_seed(9),
                          n, controller=T.ConstantSteps(4),
                          saveat=T.SaveAt(ts=torch.tensor(ts)))
    z = torch.randn((n, dim), generator=torch.Generator().manual_seed(9))
    zeros = jnp.zeros((n,), jnp.float32)
    sol_j = J.solve(flow_j._aug, _jp(np_params),
                    (jnp.asarray(z.numpy()), zeros, zeros, jnp.asarray(eps)),
                    solver=J.ALF(), controller=J.ConstantSteps(4),
                    gradient=J.MALI(), saveat=J.SaveAt(ts=jnp.asarray(ts)))
    assert sol_t.ys[0].shape == (3, n, dim)
    np.testing.assert_array_equal(sol_t.ys[0][0].numpy(), z.numpy())
    for got, want in zip(sol_t.ys[:3], sol_j.ys[:3]):
        assert _rel(got, want) <= RTOL
    np.testing.assert_array_equal(sol_t.ys[3][0].numpy(), eps)


def test_lockstep_log_prob_matches_jax():
    """``batching`` passes through ``log_prob``: Lockstep on both sides."""
    np_params = _np_vfield(16, 8)
    x = np.random.default_rng(2).standard_normal((6, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.rademacher(key, x.shape, jnp.float32))
    flow_j, flow_t = _flows(16, "hutchinson", eps)
    r_j = flow_j.log_prob(_jp(np_params), jnp.asarray(x), key,
                          controller=J.ConstantSteps(8),
                          batching=J.Lockstep())
    r_t = flow_t.log_prob(_tp(np_params), torch.tensor(x),
                          controller=T.ConstantSteps(8),
                          batching=T.Lockstep())
    assert _rel(r_t.logp, r_j.logp) <= RTOL
    np.testing.assert_array_equal(
        r_t.solution.stats.per_sample.n_fevals.numpy(),
        np.asarray(r_j.solution.stats.per_sample.n_fevals))


# ---------------------------------------------------------------------------
# Vector field, parameter conversion, data
# ---------------------------------------------------------------------------

def test_vfield_init_and_value_match_jax():
    gen = torch.Generator().manual_seed(0)
    fp = init_mlp_vfield(gen, 6, hidden=5, depth=3, device="cpu")
    shapes = [(tuple(l["w"].shape), tuple(l["b"].shape))
              for l in fp["layers"]]
    assert shapes == [((7, 5), (5,)), ((5, 5), (5,)), ((5, 5), (5,)),
                      ((5, 6), (6,))]
    assert not bool(fp["layers"][-1]["w"].any())
    again = init_mlp_vfield(torch.Generator().manual_seed(0), 6, hidden=5,
                            depth=3, device="cpu")
    for a, b in zip(tree_util.tree_leaves(fp), tree_util.tree_leaves(again)):
        assert torch.equal(a, b)
    np_params = _np_vfield(6, 5)
    z = np.random.default_rng(3).standard_normal((2, 3, 6)).astype(
        np.float32)
    got = mlp_vfield(_tp(np_params), torch.tensor(z), torch.tensor(0.3))
    want = mlp_j(_jp(np_params), jnp.asarray(z), jnp.float32(0.3))
    assert _rel(got, want) <= 1e-6


def test_vfield_params_round_trip_through_numpy():
    """``params_from_numpy``/``params_to_numpy`` carry the field's
    ``{"layers": [{"w", "b"}, ...]}`` tree both ways."""
    fp = init_mlp_vfield(torch.Generator().manual_seed(1), 4, hidden=3,
                         device="cpu")
    back = params_from_numpy(params_to_numpy(fp), device="cpu")
    assert [sorted(l) for l in back["layers"]] == [["b", "w"]] * 3
    for a, b in zip(tree_util.tree_leaves(fp), tree_util.tree_leaves(back)):
        assert torch.equal(a, b)
    np_params = _np_vfield(4, 3)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    jax.tree_util.tree_leaves(
                        params_to_numpy(_tp(np_params)))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (3, 1, 2)])
def test_image_batches_bit_equal_to_jax(step, shard, n_shards):
    got = make_image_batch(DataConfig(seed=4, global_batch=8), step, shard,
                           n_shards)
    want = jax_make_image_batch(JDataConfig(seed=4, global_batch=8), step,
                                shard, n_shards)
    assert got["image"].shape == (8 // n_shards, 784)
    np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-76b"])
def test_token_batches_bit_equal_to_jax(arch):
    dcfg, jdcfg = (DataConfig(seed=1, global_batch=4, seq_len=16),
                   JDataConfig(seed=1, global_batch=4, seq_len=16))
    got = make_batch(smoke_config(arch), dcfg, 2)
    want = jax_make_batch(jax_smoke_config(arch), jdcfg, 2)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_importing_the_new_modules_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.cnf, repro_torch.data, repro_torch.tree_util\n"
            "import repro_torch.models.vfield\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
