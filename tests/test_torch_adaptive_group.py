"""One adaptive controller over several ranks (``global_error_norm``) on
2 gloo CPU ranks against the JAX package's ``solve()`` on the whole batch.

The ranks are subprocesses (``tests/torch_adaptive_group_rank.py``)
rendezvousing through a ``FileStore``. Each solves its rows of a (B, D)
batch as one Lockstep system with ALF, the error norm's sum of squares
and count summed over the ranks every trial: the JAX package's GSPMD
solve of the global batch, whose error norm runs over every element.
Cases: float32 and float64 x ``AdaptiveController`` and
``ReproducibleController`` (the JAX package has only the former; the
latter takes the same decisions at another rounding) x MALI and Naive.

* accepted, rejected and f-eval counts equal the JAX package's exactly;
* the error ratio of every trial, and the accepted step times, are
  bit-equal on the ranks (the ranks' parts are added in rank order, the
  same arithmetic everywhere);
* under ``ReproducibleController`` the ratios, the step times and the end
  state are bit-equal to the port's own one-rank solve of the whole batch
  in float32 and float64 (its float32 squares summed in float64 are
  exact in any order), and MALI's float64 gradients within 1e-12 of it;
  every other value and gradient within 1e-5 relative of it (the step
  sizes are float32 in both packages, so in float64 too an ulp of a
  float32 sum order moves a step size);
* against the JAX package, the accepted step times (float32 in both
  packages, its ``integrate.py`` grid) at ``tests/test_torch_solve.py``'s
  bar, and the end states and gradients (every row of z0, the parameters
  summed over the ranks) within ``ADAPTIVE_TOL``, the bar of the port's
  adaptive solves against the JAX package (tests/test_torch_dp_train.py):
  the port's one-rank solve itself is 9.7e-6 from it on this input;
* Naive's gradient flows through the step sizes into the error norm, and
  so across the ranks: the reduction's backward sums the cotangent over
  the group (``psum``'s transpose). Without it the gradients part from
  the whole batch's by ~1e-2;
* the reduction runs once a trial (``error_norm@data``), its backward
  once a trial that reaches the loss under Naive and never under MALI.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

import torch_adaptive_group_rank as R

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
# max |got - want| / max |want|, against the port's one-rank solve
ONE_RANK = 1e-5
# ... and the JAX package's (tests/test_torch_dp_train.py's ADAPTIVE_TOL)
ADAPTIVE_TOL = 2e-5
# accepted step times against the JAX package (tests/test_torch_solve.py)
TS_JAX = dict(rtol=1e-6, atol=1e-7)


def _spawn(tmp: Path):
    out = tmp / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_adaptive_group_rank.py"),
         str(r), str(WORLD), str(tmp / "store"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp) for r in range(WORLD)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=170))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (so, se)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r}: {so[-2000:]}{se[-3000:]}"
        assert f"RANK_OK {r}" in so
    return out, json.loads((out / "result.json").read_text())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("adaptive_group"))


def _f_jax(p, z, t):
    return jnp.tanh(z @ p["w"] + p["b"]) - z + p["c"] * jnp.sin(3.0 * t)


def _jax_case(dtype, method):
    """The JAX package's solve of the whole batch: (end state, gradients
    by name, counters, accepted step times)."""
    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        p_np, z_np, w_np = R.inputs(dtype)
        params = {k: jnp.asarray(v) for k, v in p_np.items()}
        z0, wout = jnp.asarray(z_np), jnp.asarray(w_np)
        kw = dict(solver=J.ALF(eta=R.ETA),
                  controller=J.AdaptiveController(R.RTOL, R.ATOL,
                                                  R.MAX_STEPS))
        gradient = J.MALI() if method == "mali" else J.Naive()

        def loss(p, z):
            sol = J.solve(_f_jax, p, z, 0.0, R.T1, gradient=gradient, **kw)
            return jnp.sum(sol.ys * wout), sol

        (_, sol), (gp, gz) = jax.value_and_grad(loss, argnums=(0, 1),
                                                has_aux=True)(params, z0)
        steps = J.solve(_f_jax, params, z0, 0.0, R.T1, gradient=J.Naive(),
                        saveat=J.SaveAt(steps=True), **kw)
        live = int(steps.num_steps) + 1
        grads = {f"g_{k}": np.asarray(v) for k, v in gp.items()}
        grads["g_z0"] = np.asarray(gz)
        stats = [int(sol.stats.n_accepted), int(sol.stats.n_rejected),
                 int(sol.stats.n_fevals)]
        return (np.asarray(sol.ys), grads, stats,
                np.asarray(steps.ts[:live], np.float64))
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_whole(dtype, ctrl, method):
    """The port's one-rank solve of the whole batch: (end state,
    gradients by name, every trial's error ratio, accepted step times)."""
    p_np, z_np, w_np = R.inputs(dtype)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    z0 = torch.tensor(z_np, requires_grad=True)
    kw = dict(solver=T.ALF(eta=R.ETA), controller=R.controller(ctrl))
    R.LOG.clear()
    sol = T.solve(R.field, params, z0, 0.0, R.T1,
                  gradient=T.MALI() if method == "mali" else T.Naive(), **kw)
    ratios = torch.stack(R.LOG).double().numpy()
    g = torch.autograd.grad(torch.sum(sol.ys * torch.tensor(w_np)),
                            [params[k] for k in sorted(params)] + [z0])
    grads = {f"g_{k}": v.numpy() for k, v in zip(sorted(params), g[:-1])}
    grads["g_z0"] = g[-1].numpy()
    with torch.no_grad():
        steps = T.solve(R.field, {k: v.detach() for k, v in params.items()},
                        z0.detach(), 0.0, R.T1, gradient=T.Naive(),
                        saveat=T.SaveAt(steps=True), **kw)
    ts = steps.ts[:int(steps.n_live)].double().numpy()
    return sol.ys.detach().numpy(), grads, ratios, ts


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("case", R.CASES)
def test_global_controller_matches_jax_whole_batch(spawned, case):
    out, meta = spawned
    dtype, ctrl, method = case.split("_")
    got = dict(np.load(out / f"{case}.npz"))
    m = meta[case]
    ys, grads, stats, ts = _jax_case(dtype, method)
    # the counters, exactly
    assert got["stats"].tolist() == stats, (case, got["stats"], stats)
    assert stats[1] > 0                      # the decisions include rejects
    # one decision on every rank
    assert m["ratios_equal"] and m["ts_equal"], case
    assert m["ratio_dtype"] == "torch.float32"
    # against the port's own solve of the whole batch
    ys1, grads1, ratios1, ts1 = _port_whole(dtype, ctrl, method)
    assert got["ratios"].shape == ratios1.shape
    assert got["ts"].shape == ts1.shape == ts.shape, case
    if ctrl == "reproducible":
        for name, one in (("ratios", ratios1), ("ts", ts1), ("ys", ys1)):
            np.testing.assert_array_equal(got[name], one, err_msg=case)
    np.testing.assert_allclose(got["ts"], ts1, **TS_JAX, err_msg=case)
    assert _rel(got["ys"], ys1) <= ONE_RANK, case
    exact = dtype == "float64" and ctrl == "reproducible" and method == "mali"
    for name, one in grads1.items():
        bar = 1e-12 if exact else ONE_RANK
        assert _rel(got[name], one) <= bar, (case, name, _rel(got[name], one))
    # against the JAX package
    np.testing.assert_allclose(got["ts"], ts, **TS_JAX, err_msg=case)
    assert _rel(got["ys"], ys) <= ADAPTIVE_TOL, (case, _rel(got["ys"], ys))
    for name, want in grads.items():
        assert _rel(got[name], want) <= ADAPTIVE_TOL, (
            case, name, _rel(got[name], want))
    # the reduction: once a trial; its backward only where autograd
    # reaches the norm
    assert m["norm_calls"] == m["norm_axis_calls"] == m["n_trials"] \
        == stats[0] + stats[1]
    if method == "mali":
        assert m["norm_vjp_calls"] == 0
    else:
        assert 0 < m["norm_vjp_calls"] <= m["n_trials"]


def test_global_error_norm_is_the_identity_without_a_group():
    """No group: the norm is :func:`error_ratio`'s, bit for bit."""
    from repro_torch.core.stepsize import error_ratio, global_error_norm
    rng = np.random.default_rng(0)
    err, z0, z1 = (torch.tensor(rng.standard_normal((4, 5)),
                                dtype=torch.float32) for _ in range(3))
    with global_error_norm(None):
        inside = T.AdaptiveController(1e-3, 1e-4).error_ratio(err, z0, z1)
    assert torch.equal(inside, error_ratio(err, z0, z1, 1e-3, 1e-4))
