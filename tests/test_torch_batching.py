"""The batching axis of the port — ``solve(batching=PerSample() |
Sharded(...) | Lockstep())`` — against its own stacked single solves and
the JAX package on the CPU; the cases of tests/test_batching.py.

(a) ``PerSample()`` equals a Python-stacked loop of single solves, values
    and gradients (params and z0), for the four gradient methods under
    both controllers, with per-row counters exactly equal, and equals the
    JAX package's ``PerSample()`` on the same numpy inputs.
(b) ``Lockstep()`` is the implicit semantics made explicit.
(c) ``stats.per_sample`` rows equal each sample's single solve; the
    scalar counters are their totals.
(d) A finished row's padding steps add exactly nothing to the gradient.
(e) ``Sharded()`` over a ``torch.distributed`` mesh equals
    ``PerSample()``: on a one-process mesh here, and on 2 and 4 gloo
    ranks in subprocesses, on every rank; the validation errors are the
    JAX package's.

TOL is tests/test_batching.py's (rtol 2e-5, atol 2e-6), the done-row
regression its 1e-6 / 1e-7.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.launch.mesh import make_host_mesh

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-6)
ROOT = Path(__file__).resolve().parents[1]

METHOD_AXES = {
    "mali": ((T.MALI(), T.ALF()), (J.MALI(), J.ALF())),
    "naive": ((T.Naive(), T.ALF()), (J.Naive(), J.ALF())),
    "aca": ((T.ACA(), T.HeunEuler()), (J.ACA(), J.HeunEuler())),
    "adjoint": ((T.Backsolve(), T.Dopri5()), (J.Backsolve(), J.Dopri5())),
}


def _ft(params, z, t):
    # per-sample stiffness rides in the state (d rate/dt = 0), so the
    # batch is genuinely heterogeneous for the adaptive controller; keys
    # in sorted order, the order JAX flattens a dict in
    return {"rate": torch.zeros_like(z["rate"]),
            "y": -z["rate"] * z["y"] + params["c"] * torch.sin(3.0 * t)}


def _fj(params, z, t):
    return {"rate": jnp.zeros_like(z["rate"]),
            "y": -z["rate"] * z["y"] + params["c"] * jnp.sin(3.0 * t)}


def _np_setup(nb=3):
    return ({"c": np.float32(0.4)},
            {"rate": np.asarray([0.3, 2.0, 8.0], np.float32)[:nb, None],
             "y": np.linspace(0.6, 1.4, nb, dtype=np.float32)[:, None]})


def _tsetup(nb=3, grad=False):
    p, z = _np_setup(nb)
    return ({k: torch.tensor(v, requires_grad=grad) for k, v in p.items()},
            {k: torch.tensor(v, requires_grad=grad) for k, v in z.items()})


def _jsetup(nb=3):
    p, z = _np_setup(nb)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in z.items()})


def _controllers(fixed):
    if fixed:
        return T.ConstantSteps(3), J.ConstantSteps(3)
    return T.AdaptiveController(1e-2, 1e-3, 32), J.AdaptiveController(
        1e-2, 1e-3, 32)


def _row(tree, i):
    return {k: v[i] for k, v in tree.items()}


def _quiet_solve(pkg, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # PerSample + ConstantSteps warn
        return pkg.solve(*args, **kw)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("method", sorted(METHOD_AXES))
@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "adaptive"])
def test_batched_matches_vmap_and_stacked_singles(method, fixed):
    """PerSample == stacked single solves == the JAX package's PerSample,
    values and gradients (params and z0); per-row counters exact."""
    (tg, ts), (jg, js) = METHOD_AXES[method]
    tc, jc = _controllers(fixed)
    kw = dict(solver=ts, controller=tc, gradient=tg)

    p, z = _tsetup(grad=True)
    sol = _quiet_solve(T, _ft, p, z, 0.0, 1.0, batching=T.PerSample(), **kw)
    g_b = torch.autograd.grad(torch.sum(sol.ys["y"] ** 2),
                              [p["c"], z["rate"], z["y"]])
    ys, g_c, g_rows, counts = [], 0.0, [], []
    for i in range(3):
        p1, z1 = _tsetup(grad=True)
        zi = _row(z1, i)
        s = T.solve(_ft, p1, zi, 0.0, 1.0, **kw)
        gi = torch.autograd.grad(torch.sum(s.ys["y"] ** 2),
                                 [p1["c"], z1["rate"], z1["y"]])
        ys.append(s.ys["y"].detach())
        g_c = g_c + gi[0]
        g_rows.append((gi[1][i], gi[2][i]))
        counts.append([int(s.stats.n_accepted), int(s.stats.n_rejected),
                       int(s.stats.n_fevals)])
    _close(sol.ys["y"].detach(), torch.stack(ys))
    _close(g_b[0], g_c)
    for i, (gr, gy) in enumerate(g_rows):
        _close(g_b[1][i], gr)
        _close(g_b[2][i], gy)
    per = sol.stats.per_sample
    assert [[int(c[i]) for c in per] for i in range(3)] == counts

    # the JAX package's PerSample on the same inputs
    jp, jz = _jsetup()

    def jloss(pp, zz):
        s = J.solve(_fj, pp, zz, 0.0, 1.0, solver=js, controller=jc,
                    gradient=jg, batching=J.PerSample())
        return jnp.sum(s.ys["y"] ** 2), s

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (_, jsol), (jgp, jgz) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jz)
    _close(sol.ys["y"].detach(), jsol.ys["y"])
    _close(g_b[0], jgp["c"])
    _close(g_b[1], jgz["rate"])
    _close(g_b[2], jgz["y"])
    for c_t, c_j in zip(per, jsol.stats.per_sample):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_lockstep_is_explicit_implicit_semantics():
    """Lockstep() == the unbatched solve over the batched state, except
    for the batch-first layout and the per-row stats totals."""
    p, z = _tsetup()
    ctrl = T.AdaptiveController(1e-3, 1e-4, 64)
    implicit = T.solve(_ft, p, z, 0.0, 1.0, gradient=T.MALI(),
                       controller=ctrl)
    explicit = T.solve(_ft, p, z, 0.0, 1.0, gradient=T.MALI(),
                       controller=ctrl, batching=T.Lockstep())
    assert torch.equal(explicit.ys["y"], implicit.ys["y"])
    assert explicit.stats.per_sample.n_accepted.tolist() == [
        int(implicit.stats.n_accepted)] * 3
    assert int(explicit.stats.n_fevals) == 3 * int(implicit.stats.n_fevals)
    dense = T.solve(_ft, p, z, 0.0, 1.0, gradient=T.MALI(),
                    controller=T.ConstantSteps(5), batching=T.Lockstep(),
                    saveat=T.SaveAt(steps=True))
    assert dense.ys["y"].shape[0] == 3
    assert int(dense.stats.n_fevals) == int(
        dense.stats.per_sample.n_fevals.sum())
    assert dense.stats.per_sample.n_accepted.tolist() == [5, 5, 5]
    ts = torch.linspace(0.0, 1.0, 4)
    implicit_t = T.solve(_ft, p, z, gradient=T.MALI(), controller=ctrl,
                         saveat=T.SaveAt(ts=ts))
    explicit_t = T.solve(_ft, p, z, gradient=T.MALI(), controller=ctrl,
                         saveat=T.SaveAt(ts=ts), batching=T.Lockstep())
    assert tuple(explicit_t.ys["y"].shape) == (3, 4, 1)
    assert torch.equal(explicit_t.ys["y"],
                       torch.movedim(implicit_t.ys["y"], 0, 1))


def test_per_sample_stats_match_single_solves():
    """stats.per_sample rows == each sample's own solve stats (and the
    JAX package's rows); scalars are the row totals; the stiff row works
    harder."""
    p, z = _tsetup()
    ctrl = T.AdaptiveController(1e-3, 1e-4, 64)
    sol = T.solve(_ft, p, z, 0.0, 1.0, gradient=T.MALI(), controller=ctrl,
                  batching=T.PerSample())
    per = sol.stats.per_sample
    singles = [T.solve(_ft, p, _row(z, i), 0.0, 1.0, gradient=T.MALI(),
                       controller=ctrl).stats for i in range(3)]
    for i, s in enumerate(singles):
        assert int(per.n_accepted[i]) == int(s.n_accepted)
        assert int(per.n_rejected[i]) == int(s.n_rejected)
        assert int(per.n_fevals[i]) == int(s.n_fevals)
    assert int(sol.stats.n_accepted) == sum(int(s.n_accepted)
                                            for s in singles)
    assert int(sol.stats.n_fevals) == sum(int(s.n_fevals) for s in singles)
    assert int(per.n_accepted[-1]) > int(per.n_accepted[0])
    jp, jz = _jsetup()
    jsol = J.solve(_fj, jp, jz, 0.0, 1.0, gradient=J.MALI(),
                   controller=J.AdaptiveController(1e-3, 1e-4, 64),
                   batching=J.PerSample())
    for c_t, c_j in zip(per, jsol.stats.per_sample):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_per_sample_saves_fevals_vs_lockstep_on_heterogeneous_batch():
    """Fewer total f-evals when rows accept/reject independently (ALF
    damping per Appendix A.5 so the stiff rows' control is live)."""
    p, z = _tsetup()
    kw = dict(solver=T.ALF(eta=0.9), gradient=T.MALI(),
              controller=T.AdaptiveController(1e-3, 1e-4, 128))
    lock = T.solve(_ft, p, z, 0.0, 1.0, batching=T.Lockstep(), **kw)
    per = T.solve(_ft, p, z, 0.0, 1.0, batching=T.PerSample(), **kw)
    assert int(per.stats.n_fevals) < int(lock.stats.n_fevals)


def test_done_sample_padding_steps_contribute_zero_gradient():
    """Regression: a row that finishes early rides along as a no-op next
    to a stiff batchmate; its gradient equals its own single solve's."""
    ctrl = T.AdaptiveController(1e-3, 1e-4, 64)
    p, z = _tsetup(grad=True)
    sol = T.solve(_ft, p, z, 0.0, 1.0, gradient=T.MALI(), controller=ctrl,
                  batching=T.PerSample())
    (g_z,) = torch.autograd.grad(torch.sum(sol.ys["y"] ** 2), [z["y"]])
    for i in range(3):
        p1, z1 = _tsetup(grad=True)
        s = T.solve(_ft, p1, _row(z1, i), 0.0, 1.0, gradient=T.MALI(),
                    controller=ctrl)
        (gi,) = torch.autograd.grad(torch.sum(s.ys["y"] ** 2), [z1["y"]])
        _close(g_z[i], gi[i], rtol=1e-6, atol=1e-7)


def test_sharded_on_host_mesh_matches_per_sample():
    """Sharded(inner=PerSample()) on a one-process mesh == PerSample,
    values, counters and gradients, bit for bit (every collective is the
    identity at one rank)."""
    ctrl = T.AdaptiveController(1e-3, 1e-4, 64)
    kw = dict(gradient=T.MALI(), controller=ctrl)
    p, z = _tsetup(grad=True)
    ref = T.solve(_ft, p, z, 0.0, 1.0, batching=T.PerSample(), **kw)
    g_ref = torch.autograd.grad(ref.ys["y"].sum(), [p["c"], z["y"]])
    with make_host_mesh("cpu"):
        sol = T.solve(_ft, p, z, 0.0, 1.0,
                      batching=T.Sharded(axis="data", inner=T.PerSample()),
                      **kw)
    g = torch.autograd.grad(sol.ys["y"].sum(), [p["c"], z["y"]])
    assert torch.equal(sol.ys["y"], ref.ys["y"])
    assert torch.equal(sol.stats.per_sample.n_accepted,
                       ref.stats.per_sample.n_accepted)
    for a, b in zip(g, g_ref):
        assert torch.equal(a, b)


_GLOO_RANK = r"""
import sys, torch, torch.distributed as dist
rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(path, world),
                        rank=rank, world_size=world)
import repro_torch.core as T
from repro_torch.launch.mesh import make_host_mesh


def f(p, z, t):
    return -z * p["a"] + 0.3 * torch.sin(3.0 * t)


def run(batching, nb=8):
    p = {"a": torch.tensor(1.5, requires_grad=True)}
    z = (torch.linspace(0.5, 2.0, nb) * torch.linspace(1.0, 3.0, nb))[:, None]
    sol = T.solve(f, p, z, 0.0, 1.0, gradient=T.MALI(),
                  controller=T.AdaptiveController(1e-3, 1e-4, 32),
                  batching=batching)
    g = torch.autograd.grad((sol.ys ** 2).sum(), [p["a"]])
    return sol, g[0]


mesh = make_host_mesh("cpu")
assert mesh.mesh_dim_names == ("data", "model")
assert tuple(mesh.mesh.shape) == (world, 1)
ref, g_ref = run(T.PerSample())
with mesh:
    sol, g = run(T.Sharded(axis="data", inner=T.PerSample()))
    assert torch.equal(sol.ys, ref.ys), (sol.ys - ref.ys).abs().max()
    assert torch.equal(sol.stats.per_sample.n_accepted,
                       ref.stats.per_sample.n_accepted)
    torch.testing.assert_close(g, g_ref, rtol=2e-5, atol=2e-6)
    # z0's gradient too: the all-reduced cotangent of the replicated input
    p = {"a": torch.tensor(1.5)}
    z0 = torch.linspace(0.5, 2.0, 8)[:, None].requires_grad_(True)
    kw = dict(gradient=T.MALI(), controller=T.AdaptiveController(1e-3, 1e-4,
                                                                 32))
    s1 = T.solve(f, p, z0, 0.0, 1.0, batching=T.Sharded(
        inner=T.PerSample()), **kw)
    (gz,) = torch.autograd.grad((s1.ys ** 2).sum(), [z0])
    s2 = T.solve(f, p, z0, 0.0, 1.0, batching=T.PerSample(), **kw)
    (gz2,) = torch.autograd.grad((s2.ys ** 2).sum(), [z0])
    torch.testing.assert_close(gz, gz2, rtol=2e-5, atol=2e-6)
    try:
        run(T.Sharded(), nb=6 if world == 4 else 7)
        raise AssertionError("divisibility not checked")
    except ValueError as e:
        assert "divisible" in str(e), e
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_multidevice_subprocess(tmp_path, world):
    """W gloo ranks, one process each: Sharded(axis='data',
    inner=PerSample()) equals PerSample on every rank — values and
    counters bit for bit, the params and z0 gradients at TOL (a sum over
    ranks of the rows' partial sums) — and a batch the axis does not
    divide raises."""
    script = tmp_path / "rank.py"
    script.write_text(_GLOO_RANK)
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp_path) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=110))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r}: {out[-2000:]}{err[-3000:]}"
        assert f"RANK_OK {r}" in out


@pytest.mark.parametrize("gradient", [T.MALI(), T.MALI(fused_bwd=False),
                                      T.Naive()],
                         ids=["mali", "mali_unfused", "naive"])
def test_alf_pallas_backend_through_batched_solve(gradient):
    """ALF(backend='cuda') (the ALF ops' plain versions on the CPU, with a
    per-row h) under PerSample against the reference backend: values,
    counts and gradients, for the fused and unfused MALI backward and for
    Naive (the reverse rules and their per-row h_bar)."""
    ctrl = T.AdaptiveController(1e-2, 1e-3, 32)
    out = {}
    for backend in ("reference", "cuda"):
        p, z = _tsetup(grad=True)
        sol = T.solve(_ft, p, z, 0.0, 1.0, solver=T.ALF(backend=backend),
                      controller=ctrl, gradient=gradient,
                      batching=T.PerSample())
        g = torch.autograd.grad((sol.ys["y"] ** 2).sum(),
                                [p["c"], z["rate"], z["y"]])
        out[backend] = (sol, g)
    (ref, g_ref), (cud, g_cud) = out["reference"], out["cuda"]
    _close(cud.ys["y"].detach(), ref.ys["y"].detach(), rtol=1e-6,
           atol=1e-6)
    assert torch.equal(cud.stats.per_sample.n_accepted,
                       ref.stats.per_sample.n_accepted)
    for a, b in zip(g_cud, g_ref):
        _close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", sorted(METHOD_AXES))
def test_per_sample_diff_bounds_sums_over_rows(method):
    """With diff_bounds=True the shared t1's cotangent under PerSample is
    the sum of the rows' single-solve cotangents (the JAX package's
    closed-over ts), and equals the JAX package's."""
    (tg, ts), (jg, js) = METHOD_AXES[method]
    kw = dict(solver=ts, gradient=tg,
              controller=T.AdaptiveController(1e-3, 1e-4, 64))
    p, z = _tsetup()
    t1 = torch.tensor(1.0, requires_grad=True)
    sol = T.solve(_ft, p, z, 0.0, t1, batching=T.PerSample(),
                  diff_bounds=True, **kw)
    (g,) = torch.autograd.grad((sol.ys["y"] ** 2).sum(), [t1])
    want = 0.0
    for i in range(3):
        t1i = torch.tensor(1.0, requires_grad=True)
        s = T.solve(_ft, p, _row(z, i), 0.0, t1i, diff_bounds=True, **kw)
        want = want + torch.autograd.grad((s.ys["y"] ** 2).sum(), [t1i])[0]
    _close(g, want)
    jp, jz = _jsetup()

    def jloss(t):
        s = J.solve(_fj, jp, jz, 0.0, t, solver=js, gradient=jg,
                    controller=J.AdaptiveController(1e-3, 1e-4, 64),
                    batching=J.PerSample(), diff_bounds=True)
        return jnp.sum(s.ys["y"] ** 2)

    _close(g, jax.grad(jloss)(1.0))


# --- boundary validation: the JAX package's errors -------------------------


def _both_raise(exc, match, **kw):
    """The same call raises ``exc`` matching ``match`` in both packages;
    returns both messages."""
    p, z = _tsetup()
    jp, jz = _jsetup()
    jkw = {k: v[1] for k, v in kw.items()}
    tkw = {k: v[0] for k, v in kw.items()}
    with pytest.raises(exc, match=match) as jerr:
        J.solve(_fj, jp, jz, gradient=J.MALI(), **jkw)
    with pytest.raises(exc, match=match) as terr:
        T.solve(_ft, p, z, gradient=T.MALI(), **tkw)
    return str(terr.value), str(jerr.value)


def test_batching_validation_inconsistent_batch_axis():
    p, _ = _tsetup()
    bad = {"rate": torch.ones(4, 1), "y": torch.ones(3, 1)}
    with pytest.raises(ValueError, match="inconsistent leading"):
        T.solve(_ft, p, bad, gradient=T.MALI(), batching=T.PerSample())
    with pytest.raises(ValueError, match="scalar"):
        T.solve(lambda p, z, t: -z, p, torch.tensor(1.0), gradient=T.MALI(),
                batching=T.PerSample())


def test_batching_validation_per_sample_fixed_steps_warns():
    p, z = _tsetup()
    with pytest.warns(UserWarning, match="degenerates to") as rec:
        T.solve(_ft, p, z, gradient=T.MALI(), controller=T.ConstantSteps(2),
                batching=T.PerSample())
    # stacklevel points at the caller of solve, as in the JAX package
    assert rec[0].filename == __file__


def test_batching_validation_dense_saveat():
    for mode in ("steps", "dense"):
        t_msg, j_msg = _both_raise(
            ValueError, "ragged", batching=(T.PerSample(), J.PerSample()),
            saveat=(T.SaveAt(**{mode: True}), J.SaveAt(**{mode: True})))
        assert t_msg == j_msg
        t_msg, j_msg = _both_raise(
            ValueError, "ragged across shards",
            batching=(T.Sharded(), J.Sharded()),
            saveat=(T.SaveAt(**{mode: True}), J.SaveAt(**{mode: True})))
        assert t_msg == j_msg


def test_batching_validation_misc():
    p, z = _tsetup()
    with pytest.raises(TypeError, match="Batching"):
        T.solve(_ft, p, z, gradient=T.MALI(), batching="per_sample")
    t_msg, j_msg = _both_raise(ValueError, "mesh context",
                               batching=(T.Sharded(), J.Sharded()))
    # word for word but for the module that makes the mesh
    assert t_msg.replace("repro_torch.launch.mesh.make_host_mesh()", "") \
        == j_msg.replace("repro.launch.mesh.make_host_mesh() or "
                         "make_production_mesh()", "")
    with pytest.raises(ValueError, match="does not nest"):
        T.Sharded(inner=T.Sharded())
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    jp, jz = _jsetup()
    with jax_host_mesh():
        with pytest.raises(ValueError, match="axes") as jerr:
            J.solve(_fj, jp, jz, gradient=J.MALI(),
                    batching=J.Sharded(axis="nonexistent"))
    with make_host_mesh("cpu"):
        with pytest.raises(ValueError, match="axes") as terr:
            T.solve(_ft, p, z, gradient=T.MALI(),
                    batching=T.Sharded(axis="nonexistent"))
    assert str(terr.value) == str(jerr.value)


def test_ode_settings_batch_axis_is_sharded():
    """OdeSettings(batch_axis=...).batching() is Sharded(axis=...), as in
    the JAX package; None without a batch axis."""
    from repro.core.ode_block import OdeSettings as JOdeSettings
    assert T.OdeSettings(batch_axis="data").batching() == T.Sharded(
        axis="data")
    assert JOdeSettings(batch_axis="data").batching() == J.Sharded(
        axis="data")
    assert T.OdeSettings().batching() is None
    T.OdeSettings(batch_axis="data").as_objects()

