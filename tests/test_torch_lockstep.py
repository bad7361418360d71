"""``solve(..., batching=Lockstep())`` in the port, against its own
unbatched solve and the JAX package on the CPU.

Lockstep is the unbatched machinery on the batched state: values and
gradients are bit-equal to the unbatched solve, ``ys`` batch-first for
every ``SaveAt`` mode, and ``stats.per_sample`` holds the shared counters
on every row, as the JAX package's ``_broadcast_rows`` gives them; the
scalar counters are the rows' totals. ``PerSample()`` and ``Sharded()``
(tests/test_torch_batching.py in full) are held here to the JAX package
on the same batch.
Values against the JAX package: 1e-5 relative under ``ConstantSteps``,
2e-4 relative under ``AdaptiveController`` in f32 (the non-autonomous
field's stage times round differently between jitted XLA and eager
torch; the step counts agree exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.solve import _broadcast_rows as jax_broadcast_rows
import repro_torch.core as T

torch.set_num_threads(1)

METHODS = {
    "mali": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF())),
    "mali_cuda": ((J.MALI(), J.ALF()), (T.MALI(), T.ALF(backend="cuda"))),
    "naive": ((J.Naive(), J.ALF()), (T.Naive(), T.ALF())),
    "aca": ((J.ACA(), J.HeunEuler()), (T.ACA(), T.HeunEuler())),
    "adjoint": ((J.Backsolve(), J.Dopri5()), (T.Backsolve(), T.Dopri5())),
}
CONTROLLERS = {
    "fixed": (J.ConstantSteps(3), T.ConstantSteps(3)),
    "adaptive": (J.AdaptiveController(1e-3, 1e-4, 64),
                 T.AdaptiveController(1e-3, 1e-4, 64)),
}
JAX_RTOL = {"fixed": 1e-5, "adaptive": 2e-4}
NB = 3


def _fj(params, z, t):
    # per-sample stiffness rides in the state; keys in sorted order, the
    # order JAX flattens a dict in
    return {"rate": jnp.zeros_like(z["rate"]),
            "y": -z["rate"] * z["y"] + params["c"] * jnp.sin(3.0 * t)}


def _ft(params, z, t):
    return {"rate": torch.zeros_like(z["rate"]),
            "y": -z["rate"] * z["y"] + params["c"] * torch.sin(3.0 * t)}


def _np_z0():
    return {"rate": np.asarray([0.3, 2.0, 8.0], np.float32)[:, None],
            "y": np.linspace(0.6, 1.4, NB, dtype=np.float32)[:, None]}


def _tz0(grad=False):
    return {k: torch.tensor(v, requires_grad=grad)
            for k, v in _np_z0().items()}


def _jz0():
    return {k: jnp.asarray(v) for k, v in _np_z0().items()}


def _saveats(mode):
    return {"end": (None, None),
            "ts": (J.SaveAt(ts=jnp.linspace(0.0, 1.0, 4)),
                   T.SaveAt(ts=torch.linspace(0.0, 1.0, 4)))}[mode]


@pytest.mark.parametrize("mode", ["end", "ts"])
@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_lockstep_bit_equal_to_unbatched(method, ctrl, mode):
    (gj, sj), (gt, st) = METHODS[method]
    cj, ct = CONTROLLERS[ctrl]
    saj, sat = _saveats(mode)
    out = {}
    for label, batching in (("implicit", None), ("lockstep", T.Lockstep())):
        c = torch.tensor(0.4, requires_grad=True)
        z0 = _tz0(grad=True)
        sol = T.solve(_ft, {"c": c}, z0, 0.0, 1.0, solver=st, controller=ct,
                      gradient=gt, saveat=sat, batching=batching)
        loss = torch.sum(sol.ys["y"] ** 2)
        out[label] = (sol, torch.autograd.grad(loss, [c, z0["y"]]))
    (imp, g_imp), (lock, g_lock) = out["implicit"], out["lockstep"]
    ys_imp = imp.ys["y"] if mode == "end" else imp.ys["y"].movedim(0, 1)
    assert tuple(lock.ys["y"].shape) == (
        (NB, 1) if mode == "end" else (NB, 4, 1))
    np.testing.assert_array_equal(lock.ys["y"].detach().numpy(),
                                  ys_imp.detach().numpy())
    for a, b in zip(g_lock, g_imp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # one shared decision per trial: every row reports the shared counters
    for k in ("n_accepted", "n_rejected", "n_fevals"):
        rows = getattr(lock.stats.per_sample, k)
        assert tuple(rows.shape) == (NB,)
        np.testing.assert_array_equal(
            rows.numpy(), np.full((NB,), int(getattr(imp.stats, k))))
        assert int(getattr(lock.stats, k)) == NB * int(getattr(imp.stats, k))
    assert lock.stats.residual_bytes == imp.stats.residual_bytes

    s_j = J.solve(_fj, {"c": jnp.float32(0.4)}, _jz0(), 0.0, 1.0, solver=sj,
                  controller=cj, gradient=gj, saveat=saj,
                  batching=J.Lockstep())
    np.testing.assert_allclose(lock.ys["y"].detach().numpy(),
                               np.asarray(s_j.ys["y"]), rtol=JAX_RTOL[ctrl],
                               atol=JAX_RTOL[ctrl])


@pytest.mark.parametrize("ctrl", sorted(CONTROLLERS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_per_sample_rows_equal_jax_broadcast_rows(method, ctrl):
    """The port's per-row counters against the JAX package's
    ``_broadcast_rows`` of its own unbatched counters."""
    (gj, sj), (gt, st) = METHODS[method]
    cj, ct = CONTROLLERS[ctrl]
    sol = T.solve(_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, 1.0,
                  solver=st, controller=ct, gradient=gt,
                  batching=T.Lockstep())
    plain = J.solve(_fj, {"c": jnp.float32(0.4)}, _jz0(), 0.0, 1.0,
                    solver=sj, controller=cj, gradient=gj)
    want = jax_broadcast_rows(
        J.RunStats(plain.stats.n_accepted, plain.stats.n_rejected,
                   plain.stats.n_fevals), NB)
    for k in J.RunStats._fields:
        np.testing.assert_array_equal(
            getattr(sol.stats.per_sample, k).numpy(),
            np.asarray(getattr(want, k)))
    jl = J.solve(_fj, {"c": jnp.float32(0.4)}, _jz0(), 0.0, 1.0, solver=sj,
                 controller=cj, gradient=gj, batching=J.Lockstep())
    for k in ("n_accepted", "n_rejected", "n_fevals", "n_segments"):
        assert int(getattr(sol.stats, k)) == int(getattr(jl.stats, k)), k


@pytest.mark.parametrize("mode", ["ts", "steps", "dense"])
def test_batch_first_ys(mode):
    """Batch-first ``ys`` for SaveAt(ts|steps|dense): the moved axes of the
    unbatched record, and the JAX package's Lockstep values."""
    cj, ct = J.ConstantSteps(5), T.ConstantSteps(5)
    saj, sat = {
        "ts": (J.SaveAt(ts=jnp.linspace(0.0, 1.0, 4)),
               T.SaveAt(ts=torch.linspace(0.0, 1.0, 4))),
        "steps": (J.SaveAt(steps=True), T.SaveAt(steps=True)),
        "dense": (J.SaveAt(dense=True), T.SaveAt(dense=True))}[mode]
    gj, gt = ((J.MALI(), T.MALI()) if mode == "ts"
              else (J.Naive(), T.Naive()))
    kw = dict(solver=T.ALF(), controller=ct, gradient=gt, saveat=sat)
    lock = T.solve(_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, 1.0,
                   batching=T.Lockstep(), **kw)
    imp = T.solve(_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, 1.0, **kw)
    s_j = J.solve(_fj, {"c": jnp.float32(0.4)}, _jz0(), 0.0, 1.0,
                  solver=J.ALF(), controller=cj, gradient=gj, saveat=saj,
                  batching=J.Lockstep())
    ys = lock.ys["y"].numpy()
    np.testing.assert_allclose(ys, np.asarray(s_j.ys["y"]), rtol=1e-5,
                               atol=1e-6)
    if mode == "dense":
        # the end state is batch-first already; evaluate(t) gives (B, ...)
        assert ys.shape == (NB, 1)
        np.testing.assert_array_equal(ys, imp.ys["y"].numpy())
        q = lock.evaluate(0.37)["y"].numpy()
        assert q.shape == (NB, 1)
        np.testing.assert_allclose(q, np.asarray(s_j.evaluate(0.37)["y"]),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert ys.shape[0] == NB
        np.testing.assert_array_equal(ys, imp.ys["y"].movedim(0, 1).numpy())
        np.testing.assert_array_equal(lock.ts.numpy(), imp.ts.numpy())
    if mode == "steps":
        assert int(lock.num_steps) == 5
        np.testing.assert_array_equal(lock.stats.per_sample.n_accepted
                                      .numpy(), np.full((NB,), 5))
    assert int(lock.stats.n_fevals) == int(
        torch.sum(lock.stats.per_sample.n_fevals))
    assert int(lock.stats.n_fevals) == int(s_j.stats.n_fevals)


def test_lockstep_diff_bounds_matches_jax():
    t1 = torch.tensor(1.0, requires_grad=True)
    sol = T.solve(_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, t1,
                  solver=T.ALF(), controller=T.ConstantSteps(8),
                  gradient=T.MALI(), batching=T.Lockstep(), diff_bounds=True)
    (g,) = torch.autograd.grad(torch.sum(sol.ys["y"] ** 2), [t1])

    def loss(t):
        s = J.solve(_fj, {"c": jnp.float32(0.4)}, _jz0(), 0.0, t,
                    solver=J.ALF(), controller=J.ConstantSteps(8),
                    gradient=J.MALI(), batching=J.Lockstep(),
                    diff_bounds=True)
        return jnp.sum(s.ys["y"] ** 2)

    np.testing.assert_allclose(float(g), float(jax.grad(loss)(1.0)),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["per_sample", "sharded",
                                  "sharded_per_sample"])
def test_per_sample_and_sharded_raise_not_implemented(case):
    """The two modes the port once refused, against the JAX package on
    this file's batch: ``PerSample()`` (ys and per-row counters),
    ``Sharded()`` with no mesh (the same ValueError), and
    ``Sharded(inner=PerSample())`` on a one-process mesh (each package's
    host mesh)."""
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro_torch.launch.mesh import make_host_mesh
    ctrl = CONTROLLERS["adaptive"]
    jkw = dict(gradient=J.MALI(), controller=ctrl[0])
    tkw = dict(gradient=T.MALI(), controller=ctrl[1])
    jargs = (_fj, {"c": jnp.asarray(0.4)}, _jz0(), 0.0, 1.0)
    targs = (_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, 1.0)
    if case == "sharded":
        with pytest.raises(ValueError, match="mesh context"):
            J.solve(*jargs, batching=J.Sharded(), **jkw)
        with pytest.raises(ValueError, match="mesh context"):
            T.solve(*targs, batching=T.Sharded(), **tkw)
        return
    if case == "per_sample":
        want = J.solve(*jargs, batching=J.PerSample(), **jkw)
        got = T.solve(*targs, batching=T.PerSample(), **tkw)
    else:
        with jax_host_mesh():
            want = J.solve(*jargs, batching=J.Sharded(
                inner=J.PerSample()), **jkw)
        with make_host_mesh("cpu"):
            got = T.solve(*targs, batching=T.Sharded(
                inner=T.PerSample()), **tkw)
    np.testing.assert_allclose(got.ys["y"].numpy(), np.asarray(want.ys["y"]),
                               rtol=JAX_RTOL["adaptive"])
    for c_t, c_j in zip(got.stats.per_sample, want.stats.per_sample):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("axis", ["batching", "event"])
def test_wrong_axis_type_raises_type_error_as_jax(axis):
    """A batching= or event= of the wrong type is a TypeError in both
    packages, with the same message."""
    with pytest.raises(TypeError, match=axis) as ref:
        J.solve(_fj, {"c": jnp.asarray(0.4)}, _jz0(), 0.0, 1.0,
                gradient=J.MALI(), **{axis: object()})
    with pytest.raises(TypeError, match=axis) as port:
        T.solve(_ft, {"c": torch.tensor(0.4)}, _tz0(), 0.0, 1.0,
                gradient=T.MALI(), **{axis: object()})
    assert str(port.value).split(", got")[0] == str(ref.value).split(
        ", got")[0]


def test_batching_validation():
    p = {"c": torch.tensor(0.4)}
    bad = {"rate": torch.ones(4, 1), "y": torch.ones(3, 1)}
    with pytest.raises(ValueError, match="inconsistent leading"):
        T.solve(_ft, p, bad, gradient=T.MALI(), batching=T.Lockstep())
    with pytest.raises(ValueError, match="scalar"):
        T.solve(lambda p, z, t: -z, p, torch.tensor(1.0), gradient=T.MALI(),
                batching=T.Lockstep())
    with pytest.raises(TypeError, match="Batching"):
        T.solve(_ft, p, _tz0(), gradient=T.MALI(), batching="lockstep")
    with pytest.raises(ValueError, match="does not nest"):
        T.Sharded(inner=T.Sharded())
    with pytest.raises(ValueError, match="diff_bounds=True with Sharded"):
        T.solve(_ft, p, _tz0(), gradient=T.MALI(), batching=T.Sharded(),
                diff_bounds=True)
    assert T.batch_size(_tz0()) == NB
    assert T.batch_size((torch.ones(5, 2), None)) == 5
