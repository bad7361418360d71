"""The JAX quickstart's figures (``examples/quickstart.py``, a
module-level script), computed from ``repro.core`` as the example computes
them, printed as one JSON object.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_quickstart_figures.py

``tests/test_torch_examples.py`` runs it with
``XLA_FLAGS=--xla_cpu_max_isa=AVX``: without FMA, XLA rounds every product
as the JAX package does op by op (``jax.disable_jit``) and as the port
does. On a host with FMA, XLA contracts the ALF step's products, the
stiffest ``PerSample`` row's first error ratio lands 7 ulp higher, and
that row takes 103 accepted steps where without FMA it takes 125 (ROADMAP
queue 3, F2).
"""
import json

import jax
import jax.numpy as jnp

import repro.core as J


def quickstart_figures():
    """The JAX quickstart's figures, from ``repro.core`` as the example
    computes them (the example is a module-level script)."""
    def f(params, z, t):
        return params["alpha"] * z

    params = {"alpha": jnp.float32(0.5)}
    z0 = jnp.float32(1.3)
    out = {}
    sol = J.solve(f, params, z0, 0.0, 1.0, solver=J.ALF(eta=1.0),
                  controller=J.ConstantSteps(16), gradient=J.MALI())
    out["z_T"] = float(sol.ys)
    out["steps"] = int(sol.stats.n_accepted)
    out["fevals"] = int(sol.stats.n_fevals)
    out["residual_bytes"] = int(sol.stats.residual_bytes)
    traj = J.solve(f, params, z0, solver=J.ALF(),
                   controller=J.AdaptiveController(rtol=1e-4, atol=1e-5),
                   gradient=J.MALI(), saveat=J.SaveAt(ts=jnp.linspace(0, 1,
                                                                      5)))
    out["trajectory"] = [float(v) for v in traj.ys]

    def loss(p, z, gradient, solver):
        return J.solve(f, p, z, 0.0, 1.0, solver=solver,
                       controller=J.ConstantSteps(16),
                       gradient=gradient).ys ** 2

    out["dalpha"] = {
        name: float(jax.grad(loss)(params, z0, g, s)["alpha"])
        for name, g, s in (("mali", J.MALI(), J.ALF()),
                           ("naive", J.Naive(), J.ALF()),
                           ("aca", J.ACA(), J.HeunEuler()),
                           ("adjoint", J.Backsolve(), J.Dopri5()))}

    def decay(p, z, t):
        return {"y": -z["lam"] * z["y"], "lam": jnp.zeros_like(z["lam"])}

    zb = {"y": jnp.ones((8, 1)), "lam": jnp.logspace(-0.3, 1.5, 8)[:, None]}
    out["batching"] = {}
    for batching in (J.Lockstep(), J.PerSample()):
        bsol = J.solve(decay, {}, zb, 0.0, 1.0, solver=J.ALF(eta=0.9),
                       controller=J.AdaptiveController(1e-3, 1e-4, 256),
                       gradient=J.MALI(), batching=batching)
        out["batching"][batching.name] = {
            "fevals": int(bsol.stats.n_fevals),
            "per_row_accepted": [int(v) for v in
                                 bsol.stats.per_sample.n_accepted]}
    zT = J.solve(f, params, z0, 0.0, 1.0, solver=J.ALF(),
                 controller=J.ConstantSteps(16), gradient=J.MALI()).ys
    out["z_back"] = float(J.solve(f, params, zT, 1.0, 0.0, solver=J.ALF(),
                                  controller=J.ConstantSteps(16),
                                  gradient=J.MALI()).ys)
    dense = J.solve(f, params, z0, 0.0, 1.0, solver=J.ALF(),
                    controller=J.AdaptiveController(1e-4, 1e-5, 256),
                    saveat=J.SaveAt(dense=True))
    out["dense"] = [float(v) for v in
                    dense.evaluate(jnp.asarray([0.21, 0.5, 0.83]))]
    esol = J.solve(f, params, z0, 0.0, 4.0, solver=J.ALF(),
                   controller=J.ConstantSteps(64), gradient=J.MALI(),
                   event=J.Event(lambda z, t: z - 2.0, direction=+1))
    out["event"] = {"fired": bool(esol.stats.event_fired),
                    "time": float(esol.stats.event_time),
                    "z": float(esol.ys)}
    return out


if __name__ == "__main__":
    print(json.dumps(quickstart_figures()))
