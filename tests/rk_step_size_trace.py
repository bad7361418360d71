"""Trace where the port's adaptive step sizes part from the JAX package's.

Run on the CPU from the repo root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rk_step_size_trace.py

Prints, for the f32 cases of ``test_torch_rk.BUFFER_CASES``, the largest
relative difference of the recorded h and the first trials' (h, error
ratio) in both packages; then one rk23 step in f64 (state and parameters),
jitted JAX, eager JAX and torch, to show where the error estimates differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as J
import repro_torch.core as T
import test_torch_rk as R
from repro.core import integrate as jint
from repro_torch.core import integrate as tint


def _traced(trial, log, jax_side):
    def wrapped(s, t, h):
        out = trial(s, t, h)
        if jax_side:
            jax.debug.callback(lambda *a: log.append(tuple(map(float, a))),
                               h, out[1], ordered=True)
        else:
            log.append((float(h), float(out[1])))
        return out
    return wrapped


def f32_cases():
    for name, rtol, atol, _ in R.BUFFER_CASES:
        for grid in sorted(R.GRIDS):
            ts = R.GRIDS[grid]
            cj = J.AdaptiveController(rtol, atol, 48)
            ct = T.AdaptiveController(rtol, atol, 48)
            order = J.get_solver(name).order
            log_j, log_t = [], []
            rj = jint.integrate_grid(
                _traced(J.get_solver(name).trial_fn(R.f_jax, R._jp(), cj),
                        log_j, True), jnp.asarray(R._np_z0()),
                jnp.asarray(ts, jnp.float32), controller=cj, order=order)
            hj = np.asarray(rj.hs)
            rt = tint.integrate_grid(
                _traced(T.get_solver(name).trial_fn(R.f_torch, R._tp(), ct),
                        log_t, False), torch.tensor(R._np_z0()),
                tint.as_time_grid(ts), controller=ct, order=order)
            live = hj != 0
            rel = np.abs(rt.hs.numpy() - hj)[live] / np.abs(hj[live])
            print(f"{name} {rtol:g}/{atol:g} {grid}: max rel h diff "
                  f"{rel.max():.3g}")
            for i, ((h_t, r_t), (h_j, r_j)) in enumerate(zip(log_t[:4],
                                                              log_j[:4])):
                print(f"  trial {i}: torch h {h_t:.8g} ratio {r_t:.4g} | "
                      f"JAX h {h_j:.8g} ratio {r_j:.4g}")


def f64_rk23_step():
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = {k: v.astype(np.float64) for k, v in R._np_params().items()}
        z = R._np_z0().astype(np.float64)
        t, h = np.float32(0.0203731116), np.float32(0.0949584022)
        tab_j, tab_t = J.get_solver("rk23").tableau, T.get_solver(
            "rk23").tableau
        pj = {k: jnp.asarray(v) for k, v in p64.items()}

        def step(zz, tt, hh):
            return tab_j.step(R.f_jax, pj, zz, tt, hh)[1]

        e_jit = np.asarray(jax.jit(step)(jnp.asarray(z), t, h))
        e_eager = np.asarray(step(jnp.asarray(z), t, h))
    finally:
        jax.config.update("jax_enable_x64", False)
    e_t = tab_t.step(R.f_torch, {k: torch.tensor(v) for k, v in p64.items()},
                     torch.tensor(z), torch.tensor(t), torch.tensor(h))[1]
    e_t = e_t.numpy()
    print(f"rk23 f64 step at t={t}, h={h}: |error estimate| "
          f"{np.abs(e_eager).max():.3g}; jitted - eager JAX "
          f"{np.abs(e_jit - e_eager).max():.3g}; eager JAX - torch "
          f"{np.abs(e_eager - e_t).max():.3g}")


if __name__ == "__main__":
    f32_cases()
    f64_rk23_step()
