"""Find the first float32 op of the f32 adaptive parity checks whose result
moves with the host's instruction set.

Run on the CPU from the repo root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/f1_host_probe.py

Three checks sit near their bars and pass or fail by host:
``test_torch_solve.py::test_adaptive_records_identical_step_buffers``,
``test_torch_rk.py::test_rk_adaptive_records_identical_step_buffers``
(heun2, 1e-4/1e-5, both grids) and Jamba's f32 serve check. MKL picks its
sgemm kernel by the host's CPU; ``MKL_ENABLE_INSTRUCTIONS`` makes it take
the kernel of an older one (AVX2: FMA; AVX and SSE4_2: no FMA). For each
setting this script runs the checks' own comparisons in a subprocess and
prints:

- how many float32 ulps the vector field's value at the initial state,
  and its first product ``z @ w1`` alone, move from the host's own
  setting (ATen's own elementwise kernels do not change under
  ``ATEN_CPU_CAPABILITY``; its float32 ``tanh``, ``exp`` and ``sqrt`` are
  MKL's vector kernels and move by an ulp);
- the first trial whose step size h moves, its relative move, and the
  error ratio of the trial before (an error estimate cancels, so an ulp
  of f becomes a larger share of the ratio);
- the port's largest relative difference from the JAX package in the
  recorded ``ts`` and ``hs``, and whether the check's bars hold;
- Jamba's f32 serve check (``test_torch_ssm_serve.py::
  test_prefill_and_decode_match_jax[jamba-v0.1-52b-ode-f32]``, no step
  control): its worst logits' difference beside its bar;
- the same trials with the field's two products and its ``tanh`` taken
  in float64 and rounded once (no BLAS kernel, no float32 vector kernel),
  which must not move with the setting if the field's ops are the only
  host-dependent ones.
"""
import json
import os
import subprocess
import sys

import numpy as np

SETTINGS = ("", "AVX2", "AVX", "SSE4_2")


def _child():
    import jax.numpy as jnp
    import torch

    import repro.core as J
    import repro_torch.core as T
    import test_torch_rk as R
    import test_torch_solve as S
    from repro.core import integrate as jint
    from repro_torch.core import integrate as tint

    torch.set_num_threads(1)

    def f_fixed(p, z, t):
        """f_torch with its products and its tanh in float64, rounded
        once."""
        def mm(a, b):
            return (a.double()[..., :, None] * b.double()).sum(-2).float()
        u = mm(z, p["w1"]) + p["b1"] + t * p["bt"]
        return mm(torch.tanh(u.double()).float(), p["w2"]) + p["b2"]

    def traced(trial, log):
        def wrapped(s, t, h):
            out = trial(s, t, h)
            log.append((float(h), float(out[1])))
            return out
        return wrapped

    def run(case, field):
        if case == "solve":
            ts, name = (0.0, 0.35, 0.7, 1.0), "alf"
            ct = T.AdaptiveController(1e-3, 1e-4, 48)
            cj = J.AdaptiveController(1e-3, 1e-4, 48)
            mod, ts_rtol, hs_rtol = S, 1e-6, 1e-5
        else:
            ts = R.GRIDS[case.split("-")[1]]
            ct = T.AdaptiveController(1e-4, 1e-5, 48)
            cj = J.AdaptiveController(1e-4, 1e-5, 48)
            name, mod, ts_rtol, hs_rtol = "heun2", R, 1e-5, 1e-5
        pt = {k: torch.tensor(v) for k, v in mod._np_params().items()}
        pj = {k: jnp.asarray(v) for k, v in mod._np_params().items()}
        z0 = mod._np_z0()
        log = []
        if name == "alf":
            trial_t = T.ALF(eta=0.9).trial_fn(field, pt, ct)
            trial_j = J.ALF(eta=0.9).trial_fn(mod.f_jax, pj, cj)
            zt = torch.tensor(z0)
            grid = tint.as_time_grid(ts)
            st = (zt, field(pt, zt, grid[0]))
            sj = (jnp.asarray(z0), mod.f_jax(pj, jnp.asarray(z0), 0.0))
            order = 2
        else:
            trial_t = T.get_solver(name).trial_fn(field, pt, ct)
            trial_j = J.get_solver(name).trial_fn(mod.f_jax, pj, cj)
            grid = tint.as_time_grid(ts)
            st, sj = torch.tensor(z0), jnp.asarray(z0)
            order = T.get_solver(name).order
        rt = tint.integrate_grid(traced(trial_t, log), st, grid,
                                 controller=ct, order=order)
        rj = jint.integrate_grid(trial_j, sj, jnp.asarray(ts, jnp.float32),
                                 controller=cj, order=order)
        tt, tj = rt.ts.numpy(), np.asarray(rj.ts)
        ht, hj = rt.hs.numpy(), np.asarray(rj.hs)
        live = hj != 0
        return {"log": log,
                "counts_equal": bool(
                    np.array_equal(rt.n_accepted.numpy(),
                                   np.asarray(rj.n_accepted))
                    and int(rt.n_trials) == int(rj.n_trials)),
                "ts_rel": float((np.abs(tt - tj)[live]
                                 / np.maximum(np.abs(tj[live]), 1e-30)).max()),
                "ts_abs": float(np.abs(tt - tj).max()),
                "hs_rel": float((np.abs(ht - hj)[live]
                                 / np.abs(hj[live])).max()),
                "bars_hold": bool(
                    np.allclose(tt, tj, rtol=ts_rtol, atol=1e-7)
                    and np.allclose(ht, hj, rtol=hs_rtol, atol=1e-7))}

    p = {k: torch.tensor(v) for k, v in S._np_params().items()}
    z = torch.tensor(S._np_z0())
    out = {"f_bits": S.f_torch(p, z, torch.tensor(0.37)).numpy()
           .view(np.int32).tolist(),
           "mm_bits": (z @ p["w1"]).numpy().view(np.int32).tolist()}
    for case in ("solve", "heun2-asc", "heun2-desc"):
        mod = S if case == "solve" else R
        out[case] = run(case, mod.f_torch)
        out[case + "/fixed"] = run(case, f_fixed)
    # Jamba's f32 prefill + decode (no step-size control): each logits'
    # relative difference from the JAX package beside its bar, the larger
    # of 1e-5 and 3x the JAX package's own one-rounding floor
    import test_torch_ssm_serve as M
    jlog, tlog, plog, *_ = M._run_both("jamba-v0.1-52b", True, "f32")
    out["jamba"] = [[M._rel(tl, jl), max(M.TOL["f32"], M.FLOOR_FACTOR
                                         * M._rel(pl, jl))]
                    for jl, tl, pl in zip(jlog, tlog, plog)]
    print(json.dumps(out))


def _ulps(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .max())


def _first_move(log, base):
    for i, ((h, _), (h0, _)) in enumerate(zip(log, base)):
        if h != h0:
            ratio = base[i - 1][1] if i else float("nan")
            return i, abs(h - h0) / abs(h0), ratio
    return None, 0.0, float("nan")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for setting in SETTINGS:
        env = {k: v for k, v in os.environ.items()
               if k != "MKL_ENABLE_INSTRUCTIONS"}
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(here), "src"), here])
        if setting:
            env["MKL_ENABLE_INSTRUCTIONS"] = setting
        res = subprocess.run([sys.executable, __file__, "--child"], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"{setting or 'host'}: {res.stderr[-3000:]}")
        runs[setting or "host"] = json.loads(res.stdout.splitlines()[-1])
    base = runs["host"]
    for setting, r in runs.items():
        print(f"MKL_ENABLE_INSTRUCTIONS={setting}: f(z0) moves "
              f"{_ulps(r['f_bits'], base['f_bits'])} ulp, z @ w1 "
              f"{_ulps(r['mm_bits'], base['mm_bits'])} ulp")
        for case in ("solve", "heun2-asc", "heun2-desc"):
            for key in (case, case + "/fixed"):
                c = r[key]
                i, rel, ratio = _first_move(c["log"], base[key]["log"])
                moved = ("h unmoved" if i is None else
                         f"h first moves at trial {i} by {rel:.3g} "
                         f"(ratio before {ratio:.4g})")
                bars = "" if key.endswith("fixed") else (
                    f"; vs JAX: counts equal {c['counts_equal']}, ts "
                    f"{c['ts_rel']:.3g} rel / {c['ts_abs']:.3g} abs, hs "
                    f"{c['hs_rel']:.3g} rel, bars hold {c['bars_hold']}")
                print(f"  {key}: {moved}{bars}")
        worst = max(r["jamba"], key=lambda eb: eb[0] / eb[1])
        print(f"  jamba-v0.1-52b-ode-f32 logits: worst {worst[0]:.3g} "
              f"against its bar {worst[1]:.3g}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        main()
