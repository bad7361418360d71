"""benchmarks/serve_load.py's request traces through the JAX package's
``repro.serve`` and through the port's ``repro_torch.serve`` under each of
its two step controllers, on the CPU, request by request.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/serve_load_trace.py

The protocol is serve_load's: slots 8, chunk 16, D 16, 64 requests with
lam log-uniform over [0.5, 200], max_steps 2048, ALF(eta=0.9), a tick
clock of one unit a round (the counts do not depend on its length), a
closed-loop run (seed 0, every arrival at ~0) that measures the capacity
mu, and a Poisson run (seed 1) at 0.75 mu through both engines. Requests
are paired by submission order. For each port controller it prints, per
run, the requests whose trial counts differ from the JAX engine's, the
rounds, the headline ratios and, over the requests whose counts agree,
the largest end-state difference; then, for every differing request, the
trial at which the two packages' accept/reject decisions first part, and
the error ratios there (their distance from 1 says whether the decision
was a tie).

Not collected by pytest (about a minute and a half on one CPU core).
``tests/test_torch_serve.py::test_engine_matches_jax`` holds the two
engines' counts equal on tests/test_serve.py's mixed trace (lam up to
20); on serve_load's (lam up to 200) they are not, under either of the
port's controllers, and this script shows where they part.
"""
from __future__ import annotations

import numpy as np

SLOTS, CHUNK, D, N, MAX_STEPS = 8, 16, 16, 64, 2048
LAM_DECADES = (np.log10(0.5), np.log10(200.0))
LOAD_FRACTION = 0.75

_SEEN: list = []


def tick_timer(tau: float = 1.0):
    state = {"t": 0.0}

    def timer() -> float:
        state["t"] += tau / 2.0
        return state["t"]

    return timer


def requests(P, seed: int, rate: float):
    return P.mixed_stiffness_requests(
        np.random.default_rng(seed), N, rate=rate, d_state=D,
        lam_decades=LAM_DECADES, max_steps=MAX_STEPS)


def jax_engine(name):
    import repro.core as JC
    import repro.serve as J
    return J.ENGINES[name](J.decay_dynamics, None,
                           config=J.EngineConfig(slots=SLOTS,
                                                 chunk_steps=CHUNK,
                                                 solver=JC.ALF(eta=0.9)),
                           timer=tick_timer())


def port_engine(name, controller):
    import repro_torch.core as TC
    import repro_torch.serve as T

    class Engine(T.ENGINES[name]):
        Controller = controller

    return Engine(T.decay_dynamics, None,
                  config=T.EngineConfig(slots=SLOTS, chunk_steps=CHUNK,
                                        solver=TC.ALF(eta=0.9)),
                  timer=tick_timer(), device="cpu")


def run(make, P, seed, rate):
    eng = make()
    reqs = requests(P, seed, rate)
    eng.submit(reqs)
    rep = eng.run()
    rec = {r.rid: r for r in eng.records}
    return rep, [(rec[r.rid], eng.results[r.rid], r) for r in reqs]


def runs(P, make):
    """serve_load's three runs: closed loop, then both engines at
    0.75 mu on the Poisson trace."""
    cap, cap_rows = run(lambda: make("continuous"), P, 0, 1e9)
    rate = LOAD_FRACTION * cap.solves_per_s
    out = {"closed": (cap, cap_rows)}
    for name in ("continuous", "static"):
        out[name] = run(lambda: make(name), P, 1, rate)
    return out


def ratios(out):
    cont, stat = out["continuous"][0], out["static"][0]
    return (stat.p99_latency_s / max(cont.p99_latency_s, 1e-12),
            cont.solves_per_s / max(stat.solves_per_s, 1e-12))


def counts(rec):
    return (rec.n_fevals, rec.n_accepted, rec.completed)


def trial_ratios(P, req, controller):
    """The error ratio and accept decision of every trial of the request's
    single solve: the JAX package's (``controller`` None) or the port's."""
    cfg = req.config
    if controller is None:
        import jax
        import jax.numpy as jnp
        import repro.core as JC
        import repro.core.stepsize as S

        base = S.error_ratio
        _SEEN.clear()

        def probe(err, z0, z1, rtol, atol, *a, **k):
            r = base(err, z0, z1, rtol, atol, *a, **k)
            # every trial's ratio, in order, from inside the compiled loop
            # (into a module-level list: a cached compilation keeps the
            # callback of the call that traced it)
            jax.debug.callback(lambda v: _SEEN.append(float(v)), r,
                               ordered=True)
            return r

        S.error_ratio = probe
        try:
            sol = JC.solve(P.decay_dynamics, None,
                           {k: jnp.asarray(v) for k, v in req.z0.items()},
                           cfg.t0, cfg.t1, solver=JC.ALF(eta=0.9),
                           controller=JC.AdaptiveController(
                               cfg.rtol, cfg.atol, cfg.max_steps))
            jax.effects_barrier()
        finally:
            S.error_ratio = base
        # the loop runs masked trials past the end: keep the counted ones
        solver = JC.ALF(eta=0.9)
        return _SEEN[:(int(sol.stats.n_fevals) - 1) // solver.stages]
    import torch
    import repro_torch.core as TC
    seen = []

    class Probe(controller):
        @staticmethod
        def norm(*a, **k):
            r = controller.norm(*a, **k)
            seen.append(float(r))
            return r

    TC.solve(P.decay_dynamics, None,
             {k: torch.as_tensor(v) for k, v in req.z0.items()}, cfg.t0,
             cfg.t1, solver=TC.ALF(eta=0.9),
             controller=Probe(cfg.rtol, cfg.atol, cfg.max_steps))
    return seen


def main() -> None:
    import torch

    import repro.serve as J
    import repro_torch.serve as T
    from repro_torch.core import AdaptiveController, ReproducibleController

    torch.set_num_threads(1)
    ref = runs(J, jax_engine)
    print("JAX engine: rounds closed/continuous/static "
          f"{ref['closed'][0].rounds}/{ref['continuous'][0].rounds}/"
          f"{ref['static'][0].rounds}; p99 static/continuous, solves "
          "continuous/static %.6f %.6f" % ratios(ref))
    for ctrl in (AdaptiveController, ReproducibleController):
        got = runs(T, lambda name: port_engine(name, ctrl))
        print(f"\nport engine, {ctrl.__name__}: p99 static/continuous, "
              "solves continuous/static %.6f %.6f" % ratios(got))
        differing = {}
        for run_name in ("closed", "continuous", "static"):
            (jrep, jrows), (trep, trows) = ref[run_name], got[run_name]
            diff, gap = [], 0.0
            for i, ((ja, jz, jr), (ta, tz, _)) in enumerate(zip(jrows,
                                                                trows)):
                if counts(ja) != counts(ta):
                    diff.append(i)
                    differing.setdefault(i, (jr, counts(ja), counts(ta)))
                else:
                    gap = max(gap, max(float(np.abs(
                        np.asarray(jz[k]) - tz[k]).max()) for k in jz))
            print(f"  {run_name:10s} rounds JAX {jrep.rounds} port "
                  f"{trep.rounds}; requests with other counts "
                  f"{len(diff)}/{N} {diff}; max |end state diff| where "
                  f"counts agree {gap:.3g}")
        for i, (req, jc, tc) in sorted(differing.items()):
            jr = trial_ratios(J, req, None)
            tr = trial_ratios(T, req, ctrl)
            k = next((n for n, (a, b) in enumerate(zip(jr, tr))
                      if (a <= 1.0) != (b <= 1.0)), None)
            where = ("no decision parts within the shorter solve"
                     if k is None else
                     f"decisions part at trial {k}: JAX ratio {jr[k]!r} "
                     f"(1 - r = {1.0 - jr[k]:.3g}), port {tr[k]!r} "
                     f"(1 - r = {1.0 - tr[k]:.3g})")
            print(f"  request {i} lam {float(req.z0['lam'][0]):.4g}: "
                  f"JAX (fevals, accepted, completed) {jc}, port {tc}; "
                  f"{where}")


if __name__ == "__main__":
    main()
