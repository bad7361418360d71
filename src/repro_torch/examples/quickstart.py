"""Quickstart: the MALI integrator on PyTorch (the port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Integrate an ODE with the composable `solve()` API
   (solver x step-controller x gradient-method x saveat -> Solution).
2. Take gradients through it with each method (Table 1 of the paper) —
   a method swap is a one-argument change.
3. Show MALI's two properties: constant memory and reverse accuracy.

The JAX example reads XLA's compiled temp bytes for 3a; here the bytes
autograd saves for the backward (every device) and, on the card, the
growth of ``torch.cuda.max_memory_allocated`` over a forward + backward.
ALF runs on ``backend="cuda"``: the kernels on the card.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core import (ACA, ALF, AdaptiveController, Backsolve,
                              ConstantSteps, Dopri5, Event, HeunEuler,
                              Lockstep, MALI, Naive, PerSample, SaveAt,
                              odeint, solve)
from repro_torch.device import resolve_device

T = 1.0
MEMORY_N = 65536           # 3a's state
MEMORY_STEPS = (8, 64)


# dz/dt = alpha * z  — the paper's Sec 4.1 toy with analytic solution.
def f(params, z, t):
    return params["alpha"] * z


def big_f(p, z, t):
    return torch.tanh(p["w"] * z)


def decay(p, z, t):
    return {"y": -z["lam"] * z["y"], "lam": torch.zeros_like(z["lam"])}


def alf(eta=1.0):
    return ALF(eta=eta, backend="cuda")


def configs():
    """(name, gradient, solver) of Table 1's four methods."""
    return (("mali", MALI(), alf()), ("naive", Naive(), alf()),
            ("aca", ACA(), HeunEuler()), ("adjoint", Backsolve(), Dopri5()))


def loss(p, z, gradient, solver):
    return solve(f, p, z, 0.0, T, solver=solver,
                 controller=ConstantSteps(16), gradient=gradient).ys ** 2


def dloss_dalpha(params, z0, gradient, solver) -> float:
    p = {"alpha": params["alpha"].detach().requires_grad_(True)}
    (g,) = torch.autograd.grad(loss(p, z0, gradient, solver), p["alpha"])
    return float(g)


def big_loss(p, z, gradient, n):
    return torch.sum(solve(big_f, p, z, 0.0, 1.0, solver=alf(),
                           controller=ConstantSteps(n),
                           gradient=gradient).ys ** 2)


def backward_memory(gradient, n, device) -> dict:
    """What a forward + backward of ``big_loss`` over ``n`` steps holds:
    the bytes autograd saves for the backward and, on the card, the
    growth of the allocator's peak over the step."""
    big = {"w": torch.ones(MEMORY_N, device=device, requires_grad=True)}
    z = torch.ones(MEMORY_N, device=device)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = big_loss(big, z, gradient, n)
    (g,) = torch.autograd.grad(out, big["w"])
    del out, g
    res = {"saved_bytes": sum(saved)}
    if cuda:
        torch.cuda.synchronize(device)
        res["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    params = {"alpha": torch.tensor(0.5, device=dev)}
    z0 = torch.tensor(1.3, device=dev)

    # ---- 1. forward integration ----------------------------------------
    sol = solve(f, params, z0, 0.0, T, solver=alf(),
                controller=ConstantSteps(16), gradient=MALI())
    print(f"z(T) numeric {float(sol.ys):.6f} vs analytic "
          f"{1.3 * math.exp(0.5 * T):.6f}")
    print(f"stats: {int(sol.stats.n_accepted)} steps, "
          f"{int(sol.stats.n_fevals)} f-evals, "
          f"{sol.stats.residual_bytes} residual bytes")
    out["z_T"] = float(sol.ys)
    out["steps"] = int(sol.stats.n_accepted)
    out["fevals"] = int(sol.stats.n_fevals)
    out["residual_bytes"] = sol.stats.residual_bytes

    # adaptive stepping + the whole trajectory is a SaveAt/controller swap:
    traj = solve(f, params, z0, solver=alf(),
                 controller=AdaptiveController(rtol=1e-4, atol=1e-5),
                 gradient=MALI(),
                 saveat=SaveAt(ts=torch.linspace(0, T, 5, device=dev)))
    out["trajectory"] = traj.ys.tolist()
    print("trajectory", [f"{v:.4f}" for v in out["trajectory"]])

    # the legacy string facade builds exactly these objects:
    assert float(odeint(f, params, z0, 0.0, T, method="mali", solver=alf(),
                        n_steps=16)) == float(sol.ys)

    # ---- 2. gradients through the integrator, all four methods ----------
    exact_dalpha = 2 * T * 1.3 ** 2 * math.exp(2 * 0.5 * T)
    out["dalpha"] = {}
    for name, gradient, solver in configs():
        g = dloss_dalpha(params, z0, gradient, solver)
        err = abs(g - exact_dalpha)
        print(f"{name:8s} dL/dalpha = {g:.5f} "
              f"(analytic {exact_dalpha:.5f}, err {err:.2e})")
        out["dalpha"][name] = g

    # ---- 3a. constant memory: backward bytes flat in n_steps ------------
    out["memory"] = {}
    for name, gradient in (("mali", MALI()), ("naive", Naive())):
        mem = [backward_memory(gradient, n, dev) for n in MEMORY_STEPS]
        out["memory"][name] = mem
        for key in mem[0]:
            a, b = mem[0][key], mem[1][key]
            print(f"{name:8s} backward {key.replace('_', ' ')}: "
                  f"n={MEMORY_STEPS[0]} -> {a:,}  n={MEMORY_STEPS[1]} -> "
                  f"{b:,}  (x{b / a:.1f})")

    # ---- 4. batching is an explicit axis --------------------------------
    # A batch of initial states with per-sample stiffness: Lockstep() (one
    # shared controller decision — the classic concatenated odeint) vs
    # PerSample() (each row adapts independently; finished rows ride as
    # no-ops).
    zb = {"y": torch.ones((8, 1), device=dev),
          "lam": torch.logspace(-0.3, 1.5, 8, device=dev)[:, None]}
    out["batching"] = {}
    for batching in (Lockstep(), PerSample()):
        bsol = solve(decay, {}, zb, 0.0, 1.0, solver=alf(eta=0.9),
                     controller=AdaptiveController(1e-3, 1e-4, 256),
                     gradient=MALI(), batching=batching)
        per = [int(v) for v in bsol.stats.per_sample.n_accepted]
        fevals = int(bsol.stats.n_fevals)
        print(f"{batching.name:10s} total f-evals {fevals:5d}  "
              f"per-row accepted {per}")
        out["batching"][batching.name] = {"fevals": fevals,
                                          "per_row_accepted": per}

    # ---- 3b. reverse accuracy: MALI == backprop through its own forward -
    g_mali = dloss_dalpha(params, z0, MALI(), alf())
    g_naive = dloss_dalpha(params, z0, Naive(), alf())
    rel = abs(g_mali - g_naive) / abs(g_naive)
    print(f"reverse-accuracy invariant |mali-naive|/|naive| = {rel:.2e} "
          "(float rounding)")
    out["mali_naive_rel"] = rel

    # ---- 5. time as a first-class axis ----------------------------------
    # reverse-time solve: run the flow backwards and recover z0
    zT = solve(f, params, z0, 0.0, T, solver=alf(),
               controller=ConstantSteps(16), gradient=MALI()).ys
    z_back = solve(f, params, zT, T, 0.0, solver=alf(),
                   controller=ConstantSteps(16), gradient=MALI()).ys
    print(f"reverse-time roundtrip: z0 {float(z0):.6f} -> recovered "
          f"{float(z_back):.6f}")
    out["z_back"] = float(z_back)

    # dense output: one solve, query anywhere in the span
    dense = solve(f, params, z0, 0.0, T, solver=alf(),
                  controller=AdaptiveController(1e-4, 1e-5, 256),
                  saveat=SaveAt(dense=True))
    queries = torch.tensor([0.21, 0.5, 0.83], device=dev)
    out["dense"] = dense.evaluate(queries).tolist()
    print("dense evaluate:", [f"{v:.5f}" for v in out["dense"]],
          "vs analytic", [f"{1.3 * math.exp(0.5 * t):.5f}"
                          for t in queries.tolist()])

    # terminating event: stop when z grows through 2.0 (analytic t*)
    ev = Event(lambda z, t: z - 2.0, direction=+1)
    esol = solve(f, params, z0, 0.0, 4.0, solver=alf(),
                 controller=ConstantSteps(64), gradient=MALI(), event=ev)
    t_star = math.log(2.0 / 1.3) / 0.5
    out["event"] = {"fired": bool(esol.stats.event_fired),
                    "time": float(esol.stats.event_time),
                    "z": float(esol.ys)}
    print(f"event fired={out['event']['fired']} at "
          f"t={out['event']['time']:.5f} (analytic {t_star:.5f}); "
          f"z(t_event)={out['event']['z']:.5f}")
    return out


if __name__ == "__main__":
    main()
