"""Paper §4.4 at CPU scale: continuous normalizing flow (FFJORD) trained
with MALI on a 2D density — expressed through the repro_torch.cnf
subsystem (the port of ``examples/cnf_toy.py``).

    PYTHONPATH=src python -m repro_torch.examples.cnf_toy [--steps 600] \\
        [--method mali] [--device cpu]

The CNF integrates the augmented state (z, log|det|) with
d(logdet)/dt = -tr(df/dz) — exact trace in 2D (the Hutchinson estimator is
also checked against it). Reports NLL in nats (the 2D analogue of the
paper's bits/dim). ALF runs on ``backend="cuda"``: the kernels on the card.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.cnf import CNF, Exact, Hutchinson, cnf_loss, nll_nats
from repro_torch.core import ALF, ConstantSteps, MALI, Naive, SaveAt, \
    get_solver
from repro_torch.device import resolve_device
from repro_torch.examples._common import Adam
from repro_torch.models import init_mlp_vfield, mlp_vfield
from repro_torch.tree_util import tree_map, vmap

HID = 48


def make_moons(n, seed, device=None):
    """Two interleaved half circles with noise, drawn as the JAX example
    draws them: (n, 2) float32 on ``device``."""
    rng = np.random.default_rng(seed)
    half = n // 2
    th = rng.uniform(0, np.pi, half)
    a = np.stack([np.cos(th), np.sin(th)], -1)
    b = np.stack([1 - np.cos(th), 0.5 - np.sin(th)], -1)
    x = np.concatenate([a, b]) + rng.normal(0, 0.08, (n, 2))
    return torch.as_tensor(x.astype(np.float32), device=resolve_device(device))


FLOW = CNF(mlp_vfield, dim=2, estimator=Exact())

KINETIC_REG = 0.5    # Finlay-et-al-style coefficient (the paper uses 0.05
                     # at image scale; the 2D toy needs a stronger pull to
                     # keep the discretized logdet honest — see eval below)


def nll(fp, x, method="mali", n_steps=8, reg=0.0, solver_n=None):
    """-log p(x): integrate x -> base gaussian, exact trace (+ optional
    kinetic-energy regularizer used during training). ``solver_n`` swaps in
    a different (solver, n_steps) re-discretization at eval time — a
    one-argument change on the object API."""
    solver = ALF(backend="cuda")
    if solver_n is not None:
        name, n_steps = solver_n
        solver = get_solver(name)
    gradient = MALI() if method == "mali" else Naive()
    res = FLOW.log_prob(fp, x, solver=solver,
                        controller=ConstantSteps(n_steps), gradient=gradient)
    return cnf_loss(res, kinetic_reg=reg)


def trace_bias(fq, xs, probes):
    """Mean |Hutchinson - exact| of ``tr(df/dz)`` over the states ``xs``
    (n, 2), the Hutchinson estimate averaged over ``probes`` (k, n, 2),
    for the field at parameters ``fq`` and t = 0.3."""
    def trace_at(est, zi, ei):
        return est.value_and_trace(lambda zz: mlp_vfield(fq, zz, 0.3),
                                   zi, ei)[1]

    hutch = Hutchinson()
    ld_exact = vmap(lambda zi: trace_at(Exact(), zi, None))(xs)
    ld_h = torch.stack([vmap(lambda zi, ei: trace_at(hutch, zi, ei))(xs, e)
                        for e in probes])
    return float(torch.abs(ld_h.mean(0) - ld_exact).mean())


def flow_path(fp, generator, flow_ts):
    """``sample`` back through the inverse flow (base -> data time) over
    the descending grid ``flow_ts`` in ONE call: the (T, n, 2) path of 8
    samples."""
    path = FLOW.sample(fp, generator, 8, solver=ALF(backend="cuda"),
                       controller=ConstantSteps(2), saveat=SaveAt(ts=flow_ts))
    return path.ys[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--method", default="mali")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    x = make_moons(1024, seed=0, device=dev)
    xt = make_moons(512, seed=1, device=dev)
    fp = init_mlp_vfield(gen(0), dim=2, hidden=HID, depth=2, device=dev)

    # sanity: Hutchinson estimator is unbiased vs exact trace — straight off
    # the registered estimator objects, one state batch, 64 probe draws
    # (on perturbed params: the zero-init output layer has J = 0 exactly)
    g7 = gen(7)
    fq = tree_map(lambda a: a + 0.3 * torch.randn(a.shape, generator=g7,
                                                  device=dev), fp)
    xs = x[:100]
    g0 = gen(0)
    probes = torch.stack([Hutchinson().init_noise(g0, xs)
                          for _ in range(64)])
    err = trace_bias(fq, xs, probes)
    print(f"hutchinson-vs-exact trace |bias| over 64 probes: {err:.4f}")

    opt = Adam(fp, 5e-3)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = nll(opt.params, x, reg=KINETIC_REG)
        opt.step(opt.grads(loss), i)
        losses.append(loss.detach())
    losses = [float(v) for v in losses]                 # ends in a sync
    step_ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
    fp = opt.params
    with torch.no_grad():
        test_nll = float(nll(fp, xt, method=args.method))
        # honest NLL: re-discretize finely with a higher-order solver — a
        # CNF trained on a fixed coarse grid can game the discretized
        # logdet, and the fine-solver eval (paper Table 2 spirit) exposes
        # that
        test_nll_fine = float(nll(fp, xt, method="naive",
                                  solver_n=("rk4", 64)))
        base_nll = float(-(-0.5 * (xt ** 2).sum(-1)
                           - math.log(2 * math.pi)).mean())
    print(f"train NLL: first={losses[0]:.3f} last={losses[-1]:.3f}")
    print(f"test NLL coarse(alf,8)={test_nll:.3f}  fine(rk4,64)="
          f"{test_nll_fine:.3f}  raw-gaussian baseline={base_nll:.3f}")
    assert test_nll_fine < base_nll, "flow must beat the identity baseline"

    # trainable integration bounds (the FFJORD end_time parameter): the
    # analytic boundary cotangent of the test NLL w.r.t. the flow end time
    t1 = torch.tensor(1.0, device=dev, requires_grad=True)
    (g_t1,) = torch.autograd.grad(nll_nats(FLOW.log_prob(
        fp, xt, solver=ALF(backend="cuda"), controller=ConstantSteps(8),
        t1=t1, diff_bounds=True)), t1)
    print(f"d(test NLL)/d t1 = {float(g_t1):+.4f} (diff_bounds=True)")

    # sample back through the inverse flow, requesting the whole flow path
    # on an observation grid in ONE call — the continuous-generative-model
    # visualization (paper Fig. 6 spirit)
    flow_ts = torch.linspace(1.0, 0.0, 5, device=dev)
    with torch.no_grad():
        traj = flow_path(fp, gen(2), flow_ts)
    assert tuple(traj.shape) == (5, 8, 2)
    for t, snap in zip(flow_ts.tolist(), traj.cpu().numpy()):
        print(f"flow t={t:.2f} sample[0]={snap[0].round(2).tolist()}")
    print("samples (first 3):", traj[-1][:3].cpu().numpy().round(2).tolist())
    return {"trace_bias": err, "losses": losses, "test_nll": test_nll,
            "test_nll_fine": test_nll_fine, "base_nll": base_nll,
            "dnll_dt1": float(g_t1), "flow_path": traj.cpu().numpy(),
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
