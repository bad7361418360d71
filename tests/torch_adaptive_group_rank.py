"""One rank of ``tests/test_torch_adaptive_group.py`` (not collected: the
test starts W of these as subprocesses, rendezvousing through a
``FileStore``).

    python tests/torch_adaptive_group_rank.py RANK WORLD STORE OUT

Each case solves this rank's rows of one (B, D) batch with ``solve()``
as one Lockstep system under ``global_error_norm`` over the W ranks (one
adaptive controller over the global batch), then differentiates a
weighted sum of the end states. Cases: float32 and float64 x
``AdaptiveController`` and ``ReproducibleController`` x MALI and Naive,
ALF at eta 0.9. Per case rank 0 writes ``OUT/<case>.npz``: the global
end state and its gradient with respect to every row of z0 (gathered),
the parameters' gradient (summed over the ranks), the counters, the
accepted step times of a ``SaveAt(steps=True)`` solve, the error ratios
of every trial, whether the ratios and step times are bit-equal on the
ranks, and the collectives counted. Imports no JAX.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

B, D = 8, 6
RTOL, ATOL, MAX_STEPS = 1e-2, 1e-3, 64
ETA = 0.9
T1 = 1.5
DTYPES = ("float32", "float64")
CONTROLLERS = ("adaptive", "reproducible")
METHODS = ("mali", "naive")
CASES = [f"{d}_{c}_{m}" for d in DTYPES for c in CONTROLLERS
         for m in METHODS]


def inputs(dtype):
    """The seeded field parameters, z0 [B, D] (rows of several
    stiffnesses) and the loss weights [B, D], as numpy arrays."""
    rng = np.random.default_rng(11)
    dt = np.dtype(dtype)
    params = {"w": (rng.standard_normal((D, D)) * 2.4).astype(dt),
              "b": (rng.standard_normal(D) * 0.3).astype(dt),
              "c": np.asarray(0.7, dt)}
    z0 = (rng.standard_normal((B, D))
          * np.linspace(0.5, 2.5, B)[:, None]).astype(dt)
    wout = rng.standard_normal((B, D)).astype(dt)
    return params, z0, wout


def field(p, z, t):
    """dz/dt = tanh(z W + b) - z + c sin(3t): every row its own system,
    the rows scaled apart in z0."""
    return torch.tanh(z @ p["w"] + p["b"]) - z + p["c"] * torch.sin(3.0 * t)


def controller(kind):
    import repro_torch.core as T

    base = (T.ReproducibleController if kind == "reproducible"
            else T.AdaptiveController)

    class Recording(base):
        """The controller, every trial's error ratio noted in ``LOG``."""

        def error_ratio(self, err, z0, z1, rows=False):
            r = super().error_ratio(err, z0, z1, rows)
            LOG.append(r.detach().clone())
            return r

    return Recording(RTOL, ATOL, MAX_STEPS)


LOG = []


def _gather_rows(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _same_on_ranks(t) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, t) for p in parts)


def run_case(case, group, out):
    import repro_torch.core as T
    from repro_torch.core.stepsize import global_error_norm
    from repro_torch.distributed.data_parallel import (
        collective_counts, reset_collective_counts)
    dtype, ctrl, method = case.split("_")
    p_np, z_np, w_np = inputs(dtype)
    n = B // group.size
    rows = slice(group.rank * n, (group.rank + 1) * n)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    z0 = torch.tensor(z_np[rows], requires_grad=True)
    wout = torch.tensor(w_np[rows])
    gradient = T.MALI() if method == "mali" else T.Naive()
    solver = T.ALF(eta=ETA)
    c = controller(ctrl)
    LOG.clear()
    reset_collective_counts()
    with global_error_norm(group):
        sol = T.solve(field, params, z0, 0.0, T1, solver=solver,
                      controller=c, gradient=gradient)
        loss = torch.sum(sol.ys * wout)
        grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)]
                                    + [z0])
    counts = collective_counts()
    ratios = torch.stack(LOG)
    n_trials = int(sol.stats.n_accepted + sol.stats.n_rejected)
    # the accepted step times of the same solve, recorded
    LOG.clear()
    with torch.no_grad(), global_error_norm(group):
        steps = T.solve(field, {k: v.detach() for k, v in params.items()},
                        z0.detach(), 0.0, T1, solver=solver, controller=c,
                        gradient=T.Naive(), saveat=T.SaveAt(steps=True))
    live = int(steps.n_live)
    ts = steps.ts[:live].double()
    g_params = [g.detach().clone() for g in grads[:-1]]
    for g in g_params:
        dist.all_reduce(g)
    res = {
        "ys": _gather_rows(sol.ys.detach()).numpy(),
        "g_z0": _gather_rows(grads[-1].detach()).numpy(),
        **{f"g_{k}": g.numpy() for k, g in zip(sorted(params), g_params)},
        "stats": np.asarray([int(sol.stats.n_accepted),
                             int(sol.stats.n_rejected),
                             int(sol.stats.n_fevals)]),
        "ts": ts.numpy(), "ratios": ratios.double().numpy(),
    }
    meta = {
        "ratios_equal": _same_on_ranks(ratios),
        "ts_equal": _same_on_ranks(ts),
        "n_trials": n_trials,
        "norm_calls": counts.get("error_norm", {}).get("calls", 0),
        "norm_axis_calls": counts.get(f"error_norm@{group.axis}",
                                      {}).get("calls", 0),
        "norm_vjp_calls": counts.get("error_norm_vjp", {}).get("calls", 0),
        "ratio_dtype": str(ratios.dtype),
    }
    if dist.get_rank() == 0:
        np.savez(out / f"{case}.npz", **res)
    return meta


def main(argv):
    rank, world, store, out = (int(argv[1]), int(argv[2]), argv[3],
                               Path(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.distributed.data_parallel import DataGroup
    group = DataGroup("data", dist.group.WORLD, world, rank)
    results = {case: run_case(case, group, out) for case in CASES}
    if rank == 0:
        (out / "result.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)


if __name__ == "__main__":
    main(sys.argv)
