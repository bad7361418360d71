"""One rank of ``tests/test_torch_fleet_blocks.py`` (not collected: the
test starts W of these as subprocesses, rendezvousing through a
``FileStore``).

    python tests/torch_fleet_rank.py RANK WORLD STORE OUT SCENARIO[,SCENARIO]

A residual branch with ``ode.batch_axis`` set is the JAX package's
``shard_map`` over that axis: each microbatch's rows cut into as many
contiguous blocks as the axis has ranks, each solved alone. Scenarios,
on meshes made with ``init_device_mesh`` (gloo on the CPU):

* ``solve``: ``solve(..., batching=Sharded(axis))`` of this rank's rows
  of a (B, D) batch inside ``data_parallel.fleet`` (SOLVE_CASES x MALI
  and Naive); rank 0 writes ``OUT/solve_<case>_<method>.npz`` with the
  global end state, per-row counters and gradients;
* ``train``: one ``train_step`` of qwen3's smoke config under 'tp'
  (TRAIN_CASES), each branch's per-row counters noted;
* ``f8``: deepseek-moe's smoke config with capacity drops, fixed steps,
  ``ode_batch_axis="data"`` on (pod 2, data 2): each rank's kept masks
  of a forward over its rows (``OUT/f8_kept_<rank>.npz``), and one step.

Rank 0 writes ``OUT/result.json``. Imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import OdeSettings, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch

# the solve level: torch_adaptive_group_rank's field on its (B, D) batch
from torch_adaptive_group_rank import (ATOL, B, ETA, MAX_STEPS,  # noqa: F401
                                       RTOL, T1, field, inputs)
from torch_dp_rank import _same_on_every_rank

# mesh:axis; every mesh gives the fleet two blocks of 4 rows
SOLVE_CASES = ("2x2x1:data", "2x2x1:pod", "2x2:model")
METHODS = ("mali", "naive")

MALI = dict(mode="per_block", method="mali", solver="alf", n_steps=2)
ADAPTIVE = dict(MALI, n_steps=0)
BATCH = dict(seed=5, global_batch=8, seq_len=16)
# name: (mesh, ode.batch_axis, ODE settings, global batch, microbatches);
# at 4 rows the two blocks take different steps (72 and 69 accepted)
TRAIN_CASES = {
    # a block spans 2 ranks (the pods' data ranks)
    "data_2x2x1": ("2x2x1", "data", ADAPTIVE, 4, 1),
    "pod_2x2x1": ("2x2x1", "pod", ADAPTIVE, 4, 1),
    # two microbatches of 4 rows, each cut into 2 blocks of 2 ranks
    "data_2x2x1_mb2": ("2x2x1", "data", ADAPTIVE, 8, 2),
    # a block is one data rank's rows, the 'model' ranks hold the same
    "model_2x2": ("2x2", "model", ADAPTIVE, 4, 1),
    # F7: every rank holds every row, two blocks solved one after another
    "model_1x2_constant": ("1x2", "model", MALI, 4, 1),
    "model_1x2_adaptive": ("1x2", "model", ADAPTIVE, 4, 1),
}
WORLDS = {2: ["train"], 4: ["solve", "train", "f8"]}
# deepseek-moe's smoke config under its own strategy, with drops
MOE = dict(moe_capacity_factor=0.5)
MOE_BATCH = dict(seed=5, global_batch=8, seq_len=16)


def mesh_of(name):
    shape = tuple(int(n) for n in name.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return shape, axes


def world_of(mesh_name) -> int:
    return int(np.prod(mesh_of(mesh_name)[0]))


def qwen_cfg(ode, axis):
    return dataclasses.replace(
        smoke_config("qwen3-1.7b", OdeSettings(**ode, batch_axis=axis)),
        sharding="tp")


def moe_cfg(axis):
    return dataclasses.replace(
        smoke_config("deepseek-moe-16b", OdeSettings(**MALI,
                                                     batch_axis=axis)),
        **MOE)


def batch(cfg, step=0, **kw):
    return batch_to_device(make_batch(cfg, DataConfig(**{**BATCH, **kw}),
                                      step), "cpu")


_MESHES = {}


def _mesh(name):
    from torch.distributed.device_mesh import init_device_mesh
    if name not in _MESHES:
        shape, axes = mesh_of(name)
        _MESHES[name] = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return _MESHES[name]


def _every_rank(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _norm_counts():
    from repro_torch.distributed.data_parallel import collective_counts
    return {k: v["calls"] for k, v in collective_counts().items()
            if k.startswith("error_norm")}


def _rows_here(plan, nb, microbatches=1):
    """This rank's global row indices of an ``nb``-row batch."""
    rows, _ = plan.local_rows({"tokens": torch.arange(nb)[:, None]},
                              microbatches)
    return rows["tokens"][:, 0].tolist()


def solve_case(case, method, out):
    """One Sharded solve of this rank's rows inside the fleet."""
    import repro_torch.core as T
    from repro_torch.distributed.data_parallel import (
        fleet, mesh_group, reset_collective_counts)
    mesh_name, axis = case.split(":")
    mesh = _mesh(mesh_name)
    rows = mesh_group(mesh, ("pod", "data"))
    n = B // rows.size
    mine = slice(rows.rank * n, (rows.rank + 1) * n)
    p_np, z_np, w_np = inputs("float32")
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    z0 = torch.tensor(z_np[mine], requires_grad=True)
    gradient = T.MALI() if method == "mali" else T.Naive()
    reset_collective_counts()
    with fleet(mesh, axis, rows) as part:
        sol = T.solve(field, params, z0, 0.0, T1, solver=T.ALF(eta=ETA),
                      controller=T.AdaptiveController(RTOL, ATOL, MAX_STEPS),
                      gradient=gradient, batching=T.Sharded(axis))
        loss = torch.sum(sol.ys * torch.tensor(w_np[mine]))
        grads = torch.autograd.grad(
            loss, [params[k] for k in sorted(params)] + [z0])
    counts = _norm_counts()

    def gathered(t):
        return rows.all_gather(t.detach().contiguous(), name="gather")

    g_params = [rows.all_reduce(g) for g in grads[:-1]]
    per = sol.stats.per_sample
    res = {"ys": gathered(sol.ys).numpy(),
           "g_z0": gathered(grads[-1]).numpy(),
           **{f"g_{k}": g.numpy() for k, g in zip(sorted(params), g_params)},
           "per_sample": torch.stack([gathered(c) for c in per]).numpy()}
    if dist.get_rank() == 0:
        np.savez(out / f"solve_{mesh_name}_{axis}_{method}.npz", **res)
    return {"counts": counts, "parts": part.parts,
            "group": None if part.group is None else part.group.axis,
            "group_size": 1 if part.group is None else part.group.size,
            "trials": int(per.n_accepted[0] + per.n_rejected[0]),
            "ys_same": _same_on_every_rank(torch.from_numpy(res["ys"]))}


def solve(out):
    return {f"{case}_{method}": solve_case(case, method, out)
            for case in SOLVE_CASES for method in METHODS}


def _noting_solve(log):
    """``models.transformer.solve`` wrapped to note each branch solve's
    per-row (accepted, rejected, f-evals)."""
    from repro_torch.models import transformer
    inner = transformer.solve

    def noting(*args, **kw):
        sol = inner(*args, **kw)
        per = sol.stats.per_sample
        log.append(torch.stack([per.n_accepted, per.n_rejected,
                                per.n_fevals]).tolist())
        return sol

    return transformer, inner, noting


def train_case(name, out):
    from repro_torch.distributed.data_parallel import (
        DataParallel, reset_collective_counts)
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train import train_step
    mesh_name, axis, ode, nb, mb = TRAIN_CASES[name]
    mesh = _mesh(mesh_name)
    cfg = qwen_cfg(ode, axis)
    whole = torch.load(out.parent / "weights.pt")
    plan = DataParallel(cfg, mesh, whole)
    params = plan.param_shards(whole)
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=1)
    opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
    log = []
    transformer, inner, noting = _noting_solve(log)
    reset_collective_counts()
    transformer.solve = noting
    try:
        with mesh:
            params, _, _, m = train_step(params, opt, None,
                                         batch(cfg, global_batch=nb),
                                         cfg=cfg, opt_cfg=opt_cfg,
                                         microbatches=mb, zero1=True)
    finally:
        transformer.solve = inner
    counts = _norm_counts()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "rows": _every_rank(_rows_here(plan, nb, mb)),
            "branches": _every_rank(log),
            "counts": _every_rank(counts),
            "params_equal": _same_on_every_rank(plan.gather_params(params))}


def train(out):
    world = dist.get_world_size()
    return {name: train_case(name, out) for name, case in TRAIN_CASES.items()
            if world_of(case[0]) == world}


def f8(out):
    """The kept masks of a forward over this rank's rows under the fleet
    of 'data' on (pod 2, data 2), and one step."""
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models.moe import recording_routes
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train import train_step
    mesh = _mesh("2x2x1")
    cfg = moe_cfg("data")
    whole = init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    plan = DataParallel(cfg, mesh, whole)
    rows, split = plan.local_rows(batch(cfg, **MOE_BATCH))
    with torch.no_grad(), recording_routes() as log, plan.computing(split):
        lm_loss(whole, cfg, rows)
    np.savez(out / f"f8_kept_{dist.get_rank()}.npz",
             *[r.kept.numpy() for r in log])
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=1)
    params = plan.param_shards(whole)
    opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
    with mesh:
        params, _, _, m = train_step(params, opt, None,
                                     batch(cfg, **MOE_BATCH), cfg=cfg,
                                     opt_cfg=opt_cfg, zero1=True)
    return {"calls": len(log),
            "rows": _every_rank(_rows_here(plan, MOE_BATCH["global_batch"])),
            "metrics": {k: float(v) for k, v in m.items()},
            "params_equal": _same_on_every_rank(plan.gather_params(params))}


SCENARIOS = {"solve": solve, "train": train, "f8": f8}


def main(argv):
    rank, world, store, out = (int(argv[1]), int(argv[2]), argv[3],
                               Path(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {name: SCENARIOS[name](out) for name in argv[5].split(",")}
    if rank == 0:
        (out / "result.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)


if __name__ == "__main__":
    main(sys.argv)
