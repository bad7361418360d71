"""One rank of ``tests/test_torch_dp_train.py`` (not collected: the test
starts W of these as subprocesses, rendezvousing through a ``FileStore``).

    python tests/torch_dp_rank.py RANK WORLD STORE OUT SCENARIO[,SCENARIO]

Each scenario trains through the port's data-parallel path on the CPU
(gloo) and returns what the test holds against the JAX package and the
port's one-rank run; rank 0 writes ``OUT/result.json``. Imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree_util
from repro_torch.configs import OdeSettings, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch

# qwen3's smoke config made pure-DP, its embedding and head 1024 x 64 =
# 2^16 elements: ZeRO-1 shards both (along dimension 0 and 1)
WIDEN = dict(sharding="dp", vocab_size=1024)
MALI = dict(mode="per_block", method="mali", solver="alf", n_steps=2)
ADAPTIVE = dict(MALI, n_steps=0)
BATCH = dict(seed=5, global_batch=8, seq_len=16)
N_STEPS = 3
STEP_CASES = {"standard": dict(microbatches=1, compress=False),
              "microbatches2": dict(microbatches=2, compress=False),
              "compressed": dict(microbatches=1, compress=True)}
# deepseek-moe's smoke config under its own strategy, with drops
MOE = dict(sharding="fsdp_tp", moe_capacity_factor=0.5)
MOE_STEPS = 2
TRAINER = dict(steps=6, global_batch=4, seq_len=16, ode_steps=2,
               ckpt_every=2, keep=5, log_every=100, emit="memory",
               device="cpu")


def qwen_cfg(ode=MALI, **extra):
    return dataclasses.replace(smoke_config("qwen3-1.7b", OdeSettings(**ode)),
                               **WIDEN, **extra)


def moe_cfg():
    return dataclasses.replace(
        smoke_config("deepseek-moe-16b", OdeSettings(**MALI)), **MOE)


def batch(cfg, step, **kw):
    return batch_to_device(make_batch(cfg, DataConfig(**{**BATCH, **kw}),
                                      step), "cpu")


def metrics_row(m):
    return {k: float(v) for k, v in m.items()}


def _same_on_every_rank(tree) -> bool:
    flat = torch.cat([t.reshape(-1).float()
                      for t in tree_util.tree_leaves(tree)])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(p, flat) for p in parts)


def chained_steps(mesh, out, case):
    from repro_torch.distributed.data_parallel import (
        DataParallel, collective_counts, reset_collective_counts)
    from repro_torch.optim import (OptimizerConfig, init_ef_state,
                                   init_opt_state)
    from repro_torch.train import train_step
    kw = STEP_CASES[case]
    cfg = qwen_cfg()
    params = torch.load(out.parent / "weights.pt")
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=N_STEPS)
    plan = DataParallel(cfg, mesh, params)
    params = plan.param_shards(params)
    local = plan.param_to_opt(params)
    opt = init_opt_state(opt_cfg, local)
    ef = init_ef_state(local) if kw["compress"] else None
    rows = []
    with mesh:
        for step in range(N_STEPS):
            reset_collective_counts()
            params, opt, ef, m = train_step(
                params, opt, ef, batch(cfg, step), cfg=cfg, opt_cfg=opt_cfg,
                zero1=True, **kw)
            rows.append(metrics_row(m))
    params = plan.gather_params(params)
    return {"metrics": rows, "n_sharded": plan.n_sharded,
            "dims": plan.dims, "params_equal": _same_on_every_rank(params),
            "collectives": collective_counts()}


def moe(mesh, out):
    """The kept masks of a forward over this rank's rows, and MOE_STEPS
    data-parallel steps."""
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models.moe import recording_routes
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train import train_step
    cfg = moe_cfg()
    params = init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    plan = DataParallel(cfg, mesh, params)
    rows, split = plan.local_rows(batch(cfg, 0))
    assert split
    with torch.no_grad(), recording_routes() as log, plan.splitting_rows():
        lm_loss(params, cfg, rows)
    rank = dist.get_rank()
    np.savez(out / f"moe_kept_{rank}.npz",
             *[r.kept.numpy() for r in log])
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=MOE_STEPS)
    params = plan.param_shards(params)
    opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
    metrics = []
    with mesh:
        for step in range(MOE_STEPS):
            params, opt, _, m = train_step(params, opt, None,
                                           batch(cfg, step), cfg=cfg,
                                           opt_cfg=opt_cfg, zero1=True)
            metrics.append(metrics_row(m))
    params = plan.gather_params(params)
    return {"metrics": metrics, "n_sharded": plan.n_sharded,
            "calls": len(log), "params_equal": _same_on_every_rank(params)}


def adaptive(mesh, out):
    """One step with adaptive control, each rank's rows solved with its
    own controller (ode.batch_axis='data'); and the refusal without it."""
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.train import Trainer, TrainerConfig, train_step
    cfg = qwen_cfg(dict(ADAPTIVE, batch_axis="data"))
    params = torch.load(out.parent / "weights.pt")
    plan = DataParallel(cfg, mesh, params)
    params = plan.param_shards(params)
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=1)
    with mesh:
        _, _, _, m = train_step(params,
                                init_opt_state(opt_cfg,
                                               plan.param_to_opt(params)),
                                None, batch(cfg, 0), cfg=cfg,
                                opt_cfg=opt_cfg, zero1=True)
    try:
        Trainer(TrainerConfig(**{**TRAINER, "ode_steps": 0}))
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    return {"metrics": metrics_row(m), "refused": refused}


def trainer(mesh, out):
    """The Trainer on two ranks: a clean run, one with a failure injected
    at step 3 on every rank (restored from the step-2 checkpoint), a
    one-rank checkpoint restored here, and a run whose checkpoint the
    one-rank Trainer restores."""
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
    cfg = qwen_cfg()

    def run(steps=TRAINER["steps"], hook=None, **kw):
        t = Trainer(TrainerConfig(**{**TRAINER, "steps": steps, **kw}),
                    emitter=MemoryEmitter(), step_hook=hook, model_cfg=cfg)
        assert t.train() == steps
        return t

    clean = run()
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    faulty = run(hook=hook, ckpt_dir=str(out / "faulty"))
    restored = run(steps=4, ckpt_dir=str(out / "one_rank"))
    whole = restored.whole_state()
    written = run(steps=4, ckpt_dir=str(out / "two_rank"))
    if dist.get_rank() == 0:
        for name, t in (("restored", whole),
                        ("written", written.whole_state())):
            torch.save({k: tree_util.tree_leaves(v) for k, v in
                        (("params", t.params), ("opt", t.opt),
                         ("ef", t.ef))}, out / f"{name}_state.pt")
    else:
        written.whole_state()
    from repro_torch.distributed.data_parallel import plan_for
    return {"clean": clean.loss_trace(), "faulty": faulty.loss_trace(),
            "fired": fired, "n_sharded": clean.plan.n_sharded,
            "mesh_shared": clean.mesh is restored.mesh,
            "plan_shared": clean.plan is plan_for(clean.cfg, clean.mesh,
                                                  clean.state.params),
            "restored_steps": sorted(restored.records),
            "params_equal": _same_on_every_rank(clean.state.params)}


SCENARIOS = {"moe": moe, "adaptive": adaptive, "trainer": trainer,
             **{f"steps_{c}": (lambda m, o, c=c: chained_steps(m, o, c))
                for c in STEP_CASES}}


def main(argv):
    rank, world, store, out = (int(argv[1]), int(argv[2]), argv[3],
                               Path(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cpu")
    results = {name: SCENARIOS[name](mesh, out)
               for name in argv[5].split(",")}
    if rank == 0:
        (out / "result.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)


if __name__ == "__main__":
    main(sys.argv)
