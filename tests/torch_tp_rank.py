"""One rank of ``tests/test_torch_tp_train.py`` (not collected: the test
starts W of these as subprocesses, rendezvousing through a ``FileStore``).

    python tests/torch_tp_rank.py RANK WORLD STORE OUT CASE[,CASE]

A case ``model:strategy:mesh`` (``deepseek:own:2x2``,
``granite:tp:2x1x2``) trains one smoke config through the port's
``train_step`` on a mesh made with ``init_device_mesh`` (2-D ``("data",
"model")`` or 3-D ``("pod", "data", "model")``), gloo on the CPU, and
checks on the ranks what needs them all: the ODE states and replicated
leaves bit-equal where the ranks hold them, the shards against the
rule's slices of the JAX chain's final leaves and of the port's one-rank
chain's, the resident bytes against the rule's reckoning. ``trainer`` and ``checkpoints`` cases move states between
layouts. Rank 0 writes ``OUT/result.json``. Imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree_util
from repro_torch.configs import OdeSettings, get_config, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch

MALI = dict(mode="per_block", method="mali", solver="alf", n_steps=2)
ADAPTIVE = dict(MALI, n_steps=0)
# each model: (arch, its changes, ODE settings); the smoke configs run
# under their own strategy ("own") or 'tp'
MODELS = {
    # capacity drops
    "deepseek": ("deepseek-moe-16b", dict(moe_capacity_factor=0.5), MALI),
    # MQA: wk/wv whole on every rank
    "granite": ("granite-20b", {}, MALI),
    # Mamba, MoE and attention, one period
    "jamba": ("jamba-v0.1-52b", dict(n_periods=1), MALI),
    # six experts: at model 4 each expert's d_ff splits
    "grok6": ("grok-1-314b", dict(moe_experts=6), MALI),
    # tied embeddings (under 'tp' the head is split on D), softcaps
    "gemma2": ("gemma2-2b", {}, MALI),
    # pure DP: the batch over 'model' too
    "qwen3": ("qwen3-1.7b", {}, MALI),
    "qwen3a": ("qwen3-1.7b", {}, ADAPTIVE),
    # the int8 error-feedback loop: each block takes its tensor's scale
    "granitec": ("granite-20b", {}, MALI),
}
COMPRESSED = {"granitec"}
BATCH = dict(seed=5, global_batch=4, seq_len=16)
N_STEPS = 3
TRAINER = dict(arch="deepseek-moe-16b", steps=5, global_batch=4, seq_len=16,
               ode_steps=2, ckpt_every=2, keep=5, log_every=100,
               emit="memory", device="cpu")
CKPT_STEPS = 4


def model_cfg(model, strategy="own"):
    arch, changes, ode = MODELS[model]
    own = get_config(arch).sharding
    return dataclasses.replace(smoke_config(arch, OdeSettings(**ode)),
                               sharding=own if strategy == "own" else strategy,
                               **changes)


def parse_mesh(name):
    shape = tuple(int(n) for n in name.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return shape, axes


def batch(cfg, step):
    return batch_to_device(make_batch(cfg, DataConfig(**BATCH), step), "cpu")


def _checksums(tree):
    """Per leaf, the sum of its bit patterns and of its values: equal on
    two ranks only if the leaves are (almost surely) bit-equal."""
    out = []
    for t in tree_util.tree_leaves(tree):
        bits = t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
        out += [torch.sum(bits, dtype=torch.int64).double(),
                torch.sum(t.double())]
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.float64)


def _every_rank(t):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def _equal_where(tree, key_of_rank) -> bool:
    """Whether every two ranks with the same key hold ``tree`` bit for
    bit."""
    sums = _every_rank(_checksums(tree))
    keys = [key_of_rank(r) for r in range(dist.get_world_size())]
    return all(torch.equal(sums[a], sums[b])
               for a in range(len(keys)) for b in range(len(keys))
               if keys[a] == keys[b])


def _coords(mesh):
    """Every rank's coordinates, {axis: coordinate}, by global rank."""
    names = mesh.mesh_dim_names
    out = {}
    for idx in np.ndindex(*mesh.mesh.shape):
        out[int(mesh.mesh[idx])] = dict(zip(names, idx))
    return out


def _rule_bytes(plan, cfg, opt_cfg):
    """(parameter bytes, optimizer bytes) a rank holds by the rules."""
    from repro_torch.distributed.sharding import (opt_state_shardings,
                                                  param_shardings,
                                                  shard_bytes)
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.common import torch_dtype
    meta = param_specs(cfg)
    p_sh = param_shardings(cfg, plan.mesh, meta)
    o_sh = opt_state_shardings(cfg, plan.mesh, p_sh, meta)
    mom = torch_dtype(opt_cfg.momentum_dtype)
    opt = (2 * shard_bytes(o_sh, meta, plan.mesh, mom)
           + shard_bytes(o_sh, meta, plan.mesh, torch.float32) + 4)
    return shard_bytes(p_sh, meta, plan.mesh), opt


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_util.tree_leaves(tree))


def _leaf_instances(plan, params) -> int:
    """How many (leaf, layer) instances FSDP gathers in a forward: a
    period-stacked leaf once a period."""
    n = 0
    for (path, leaf), d in zip(
            torch.utils._pytree.tree_flatten_with_path(params)[0],
            plan.fsdp_dims):
        if d is not None:
            stacked = any(getattr(p, "key", None) == "period" for p in path)
            n += leaf.shape[0] if stacked else 1
    return n


def steps(out, model, strategy, mesh_name):
    """N_STEPS chained steps from the test's weights."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.data_parallel import (
        DataParallel, collective_counts, reset_collective_counts)
    from repro_torch.distributed.sharding import _path_names
    from repro_torch.distributed.tensor_parallel import recording_states
    from repro_torch.optim import (OptimizerConfig, init_ef_state,
                                   init_opt_state)
    from repro_torch.train import train_step
    cfg = model_cfg(model, strategy)
    compress = model in COMPRESSED
    shape, axes = parse_mesh(mesh_name)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    whole = torch.load(out.parent / f"weights_{model}.pt")
    plan = DataParallel(cfg, mesh, whole)
    params = plan.param_shards(whole)
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=N_STEPS)
    opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
    ef = init_ef_state(plan.param_to_opt(params)) if compress else None
    coords = _coords(mesh)
    # the ranks of one 'model' group solve the same rows ('dp' configs
    # split the rows over 'model' too)
    row_axes = plan._row_axes(batch(cfg, 0))
    rows_key = lambda r: tuple(coords[r][a] for a in row_axes)
    rows, counts, states_equal = [], [], []
    with mesh:
        for step in range(N_STEPS):
            reset_collective_counts()
            with recording_states() as states:
                params, opt, ef, m = train_step(
                    params, opt, ef, batch(cfg, step), cfg=cfg,
                    opt_cfg=opt_cfg, zero1=True, compress=compress)
            rows.append({k: float(v) for k, v in m.items()})
            counts.append(collective_counts())
            # the ODE states of a 'model' group's ranks (same rows)
            states_equal.append(_equal_where(states, rows_key)
                                and len(states) > 0)
    # replicated leaves (and every block) bit-equal on the ranks holding
    # the same block
    same_block = []
    for t, lay in zip(tree_util.tree_leaves(params), plan.leaves):
        split = {a for _, names in lay.param for a in names}
        same_block.append(_equal_where(
            [t], lambda r: tuple(coords[r][a] for a in axes if a in split)))
    # the shards against the rule's slices of the JAX chain's final
    # leaves and of the port's one-rank chain's
    shard_err = {}
    for name, against in (("shard_err", "jax_final"),
                          ("shard_err_one_rank", "final")):
        final = plan.param_shards(
            torch.load(out.parent / f"{against}_{model}.pt"), copy=False)
        shard_err[name] = err = {}
        for (path, got), want in zip(
                torch.utils._pytree.tree_flatten_with_path(params)[0],
                tree_util.tree_leaves(final)):
            assert got.shape == want.shape, (got.shape, want.shape)
            scale = max(float(torch.linalg.norm(want.double())), 1e-30)
            err["/".join(_path_names(path))] = float(
                torch.linalg.norm((got - want).double())) / scale
    rule_p, rule_o = _rule_bytes(plan, cfg, opt_cfg)
    return {"metrics": rows, "counts": counts, "states_equal": states_equal,
            "blocks_equal": all(same_block), **shard_err,
            "param_bytes": _bytes(params), "rule_param_bytes": rule_p,
            "opt_bytes": _bytes(opt), "rule_opt_bytes": rule_o,
            "whole_param_bytes": _bytes(whole),
            "gather_instances": _leaf_instances(plan, whole),
            "n_fsdp": plan.n_fsdp, "tensor_parallel": plan.model is not None,
            "model_group_size": plan.model.size if plan.model else 1}


def _state_file(state, path):
    torch.save({k: tree_util.tree_leaves(v) for k, v in
                (("params", state.params), ("opt", state.opt),
                 ("ef", state.ef))}, path)


def trainer(out):
    """deepseek-moe's smoke config on the (W, 1) host mesh through the
    Trainer: a failure injected at step 3 resumes to the clean trace bit
    for bit; a one-rank checkpoint restored; a checkpoint written for the
    other layouts to restore."""
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig

    def run(steps=TRAINER["steps"], hook=None, **kw):
        t = Trainer(TrainerConfig(**{**TRAINER, "steps": steps, **kw}),
                    emitter=MemoryEmitter(), step_hook=hook,
                    model_cfg=model_cfg("deepseek"))
        assert t.train() == steps
        return t

    clean = run()
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    faulty = run(hook=hook, ckpt_dir=str(out / "faulty"))
    restored = run(steps=CKPT_STEPS, ckpt_dir=str(out / "one_rank"))
    whole = restored.whole_state()
    written = run(steps=CKPT_STEPS, ckpt_dir=str(out / "two_rank"))
    written_whole = written.whole_state()
    if dist.get_rank() == 0:
        _state_file(whole, out / "trainer_restored_state.pt")
        _state_file(written_whole, out / "trainer_written_state.pt")
    plan = clean.plan
    return {"clean": clean.loss_trace(), "faulty": faulty.loss_trace(),
            "fired": fired, "restored_steps": sorted(restored.records),
            "n_fsdp": plan.n_fsdp,
            "param_bytes": _bytes(clean.state.params),
            "whole_param_bytes": _bytes(whole.params),
            "opt_bytes": _bytes(clean.state.opt)}


def checkpoints(out):
    """On a (2, 2) mesh: the (2, 1) Trainer's checkpoint and the one-rank
    one restored into the rule's shards and gathered whole again, and a
    checkpoint written from the shards for the one-rank Trainer."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import TrainerConfig
    from repro_torch.train.loop import get_train_loop
    from repro_torch.train.state import (TrainState, config_fingerprint,
                                         init_rng, restore_train_state,
                                         state_tree)
    from repro_torch.train.trainer import _map_shards, build
    tc = TrainerConfig(**{**TRAINER, "steps": CKPT_STEPS})
    _, _, opt_cfg = build(tc)
    cfg = model_cfg("deepseek")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    fp = config_fingerprint(cfg, opt_cfg, arch=tc.arch, loop=tc.loop,
                            microbatches=tc.microbatches, seed=tc.seed,
                            global_batch=tc.global_batch,
                            seq_len=tc.seq_len)
    whole = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    plan = DataParallel(cfg, mesh, whole)
    params = plan.param_shards(whole)
    local = plan.param_to_opt(params)
    like = TrainState(params, init_opt_state(opt_cfg, local),
                      get_train_loop(tc.loop).init_carry(local),
                      init_rng(tc.seed))
    template = _map_shards(like, plan.whole_like, plan.whole_like)
    res = {}
    for name in ("one_rank", "two_rank"):
        step, got, _ = restore_train_state(str(out / name), template, fp)
        mine = _map_shards(got, plan.shard,
                           lambda t: plan.param_shards(t, copy=False))
        back = _map_shards(mine, lambda t: plan.gather(t, host=True),
                           lambda t: plan.gather_params(t, host=True))
        res[name] = step
        if dist.get_rank() == 0:
            _state_file(back, out / f"grid_{name}_state.pt")
        if name == "one_rank":
            res["shard_bytes"] = _bytes(mine.params)
            if dist.get_rank() == 0:
                save_checkpoint(str(out / "grid"), step, state_tree(back),
                                metadata=fp)
    dist.barrier()
    return res


def main(argv):
    rank, world, store, out = (int(argv[1]), int(argv[2]), argv[3],
                               Path(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    for case in argv[5].split(","):
        if case == "trainer":
            results[case] = trainer(out)
        elif case == "checkpoints":
            results[case] = checkpoints(out)
        else:
            results[case] = steps(out, *case.split(":"))
    if rank == 0:
        (out / "result.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)


if __name__ == "__main__":
    main(sys.argv)
