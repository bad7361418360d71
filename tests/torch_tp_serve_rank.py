"""One rank of ``tests/test_torch_tp_serve.py`` (not collected: the test
starts W of these as subprocesses, rendezvousing through a ``FileStore``).

    python tests/torch_tp_serve_rank.py RANK WORLD STORE OUT CASE[,CASE]

A case ``model:strategy:mesh:batch`` (``granite:own:2x2:4``,
``qwen3:own:2x1:1``) serves one smoke config through the port's
``prefill`` and ``decode_step`` under a mesh made with
``init_device_mesh`` (2-D ``("data", "model")`` or 3-D ``("pod",
"data", "model")``), gloo on the CPU: a prompt of ``PROMPT`` tokens and
``N_DECODE`` teacher-forced decode steps from the weights the test saved,
each rank holding its shards (cut from the whole weights, and drawn leaf
by leaf through ``init_lm(..., cut=plan.cut)``, which must agree). It
checks on the ranks what needs them all: the logits equal on every rank,
the ALF states bit-equal on the ranks that compute the same rows, each
rank's caches against the rule's slices of the JAX package's caches
(after prefill and after the last step; and of the JAX caches from
weights moved by one rounding, the noise floor), the resident bytes
against the rules' reckoning, the collectives and FSDP gathers of each
step. ``refusals`` cases check what the serve path refuses on a mesh.
Rank 0 writes ``OUT/result.json`` and its logits. Imports no JAX.
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

MALI = dict(mode="per_block", method="mali", solver="alf", n_steps=2)
# each model: (arch, its changes); the smoke configs serve under their own
# strategy ("own") or 'tp'
MODELS = {
    # a dense prelude layer, MoE with shared experts
    "deepseek": ("deepseek-moe-16b", {}),
    # MQA: K/V whole, the cache split on d_head over 'model'
    "granite": ("granite-20b", {}),
    # Mamba, MoE and attention, one period
    "jamba": ("jamba-v0.1-52b", dict(n_periods=1)),
    # MoE in every layer
    "grok": ("grok-1-314b", {}),
    # input_mode="embeds"
    "internvl2": ("internvl2-76b", {}),
    # pure DP: replicated weights, the caches split over 'model'
    "qwen3": ("qwen3-1.7b", {}),
    # the LSTM caches: served under a data split alone
    "xlstm": ("xlstm-125m", {}),
}
PROMPT, N_DECODE = 12, 4


def model_cfg(model, strategy="own"):
    arch, changes = MODELS[model]
    own = get_config(arch).sharding
    return dataclasses.replace(smoke_config(arch, OdeSettings(**MALI)),
                               sharding=own if strategy == "own" else strategy,
                               **changes)


def parse_mesh(name):
    shape = tuple(int(n) for n in name.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return shape, axes


def inputs(cfg, batch):
    """Seeded prompt and decode inputs, [batch, PROMPT + N_DECODE]
    tokens or [batch, PROMPT + N_DECODE, d_model] embeddings."""
    rng = np.random.default_rng(1)
    n = PROMPT + N_DECODE
    if cfg.input_mode == "embeds":
        return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)


def prompt_batch(cfg, x):
    return {"embeds" if cfg.input_mode == "embeds" else "tokens":
            torch.tensor(x[:, :PROMPT])}


def decode_input(x, i):
    return torch.tensor(x[:, PROMPT + i:PROMPT + i + 1])


def cache_names(cache):
    """The key paths of a cache tree, '/'-joined, in leaf order."""
    from repro_torch.distributed.sharding import _path_names
    return ["/".join(_path_names(p)) for p, _ in
            torch.utils._pytree.tree_flatten_with_path(cache)[0]]


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


def _equal_where(tree, key_of_rank) -> bool:
    """Whether every two ranks with the same key hold ``tree`` bit for
    bit."""
    mine = _checksums(tree)
    sums = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(sums, mine)
    keys = [key_of_rank(r) for r in range(dist.get_world_size())]
    return all(torch.equal(sums[a], sums[b])
               for a in range(len(keys)) for b in range(len(keys))
               if keys[a] == keys[b])


def _coords(mesh):
    """Every rank's coordinates, {axis: coordinate}, by global rank."""
    names = mesh.mesh_dim_names
    return {int(mesh.mesh[idx]): dict(zip(names, idx))
            for idx in np.ndindex(*mesh.mesh.shape)}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_util.tree_leaves(tree))


def gather_instances(plan, cfg, whole) -> int:
    """How many (leaf, layer) gathers over 'data' a serve step makes: a
    period-stacked leaf once a period, the embedding once (not read by an
    ``input_mode="embeds"`` config), the head once."""
    n = 0
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(whole)[0]:
        from repro_torch.distributed.sharding import _path_names
        names = _path_names(path)
        if plan.fsdp_dim(plan.by_path[names]) is None:
            continue
        if names == ("embed",) and cfg.input_mode == "embeds":
            continue
        n += leaf.shape[0] if "period" in names else 1
    return n


def cache_slices(plan, cache):
    """The rank's block of each leaf of a whole cache tree (views), by
    ``cache_shardings``."""
    from repro_torch.distributed.data_parallel import _dims
    from repro_torch.distributed.sharding import cache_shardings
    specs = cache_shardings(plan.cfg, plan.mesh, cache, plan.batch)
    return torch.utils._pytree.tree_map(
        lambda t, spec: plan._narrow(t, _dims(spec, plan.sizes)),
        cache, specs)


def _cache_errors(plan, cfg, cache, out, tag, batch, s_max):
    """Per cache leaf: (max |port - the rule's slice of the JAX cache|,
    max |moved slice - slice|) over max |JAX leaf|, the moved cache from
    weights moved by one rounding (None where the test saved none)."""
    from repro_torch.models import init_cache
    errs = {}
    want = {}
    for kind in ("jax", "moved"):
        path = out.parent / f"{kind}_cache_{tag}.pt"
        if not path.exists():
            continue
        flat = torch.load(path)
        whole = init_cache(cfg, batch, s_max, "cpu")
        names = cache_names(whole)
        leaves, spec = torch.utils._pytree.tree_flatten(whole)
        whole = torch.utils._pytree.tree_unflatten(
            [flat[n] for n in names], spec)
        want[kind] = (names, tree_util.tree_leaves(cache_slices(plan, whole)),
                      [float(flat[n].abs().max()) for n in names])
    names, slices, scale = want["jax"]
    moved = want.get("moved", (None, [None] * len(names), None))[1]
    for name, got, w, m, sc in zip(names, tree_util.tree_leaves(cache),
                                   slices, moved, scale):
        assert got.shape == w.shape, (name, got.shape, w.shape)
        sc = max(sc, 1e-30)
        errs[name] = (float((got - w).abs().max()) / sc,
                      None if m is None else float((m - w).abs().max()) / sc)
    return errs


def serve_case(out, model, strategy, mesh_name, batch):
    """PROMPT tokens and N_DECODE teacher-forced steps on the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.data_parallel import (
        collective_counts, reset_collective_counts, serve_plan_for)
    from repro_torch.distributed.tensor_parallel import recording_states
    from repro_torch.launch.specs import META, serve_shard_bytes
    from repro_torch.models import (decode_step, init_cache, init_lm,
                                    init_serve_state, prefill)
    cfg = model_cfg(model, strategy)
    shape, axes = parse_mesh(mesh_name)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    whole = torch.load(out.parent / f"weights_{model}.pt")
    x = inputs(cfg, batch)
    s_max = PROMPT + N_DECODE
    tag = f"{model}_{batch}"
    coords = _coords(mesh)
    res = {}
    with mesh:
        plan = serve_plan_for(cfg, mesh, batch)
        params = plan.param_shards(whole)
        drawn = init_lm(torch.Generator().manual_seed(0), cfg, "cpu",
                        cut=plan.cut)
        cut_whole = plan.param_shards(
            init_lm(torch.Generator().manual_seed(0), cfg, "cpu"))
        res["init_cut_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_util.tree_leaves(drawn),
                                              tree_util.tree_leaves(cut_whole)))
        state = init_serve_state(cfg, batch, s_max, "cpu")
        rows_key = lambda r: tuple(coords[r][a] for a in plan.row_axes)
        logits, counts, states_equal = [], [], []
        for step in range(N_DECODE + 1):
            reset_collective_counts()
            with recording_states() as states:
                if step == 0:
                    lg, state = prefill(params, cfg, prompt_batch(cfg, x),
                                        state)
                else:
                    lg, state = decode_step(params, cfg,
                                            decode_input(x, step - 1), state)
            counts.append(collective_counts())
            states_equal.append(len(states) > 0
                                and _equal_where(states, rows_key))
            logits.append(lg)
            if step == 0:
                res["cache_prefill"] = _cache_errors(
                    plan, cfg, state.cache, out, f"{tag}_prefill", batch,
                    s_max)
        res["cache_last"] = _cache_errors(plan, cfg, state.cache, out,
                                          f"{tag}_last", batch, s_max)
        res["pos"] = int(state.pos)
    rule = serve_shard_bytes(cfg, mesh, batch, s_max)
    res.update(
        counts=counts, states_equal=states_equal,
        logits_equal=_equal_where(logits, lambda r: 0),
        param_bytes=_bytes(params), rule_param_bytes=rule["params"],
        cache_bytes=_bytes(state.cache), rule_cache_bytes=rule["cache"],
        whole_param_bytes=_bytes(whole),
        whole_cache_bytes=_bytes(init_cache(cfg, batch, s_max, META)),
        gather_instances=gather_instances(plan, cfg, whole),
        row_axes=list(plan.row_axes),
        model_split=plan.model is not None,
        cache_model_split=plan.tp is not None)
    if dist.get_rank() == 0:
        torch.save(logits, out / f"logits_{model}_{strategy}_{mesh_name}_"
                   f"{batch}.pt")
    return res


def refusals(out, mesh_names):
    """What the serve path refuses on each mesh, by message."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import init_serve_state
    got = {}

    def attempt(key, fn):
        try:
            fn()
            got[key] = None
        except (ValueError, NotImplementedError) as e:
            got[key] = [type(e).__name__, str(e)]

    for name in mesh_names:
        shape, axes = parse_mesh(name)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        with mesh:
            for model, strategy, batch in (("qwen3", "own", 4),
                                           ("qwen3", "own", 2),
                                           ("xlstm", "own", 4),
                                           ("xlstm", "tp", 4),
                                           ("xlstm", "tp", 1)):
                cfg = model_cfg(model, strategy)
                attempt(f"{model}:{strategy}:{name}:{batch}",
                        lambda: init_serve_state(cfg, batch, 16, "cpu"))
            cfg = model_cfg("granite", "tp")
            step = make_decode_step(cfg, capture=True)
            state = init_serve_state(cfg, 4, 16, "cpu")
            attempt(f"capture:{name}", lambda: step(
                {}, torch.zeros((4, 1), dtype=torch.int32), state))
    return got


def main(argv):
    rank, world, store, out = (int(argv[1]), int(argv[2]), argv[3],
                               Path(argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    for case in argv[5].split(","):
        if case.startswith("refusals"):
            results[case] = refusals(out, case.split(":")[1:])
        else:
            model, strategy, mesh, batch = case.split(":")
            results[case] = serve_case(out, model, strategy, mesh,
                                       int(batch))
    if rank == 0:
        (out / "result.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)


if __name__ == "__main__":
    main(sys.argv)
