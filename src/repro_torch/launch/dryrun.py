"""Dry run of every (arch x shape x mesh) cell on the meta device.

The port of the JAX package's ``repro.launch.dryrun``, which lowers and
compiles each cell on 512 fake host devices. Here each cell runs ONE
rank's step on meta tensors (shapes, no storage, nothing computed) under
a stand-in of the production mesh (``distributed/stand_in.py``: the
16 x 16 ``('data', 'model')`` mesh or the 2 x 16 x 16 ``('pod', 'data',
'model')`` one, the rank at coordinate 0), so the layout code cuts the
rank's shards as on real ranks and no process group is made. The step
is the one the port runs: ``launch.steps.make_train_step`` for a train
cell (ZeRO-1 over the ambient mesh), ``launch.serve.make_prefill_step``
or the eager decode step (``launch.serve.make_decode_step``; a CUDA
graph replay dispatches nothing) for a serve cell. ``launch/cost.py``
counts it, and ``launch/roofline.py`` turns the count into the H100
roofline::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both

Per cell it writes ``<out>/<tag>.json`` and a line of
``<out>/summary.jsonl`` with the JAX record's keys: ``status`` ("ok",
"skipped" by ``cell_applicable``'s rule, "refused" naming the ROADMAP
item the port refuses it by, or "error"), ``active_params``,
``model_flops``, ``chips``, ``memory`` and ``roofline``. ``memory``
holds a rank's parameter, optimizer, batch and cache bytes by the
sharding rules, what stands in for XLA's ``memory_analysis``; the
transient peak (XLA's ``temp_size_in_bytes``) is not reckoned on meta
tensors. It exits 1 if any cell is an ``error``.

Flags are the JAX CLI's. ``--save-hlo`` writes ``<tag>.ops.json``, the
per-op count table (there is no HLO); ``--attn-bwd autodiff`` runs the
training path's attention differentiated by autograd through the tiles
(``ModelConfig.attn_bwd``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
import traceback
from typing import Optional

import torch
import torch.utils._pytree as _pt

from repro_torch.configs import ARCHS, DEFAULT_ODE, get_config
from repro_torch.configs.base import (SHAPE_CELLS, cell_applicable,
                                      get_shape_cell)
from repro_torch.core.ode_block import OdeSettings
from repro_torch.distributed.sharding import _path_names
from repro_torch.distributed.stand_in import StandInMesh
from repro_torch.launch.cost import OpCounter
from repro_torch.launch.mesh import production_axes
from repro_torch.launch.roofline import analyze
from repro_torch.launch.specs import (batch_specs, decode_token_specs,
                                      param_specs, tree_bytes)

# The port's xLSTM mixers loop over the tokens of each chunk in Python
# (models/xlstm.py): a train or prefill cell at thousands of tokens
# dispatches ~10^7 ops, hours on the meta device.
XLSTM_LOOP_ITEM = "ROADMAP queue 2 item 2b.13"
_ITEM_RE = re.compile(r"ROADMAP queue \d+ item \w+(\.\d+)?")


def _active_params(cfg, params_like) -> float:
    """Active (per-token) parameter count: MoE routed experts scaled by
    top_k/E; embedding table excluded (gather, not matmul)."""
    total = 0.0
    moe_frac = (cfg.moe_top_k / cfg.moe_experts) if cfg.moe_experts else 1.0
    for path, leaf in _pt.tree_flatten_with_path(params_like)[0]:
        names = _path_names(path)
        size = 1
        for s in leaf.shape:
            size *= s
        if names[-1] == "embed":
            continue
        if names[-1] in ("w_gate", "w_up", "w_down") and len(leaf.shape) >= 3 \
                and "mlp" in names:
            size *= moe_frac
        total += size
    return total


def _ode_units(cfg, kind: str) -> float:
    """f-eval flop multiplier per block vs a single discrete fwd pass (=2N).

    MALI fixed-step with n steps: fwd = (n+1) evals; train bwd = per-step
    (inverse 1 + vjp 3) + v0-vjp 3 evals (bwd eval ~ 2x fwd)."""
    if cfg.ode.mode == "off":
        return 6.0 if kind == "train" else 2.0
    n = cfg.ode.n_steps
    fwd = 2.0 * (n + 1)
    if kind != "train":
        return fwd
    bwd = 8.0 * n + 6.0
    return fwd + bwd


def _model_flops(cfg, cell, params_like) -> float:
    n_active = _active_params(cfg, params_like)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    return _ode_units(cfg, cell.kind) / 2.0 * 2.0 * n_active * tokens


def _loops_over_tokens(cfg) -> bool:
    return any(l.mixer in ("mlstm", "slstm") for l in cfg.layers())


def _rank_train(cfg, cell, mesh, microbatches: int):
    """(step thunk, memory) of one rank's training step on ``mesh``."""
    from repro_torch.distributed.data_parallel import plan_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    opt_cfg = OptimizerConfig()
    whole = param_specs(cfg)
    plan = plan_for(cfg, mesh, whole)
    params = plan.param_shards(whole)
    opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
    batch = batch_specs(cfg, cell)
    rows, _ = plan.local_rows(batch, microbatches)
    step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                           zero1=True)
    memory = {"params": tree_bytes(params),
              "optimizer": tree_bytes(opt),
              "batch": tree_bytes(rows), "cache": 0}
    return (lambda: step(params, opt, batch)), memory


def _rank_serve(cfg, cell, mesh):
    """(step thunk, memory) of one rank's prefill or decode step."""
    from repro_torch.distributed.data_parallel import serve_plan_for
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.launch.specs import META, serve_shard_bytes
    from repro_torch.models import init_lm
    from repro_torch.models.lm import init_serve_state
    plan = serve_plan_for(cfg, mesh, cell.global_batch)
    params = init_lm(torch.Generator(), cfg, META, cut=plan.cut)
    state = init_serve_state(cfg, cell.global_batch, cell.seq_len, META)
    rules = serve_shard_bytes(cfg, mesh, cell.global_batch, cell.seq_len)
    if cell.kind == "prefill":
        batch = batch_specs(cfg, cell)
        step = make_prefill_step(cfg)
        run = lambda: step(params, batch, state)            # noqa: E731
    else:
        batch = decode_token_specs(cfg, cell)
        step = make_decode_step(cfg)
        run = lambda: step(params, batch, state)            # noqa: E731
    memory = {"params": tree_bytes(params), "optimizer": 0,
              "batch": tree_bytes(plan.local_rows(batch)),
              "cache": tree_bytes(state.cache), "pos": 4,
              "rules": rules}
    return run, memory


def _refusal(e: BaseException) -> Optional[str]:
    """The ROADMAP item a refusal names, if ``e`` is one."""
    if isinstance(e, NotImplementedError):
        m = _ITEM_RE.search(str(e))
        if m:
            return m.group(0)
    return None


def run_cell(arch: str, shape: str, multi_pod: bool,
             ode: Optional[OdeSettings] = DEFAULT_ODE,
             microbatches: int = 1, out_dir: str = "reports/dryrun",
             save_hlo: bool = False, variant: str = "",
             attn_bwd: str = "") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ode_tag = "ode" if (ode and ode.mode != "off") else "discrete"
    tag = f"{arch}__{shape}__{mesh_name}__{ode_tag}"
    if variant:
        tag += f"__{variant}"
    cell = get_shape_cell(shape)
    cfg = get_config(arch, ode=ode)
    if attn_bwd:
        cfg = dataclasses.replace(cfg, attn_bwd=attn_bwd)
    ok, reason = cell_applicable(cfg, cell)
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "ode": ode_tag, "microbatches": microbatches,
              "variant": variant}
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.time()
    axes = production_axes(multi_pod=multi_pod)
    params_like = param_specs(cfg)
    record["active_params"] = _active_params(cfg, params_like)
    record["model_flops"] = _model_flops(cfg, cell, params_like)
    if cell.kind in ("train", "prefill") and _loops_over_tokens(cfg):
        record.update(
            status="refused", item=XLSTM_LOOP_ITEM,
            reason=f"{cfg.name}'s xLSTM mixers loop over the "
                   f"{cell.seq_len} tokens in Python: counting one "
                   f"{cell.kind} step would dispatch ~10^7 ops on meta "
                   f"({XLSTM_LOOP_ITEM})")
        return record
    mesh = StandInMesh(axes)
    try:
        with mesh:
            if cell.kind == "train":
                run, memory = _rank_train(cfg, cell, mesh, microbatches)
            else:
                run, memory = _rank_serve(cfg, cell, mesh)
            t_build = time.time() - t0
            grad = torch.enable_grad() if cell.kind == "train" \
                else torch.no_grad()
            with grad, OpCounter() as counter:
                run()
    except NotImplementedError as e:
        item = _refusal(e)
        if item is None:
            raise
        record.update(status="refused", item=item, reason=str(e))
        return record
    t_count = time.time() - t0 - t_build
    memory["argument_size_in_bytes"] = sum(
        v for k, v in memory.items() if isinstance(v, int))
    memory["temp_size_in_bytes"] = None
    memory["note"] = ("the rank's parameter, optimizer, batch and cache "
                      "bytes by the sharding rules; the transient peak "
                      "is not reckoned on meta tensors")
    roof = analyze(counter, chips=mesh.size(),
                   model_flops=record["model_flops"])
    record.update(
        status="ok", chips=mesh.size(), lower_s=round(t_build, 1),
        compile_s=round(t_count, 1), ops=counter.n_ops,
        kernel_ops=counter.summary()["kernel_ops"], memory=memory,
        roofline=roof.to_dict())

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=2, default=float)
    if save_hlo:
        with open(os.path.join(out_dir, tag + ".ops.json"), "w") as f:
            json.dump(counter.table(), f, indent=1)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--ode", default="on", choices=["on", "off"])
    ap.add_argument("--ode-steps", type=int, default=2)
    ap.add_argument("--fused-bwd", default="on", choices=["on", "off"])
    ap.add_argument("--attn-bwd", default="flash", choices=["flash", "autodiff"])
    ap.add_argument("--variant", default="", help="tag for A/B records")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's per-op count table "
                         "(<tag>.ops.json; there is no HLO)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = ([c.name for c in SHAPE_CELLS] if args.shape == "all"
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    # the kernel ops, as the port runs a step on the card
    ode = (dataclasses.replace(DEFAULT_ODE, n_steps=args.ode_steps,
                               fused_bwd=args.fused_bwd == "on",
                               backend="cuda")
           if args.ode == "on" else OdeSettings(mode="off"))

    summary_path = os.path.join(args.out, "summary.jsonl")
    os.makedirs(args.out, exist_ok=True)
    n = {"ok": 0, "skipped": 0, "refused": 0, "error": 0}
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                label = f"{arch} x {shape} x {'multi' if multi else 'single'}"
                print(f"=== {label} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, multi, ode,
                                   microbatches=args.microbatches,
                                   out_dir=args.out, save_hlo=args.save_hlo,
                                   variant=args.variant,
                                   attn_bwd=args.attn_bwd)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "pod2x16x16" if multi else "pod16x16",
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                with open(summary_path, "a") as f:
                    f.write(json.dumps(rec, default=float) + "\n")
                st = rec.get("status")
                n[st] = n.get(st, 0) + 1
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    extra = (f" flops {r['flops']:.3e} bytes "
                             f"{r['hbm_bytes']:.3e} bound "
                             f"{r['t_bound_s']:.4g} s ({r['bottleneck']}), "
                             f"{rec['ops']} ops in {rec['compile_s']} s")
                elif st == "refused":
                    extra = f" ({rec['item']})"
                print(f"--- {label}: {st}{extra}", flush=True)
    print(f"dry-run complete: {n['ok']} ok, {n['skipped']} skipped (per "
          f"assignment rule), {n['refused']} refused (ROADMAP items), "
          f"{n['error']} failed in {time.time() - t_all:.1f} s")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
