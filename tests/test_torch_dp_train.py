"""Data-parallel training over 2 and 4 gloo ranks on the CPU against the
JAX package and the port's one-rank run.

The ranks are subprocesses (``tests/torch_dp_rank.py``) rendezvousing
through a ``FileStore``; each trains on its rows of the global batch
through ``train_step(..., zero1=True)`` under the host mesh. With GSPMD
the JAX package's sharded step computes its unsharded step's numbers, so
the oracle is ``jitted_train_step`` without a mesh on the global batch:

* three chained ZeRO-1 steps (standard, two microbatches, the compressed
  loop) of qwen3's smoke config made pure-DP with a 1024-token vocabulary
  (its embedding and head, 2^16 elements each, are ZeRO-1 sharded along
  dimensions 0 and 1): loss and grad norm within rtol 1e-5, lr within
  one float32 ulp, counters equal, against the JAX package and the
  port's one-rank steps; parameters bit-equal on every rank;
* deepseek-moe's smoke config under its ``fsdp_tp`` strategy with
  capacity drops: each rank's kept masks equal its block of a one-rank
  forward's on the global batch, and two steps equal one-rank steps;
* adaptive control with one controller over the global batch (no
  ``ode_batch_axis``; the error norm summed over the ranks every trial):
  the step against ``jax.value_and_grad`` of the global batch (loss at
  rtol 1e-5, grad norm at the adaptive bar, f-evals exact), one
  ``error_norm@data`` reduction a trial, parameters bit-equal on the
  ranks, and the Trainer under ``ode_steps=0``;
* adaptive control with ``ode_batch_axis="data"``: the step against the
  per-shard composition (each shard's ``jax.value_and_grad`` alone,
  averaged: the shards hold equal token counts; the grad norm at the
  adaptive batching tests' bar, rtol 2e-5), within rtol 1e-6 of the
  port's own per-shard composition;
* the Trainer: a failure injected at step 3 on every rank resumes to the
  clean two-rank trace bit for bit, the two-rank trace within rtol 1e-5
  of the one-rank one, and checkpoints restore across world sizes with
  equal states.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.lm import lm_loss_and_stats as jax_loss_and_stats
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train.loop import jitted_train_step
from repro_torch import tree_util
from repro_torch.distributed.data_parallel import check_supported
from repro_torch.models import init_lm, lm_loss
from repro_torch.models.moe import recording_routes
from repro_torch.optim import OptimizerConfig, init_ef_state, init_opt_state
from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
from repro_torch.train import loss_and_grads, train_step

import torch_dp_rank as R
from test_torch_train_lm import np_weights
from test_torch_train_optim import _to_jax, _to_torch, assert_ulp_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# adaptive f32 solves against the JAX package: tests/test_batching.py's
# bar (XLA rounds an RK stage time once where eager torch rounds twice,
# ROADMAP "Differences", so step sizes and gradients part at ~1e-5)
ADAPTIVE_TOL = dict(rtol=2e-5, atol=2e-6)
SCENARIOS = {2: ["steps_standard", "steps_microbatches2", "steps_compressed",
                 "moe", "adaptive", "trainer"],
             4: ["steps_standard", "steps_microbatches2", "steps_compressed",
                 "moe"]}


def _jax_cfg(ode=R.MALI, **extra):
    return dataclasses.replace(jax_smoke_config(
        "qwen3-1.7b", JaxOdeSettings(**ode)), **R.WIDEN, **extra)


@functools.lru_cache(maxsize=None)
def _weights():
    return np_weights(_jax_cfg(), seed=3)


def _trainer(steps, **kw):
    t = Trainer(TrainerConfig(**{**R.TRAINER, "steps": steps, **kw}),
                emitter=MemoryEmitter(), model_cfg=R.qwen_cfg())
    assert t.train() == steps
    return t


def _spawn(world: int, tmp: Path):
    """Run the world's scenarios; returns rank 0's results."""
    out = tmp / "out"
    out.mkdir()
    torch.save(_to_torch(_weights(), torch.float32), tmp / "weights.pt")
    if "trainer" in SCENARIOS[world]:
        _trainer(4, ckpt_dir=str(out / "one_rank"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"), str(r),
         str(world), str(tmp / "store"), str(out),
         ",".join(SCENARIOS[world])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=170))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (so, se)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r}: {so[-2000:]}{se[-3000:]}"
        assert f"RANK_OK {r}" in so
    return out, json.loads((out / "result.json").read_text())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: (output directory, rank 0's results) of one run
    of the world's scenarios, shared by the module's tests."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = _spawn(world, tmp_path_factory.mktemp(f"dp{world}"))
        return runs[world]

    return get


# ---------------------------------------------------------------------------
# Oracles on the global batch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_chain(case):
    kw = R.STEP_CASES[case]
    jcfg = _jax_cfg()
    oc = jopt.OptimizerConfig(warmup_steps=1, total_steps=R.N_STEPS)
    p = _to_jax(_weights(), jnp.float32)
    s = jopt.init_opt_state(oc, p)
    ef = jcomp.init_ef_state(p) if kw["compress"] else None
    rows = []
    for step in range(R.N_STEPS):
        b = jax_make_batch(jcfg, JaxDataConfig(**R.BATCH), step)
        p, s, ef, m = jitted_train_step(
            p, s, ef, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg,
            opt_cfg=oc, **kw)
        rows.append({k: float(v) for k, v in m.items()})
    return rows


def _port_chain(cfg, params, n_steps, **kw):
    oc = OptimizerConfig(warmup_steps=1, total_steps=n_steps)
    s = init_opt_state(oc, params)
    ef = init_ef_state(params) if kw.get("compress") else None
    rows = []
    for step in range(n_steps):
        params, s, ef, m = train_step(params, s, ef, R.batch(cfg, step),
                                      cfg=cfg, opt_cfg=oc, **kw)
        rows.append({k: float(v) for k, v in m.items()})
    return rows


@functools.lru_cache(maxsize=None)
def _one_rank_chain(case):
    return _port_chain(R.qwen_cfg(), _to_torch(_weights(), torch.float32),
                       R.N_STEPS, **R.STEP_CASES[case])


def _same_metrics(got, want, what):
    for step, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"{what} {key} step {step}")
        assert_ulp_close(torch.tensor(g["lr"]), torch.tensor(w["lr"]),
                         "float32", f"{what} lr step {step}")
        for key in ("ode_accepted", "ode_rejected", "ode_fevals"):
            assert g[key] == w[key], (what, key, step)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(R.STEP_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_zero1_steps_match_jitted_train_step(spawned, world, case):
    _, res = spawned(world)
    got = res[f"steps_{case}"]
    assert got["n_sharded"] >= 1 and got["params_equal"]
    # the embedding split along its rows, the head along its columns
    assert 0 in got["dims"] and 1 in got["dims"]
    _same_metrics(got["metrics"], _jax_chain(case), f"W{world} vs JAX")
    _same_metrics(got["metrics"], _one_rank_chain(case),
                  f"W{world} vs one rank")
    col = got["collectives"]
    assert col["reduce_scatter"]["calls"] == col["all_gather"]["calls"] \
        == got["n_sharded"]
    assert col["host_staged"]["calls"] == 0      # CPU tensors: no staging


@pytest.mark.parametrize("world", [2, 4])
def test_moe_kept_masks_and_steps(spawned, world):
    out, res = spawned(world)
    got = res["moe"]
    cfg = R.moe_cfg()
    params = init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    with torch.no_grad(), recording_routes() as log:
        lm_loss(params, cfg, R.batch(cfg, 0))
    assert got["calls"] == len(log) > 0 and got["n_sharded"] >= 1
    for r in range(world):
        with np.load(out / f"moe_kept_{r}.npz") as f:
            kept = [f[f"arr_{i}"] for i in range(len(log))]
        for call, mine in zip(log, kept):
            n = mine.shape[0]
            np.testing.assert_array_equal(
                mine, call.kept.numpy()[r * n:(r + 1) * n])
    drops = sum(int((~call.kept).sum()) for call in log)
    assert drops > 0
    assert got["params_equal"]
    _same_metrics(got["metrics"], _port_chain(cfg, params, R.MOE_STEPS),
                  f"W{world} deepseek vs one rank")


def test_adaptive_global_controller_matches_jax(spawned):
    """One adaptive controller over the global batch on two ranks: the
    JAX package's step on the global batch."""
    got = spawned(2)[1]["adaptive"]
    glob = got["global"]
    jcfg = _jax_cfg(R.ADAPTIVE)
    vg = jax.jit(jax.value_and_grad(jax_loss_and_stats, has_aux=True),
                 static_argnums=1)
    p = _to_jax(_weights(), jnp.float32)
    b = jax_make_batch(jcfg, JaxDataConfig(**R.BATCH), 0)
    (loss, stats), g = vg(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    m = glob["metrics"]
    np.testing.assert_allclose(m["loss"], float(loss), rtol=RTOL)
    np.testing.assert_allclose(m["grad_norm"],
                               _norm([jax.tree_util.tree_leaves(g)]),
                               **ADAPTIVE_TOL)
    assert m["ode_fevals"] == int(stats.n_fevals)
    assert m["ode_accepted"] == int(stats.n_accepted)
    assert m["ode_rejected"] == int(stats.n_rejected)
    assert glob["params_equal"]
    # one reduction over 'data' a trial (MALI's backward replays the
    # recorded steps and reduces nothing)
    trials = m["ode_accepted"] + m["ode_rejected"]
    assert glob["norm_calls"] == glob["norm_data_calls"] == trials > 0
    assert got["per_shard"]["norm_calls"] == 0
    assert got["trainer_steps"] == 2 and got["trainer_params_equal"]


def test_adaptive_per_shard_matches_jax(spawned):
    world = 2
    got = spawned(world)[1]["adaptive"]["per_shard"]
    jcfg = _jax_cfg(R.ADAPTIVE)
    vg = jax.jit(jax.value_and_grad(jax_loss_and_stats, has_aux=True),
                 static_argnums=1)
    p = _to_jax(_weights(), jnp.float32)
    b = jax_make_batch(jcfg, JaxDataConfig(**R.BATCH), 0)
    n = R.BATCH["global_batch"] // world
    losses, grads, fevals = [], [], 0
    for r in range(world):
        shard = {k: jnp.asarray(v[r * n:(r + 1) * n]) for k, v in b.items()}
        (loss, stats), g = vg(p, jcfg, shard)
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_leaves(g))
        fevals += n * int(stats.n_fevals)
    np.testing.assert_allclose(got["metrics"]["loss"], np.mean(losses),
                               rtol=RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], _norm(grads),
                               **ADAPTIVE_TOL)
    assert got["metrics"]["ode_fevals"] == fevals
    # the port's own shards, each solved alone: the same composition
    cfg = R.qwen_cfg(R.ADAPTIVE)
    params = _to_torch(_weights(), torch.float32)
    full = R.batch(cfg, 0)
    losses, grads = [], []
    for r in range(world):
        loss, _, g = loss_and_grads(
            params, {k: v[r * n:(r + 1) * n] for k, v in full.items()},
            cfg=cfg)
        losses.append(float(loss))
        grads.append([t.numpy() for t in tree_util.tree_leaves(g)])
    np.testing.assert_allclose(got["metrics"]["loss"], np.mean(losses),
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], _norm(grads),
                               rtol=1e-6)


def _norm(grads):
    """The global norm of the shards' gradients averaged, in float64."""
    mean = [sum(np.asarray(g[i], np.float64) for g in grads) / len(grads)
            for i in range(len(grads[0]))]
    return np.sqrt(sum(float(np.sum(np.square(g))) for g in mean))


def test_trainer_resume_and_checkpoint_interchange(spawned):
    out, res = spawned(2)
    got = res["trainer"]
    assert got["fired"] == [3] and got["faulty"] == got["clean"]
    assert got["n_sharded"] >= 1 and got["params_equal"]
    # one host mesh a process, one plan for the Trainer and its steps
    assert got["mesh_shared"] and got["plan_shared"]
    one = _trainer(R.TRAINER["steps"])
    np.testing.assert_allclose(got["clean"], one.loss_trace(), rtol=RTOL)
    # a one-rank checkpoint restored on two ranks: the whole state equal
    # to the one-rank run's that wrote it
    assert got["restored_steps"] == []
    written = _trainer(4)
    _assert_state_equal(torch.load(out / "restored_state.pt"),
                        written.state)
    # a two-rank checkpoint restored by the one-rank Trainer
    back = _trainer(4, ckpt_dir=str(out / "two_rank"))
    assert back.records == {}
    _assert_state_equal(torch.load(out / "written_state.pt"), back.state)


def _assert_state_equal(saved, state):
    for key, tree in (("params", state.params), ("opt", state.opt),
                      ("ef", state.ef)):
        mine = tree_util.tree_leaves(tree)
        assert len(mine) == len(saved[key]), key
        for a, b in zip(saved[key], mine):
            assert a.dtype == b.dtype and torch.equal(a, b), key


def test_data_parallel_refusals():
    """Meshes with a 'model' axis (tensor parallelism) or a 'pod' axis
    are accepted; so is adaptive control over several data ranks, with
    one controller over the global batch, and with every
    ``ode_batch_axis`` whose fleet's blocks span whole ranks' rows or
    split them (tests/test_torch_fleet_blocks.py). Refused (item 12b):
    a batch axis whose blocks straddle the ranks' rows."""
    cfg = R.qwen_cfg()
    for axes in ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 1},
                 {"data": 16, "model": 16}):
        check_supported(cfg, axes)
    adaptive = R.qwen_cfg(R.ADAPTIVE)
    for axes in ({"data": 2, "model": 1}, {"pod": 2, "data": 1, "model": 2},
                 {"data": 1, "model": 1}, {"data": 1, "model": 2},
                 {"pod": 2, "data": 16, "model": 16}):
        check_supported(adaptive, axes)
    for axis, axes in (("data", {"data": 4, "model": 1}),
                       ("data", {"pod": 2, "data": 2, "model": 1}),
                       ("data", {"pod": 2, "data": 16, "model": 16}),
                       ("pod", {"pod": 2, "data": 2, "model": 1}),
                       ("model", {"data": 1, "model": 2}),
                       ("model", {"data": 2, "model": 2})):
        for ode in (R.ADAPTIVE, R.MALI):
            check_supported(R.qwen_cfg(dict(ode, batch_axis=axis)), axes)
    # 3 blocks of the batch against 2 ranks' rows: block 1 straddles
    # them (under fixed steps this 'dp' config splits its rows over
    # 'model' too, 6 blocks of which the fleet's 3 are whole)
    straddling = {"data": 2, "model": 3}
    with pytest.raises(NotImplementedError, match="item 12b"):
        check_supported(R.qwen_cfg(dict(R.ADAPTIVE, batch_axis="model")),
                        straddling)
    check_supported(R.qwen_cfg(dict(R.MALI, batch_axis="model")),
                    straddling)
    with pytest.raises(NotImplementedError, match="item 12b"):
        check_supported(dataclasses.replace(R.qwen_cfg(dict(
            R.MALI, batch_axis="model")), sharding="tp"), straddling)
    with pytest.raises(ValueError, match="expert"):
        check_supported(cfg, {"data": 2, "expert": 2})


def test_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --device cpu``: gloo, ZeRO-1 over the two
    ranks, only rank 0 printing; its losses those of the one-rank CLI."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    args = ["-m", "repro_torch.launch.train", "--steps", "3", "--device",
            "cpu"]
    runs, logs = {}, {}
    for name, pre in (("two", ["-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", "2"]), ("one", [])):
        res = subprocess.run([sys.executable, *pre, *args], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=170)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        assert res.stdout.count("final_step=3") == 1
        runs[name] = [json.loads(line)["loss"] for line in
                      res.stdout.splitlines() if line.startswith("{")]
        logs[name] = res.stderr
    assert logs["two"].count("backend gloo") == 2
    assert "backend" not in logs["one"]
    assert len(runs["two"]) == 3
    np.testing.assert_allclose(runs["two"], runs["one"], rtol=RTOL)
