"""Training on two- and three-dimensional meshes (tensor parallelism over
'model', FSDP parameter shards over 'data', 'pod' data parallelism) over
2 and 4 gloo ranks on the CPU, against the JAX package.

The ranks are subprocesses (``tests/torch_tp_rank.py``) rendezvousing
through a ``FileStore``, one spawn per world size: (1, 2) and (2, 1) on
two ranks; (2, 2), (1, 4) and (pod 2, data 1, model 2) on four. Each
case trains a smoke config under its own strategy or under 'tp' through
``train_step(..., zero1=True)`` under a mesh made with
``init_device_mesh``: deepseek-moe with capacity drops, granite (MQA:
wk/wv whole on every rank), jamba (Mamba, MoE and attention, one
period), grok with six experts (at model 4 each expert's d_ff splits),
qwen3 under 'dp' (the batch over 'model'), qwen3 with adaptive MALI,
gemma2 under 'tp' (its tied head split on D: partial logits summed), and
granite through the int8 error-feedback loop.
GSPMD computes the unsharded step's numbers, so the oracle is
``jitted_train_step`` without a mesh on the global batch. Over three
chained steps:

* loss and grad norm within rtol 1e-5 (adaptive control:
  ``ADAPTIVE_TOL``); for jamba, deepseek-moe with drops and qwen3 under
  adaptive control, within 3x the JAX package's own noise floor (the largest change of its chain
  with the weights moved by one float32 rounding at every step, over 16
  draws) where that is larger; lr within one float32 ulp, counters
  equal;
* the ODE states bit-equal on the ranks that solve the same rows, and
  every parameter block bit-equal on the ranks that hold it;
* each rank's shards the rule's slices of the JAX chain's final
  leaves, and of the port's one-rank chain's, in norm within 1e-5 or 3x
  the JAX package's floor for that leaf;
* a rank's resident parameter and optimizer bytes what the rule's shards
  reckon, to the byte; FSDP gathers each leaf once a layer in the
  forward and at most once in the backward.

The Trainer on (2, 1) resumes a deepseek-moe run from a failure bit for
bit, and checkpoints move between (2, 2), (2, 1) and one rank with equal
states. ``cache_shardings`` equals the JAX package's.
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

from repro.configs import ARCHS
from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import make_batch as jax_make_batch
from repro.distributed import sharding as jsh
from repro.launch.specs import input_specs as jax_input_specs
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train.loop import jitted_train_step
from repro_torch import tree_util
from repro_torch.configs import SHAPE_CELLS, cell_applicable
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.specs import input_specs
from repro_torch.optim import OptimizerConfig, init_ef_state, init_opt_state
from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
from repro_torch.train import train_step

import torch_tp_rank as R
from test_torch_dp_rules import MESHES, _configs, _jax_specs, _meshes
from test_torch_dp_train import ADAPTIVE_TOL
from test_torch_train_lm import np_weights
from test_torch_train_moe_lm import FLOOR_FACTOR, perturbed
from test_torch_train_optim import _to_jax, _to_torch, assert_ulp_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# the shards after three AdamW steps against the one-rank run's: the
# layers sum in another order, nothing more (or 3x the JAX package's own
# floor for that leaf, where larger)
SHARD_RTOL = 1e-5
# the weight perturbations whose largest effect is the JAX package's floor
FLOOR_SEEDS = range(1, 17)
# the models whose loss and grad norm are held to that floor where it is
# larger than their base bar (the others: the base bar). jamba and
# deepseek-moe with drops amplify rounding (step-1 grad-norm floors
# 1.2e-3 and 7.7e-5); under adaptive control one float32 rounding of the
# weights moves qwen3's chain by 3.2e-5 at step 1, past ADAPTIVE_TOL,
# and the port's one-rank chain is 3.5e-5 from the JAX one there
FLOOR_MODELS = {"jamba", "deepseek", "qwen3a"}
CASES = {2: ["deepseek:own:1x2", "granite:own:1x2", "jamba:own:1x2",
             "qwen3:own:1x2", "qwen3a:own:1x2", "gemma2:tp:1x2",
             "deepseek:own:2x1", "granite:tp:2x1", "trainer"],
         4: ["deepseek:own:2x2", "granite:own:2x2", "jamba:own:2x2",
             "deepseek:tp:2x2", "granitec:own:2x2", "grok6:own:1x4",
             "grok6:tp:1x4",
             "jamba:tp:1x4", "deepseek:own:2x1x2", "granite:tp:2x1x2",
             "checkpoints"]}
STEP_CASES = [(w, c) for w, cs in CASES.items() for c in cs if ":" in c]


def _jax_cfg(model):
    arch, changes, ode = R.MODELS[model]
    return dataclasses.replace(jax_smoke_config(arch, JaxOdeSettings(**ode)),
                               **changes)


@functools.lru_cache(maxsize=None)
def _weights(model):
    return np_weights(_jax_cfg(model), seed=3)


def _jax_chain(model, seed=None):
    """The JAX package's chain from the test's weights: each step's
    metrics, and the final parameters by key path. With ``seed``, each
    step starts from weights moved by one float32 rounding (relative
    1e-7, a fresh draw each step)."""
    jcfg = _jax_cfg(model)
    oc = jopt.OptimizerConfig(warmup_steps=1, total_steps=R.N_STEPS)
    p = _to_jax(_weights(model), jnp.float32)
    s = jopt.init_opt_state(oc, p)
    compress = model in R.COMPRESSED
    ef = jcomp.init_ef_state(p) if compress else None
    rows = []
    for step in range(R.N_STEPS):
        if seed is not None:
            p = _to_jax(perturbed(jax.tree_util.tree_map(np.asarray, p),
                                  seed=1000 * seed + step), jnp.float32)
        b = jax_make_batch(jcfg, JaxDataConfig(**R.BATCH), step)
        p, s, ef, m = jitted_train_step(
            p, s, ef, {k: jnp.asarray(v) for k, v in b.items()},
            cfg=jcfg, opt_cfg=oc, compress=compress)
        rows.append({k: float(v) for k, v in m.items()})
    return rows, jax.tree_util.tree_map(np.asarray, p)


def _by_path(tree):
    return {"/".join(tsh._path_names(path)): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _oracle(model):
    """(the JAX chain's metrics, each metric's bar, each leaf's bar for
    the shards, in norm: ||shard - slice|| / ||slice||, and the JAX
    chain's final parameters). A bar is rtol 1e-5 (a metric under
    adaptive control: ``ADAPTIVE_TOL``; a leaf: ``SHARD_RTOL``), or 3x
    the JAX package's own noise floor where that is larger: the largest
    change of the JAX chain's result over ``FLOOR_SEEDS`` runs whose
    weights are moved by one float32 rounding at every step (as a
    sharded step rounds its sums in another order at every step). A
    metric's bar takes the floor only for ``FLOOR_MODELS``: the models
    that amplify rounding (jamba, and deepseek-moe with capacity drops),
    and adaptive control, whose accepted steps move with the rounding:
    AdamW's first step moves each weight by the sign of its gradient, so
    a gradient near 0 whose rounding differs parts two runs by up to 2
    lr, and the smoke Jamba's three-step chain is chaotic (over 16 draws
    its step-2 grad norm moves by up to 4%, heavy-tailed)."""
    want, final = _jax_chain(model)
    final_by_path = _by_path(final)
    base = ADAPTIVE_TOL["rtol"] if model == "qwen3a" else RTOL
    bars = [{k: base for k in ("loss", "grad_norm")} for _ in want]
    leaf_bars = {path: SHARD_RTOL for path in final_by_path}
    for seed in FLOOR_SEEDS:
        moved, moved_final = _jax_chain(model, seed)
        if model in FLOOR_MODELS:
            for bar, w, m in zip(bars, want, moved):
                for k in bar:
                    bar[k] = max(bar[k], FLOOR_FACTOR
                                 * abs(m[k] - w[k]) / abs(w[k]))
        for path, a in _by_path(moved_final).items():
            w = final_by_path[path]
            leaf_bars[path] = max(leaf_bars[path], FLOOR_FACTOR * float(
                np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30)))
    return want, bars, leaf_bars, final


def _one_rank(model, path: Path):
    """The port's one-rank chain; its final parameters saved whole."""
    cfg = R.model_cfg(model)
    params = _to_torch(_weights(model), torch.float32)
    oc = OptimizerConfig(warmup_steps=1, total_steps=R.N_STEPS)
    s = init_opt_state(oc, params)
    compress = model in R.COMPRESSED
    ef = init_ef_state(params) if compress else None
    for step in range(R.N_STEPS):
        params, s, ef, _ = train_step(params, s, ef, R.batch(cfg, step),
                                      cfg=cfg, opt_cfg=oc, compress=compress)
    torch.save(params, path)


def _trainer(steps, **kw):
    t = Trainer(TrainerConfig(**{**R.TRAINER, "steps": steps, **kw}),
                emitter=MemoryEmitter(), model_cfg=R.model_cfg("deepseek"))
    assert t.train() == steps
    return t


def _spawn(world: int, tmp: Path, out: Path):
    """Run the world's cases; returns rank 0's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    store = tmp / f"store{world}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_rank.py"), str(r),
         str(world), str(store), str(out), ",".join(CASES[world])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=400))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (so, se)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r}: {so[-2000:]}{se[-3000:]}"
        assert f"RANK_OK {r}" in so
    return json.loads((out / "result.json").read_text())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: (output directory, rank 0's results) of the
    world's cases. The two-rank world runs first: the four-rank one
    restores its checkpoint."""
    tmp = tmp_path_factory.mktemp("tp")
    runs = {}

    def get(world):
        if world == 4:
            get(2)
        if world not in runs:
            out = tmp / f"out{world}"
            out.mkdir()
            for model in sorted({c.split(":")[0] for c in CASES[world]
                                 if ":" in c}):
                if not (tmp / f"weights_{model}.pt").exists():
                    torch.save(_to_torch(_weights(model), torch.float32),
                               tmp / f"weights_{model}.pt")
                    torch.save(_to_torch(_oracle(model)[3], torch.float32),
                               tmp / f"jax_final_{model}.pt")
                    _one_rank(model, tmp / f"final_{model}.pt")
            if world == 2:
                _trainer(R.CKPT_STEPS, ckpt_dir=str(out / "one_rank"))
            else:
                for name in ("one_rank", "two_rank"):
                    os.symlink(tmp / "out2" / name, out / name)
            runs[world] = (out, _spawn(world, tmp, out))
        return runs[world]

    return get


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", STEP_CASES,
                         ids=[c for _, c in STEP_CASES])
def test_steps_match_jitted_train_step(spawned, world, case):
    model, strategy, mesh = case.split(":")
    got = spawned(world)[1][case]
    want, bars, leaf_bars, _ = _oracle(model)
    for step, (g, w, bar) in enumerate(zip(got["metrics"], want, bars)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=bar[key],
                                       err_msg=f"{case} {key} step {step}")
        assert_ulp_close(torch.tensor(g["lr"]), torch.tensor(w["lr"]),
                         "float32", f"{case} lr step {step}")
        for key in ("ode_accepted", "ode_rejected", "ode_fevals"):
            assert g[key] == w[key], (case, key, step)
    assert all(got["states_equal"]) and got["blocks_equal"], case
    # the shards against the JAX chain's final leaves, and against the
    # port's own one-rank chain
    for against in ("shard_err", "shard_err_one_rank"):
        assert set(got[against]) == set(leaf_bars), case
        for path, err in got[against].items():
            assert err <= leaf_bars[path], (case, against, path, err,
                                            leaf_bars[path])
    assert got["param_bytes"] == got["rule_param_bytes"], case
    assert got["opt_bytes"] == got["rule_opt_bytes"], case
    shape, axes = R.parse_mesh(mesh)
    sizes = dict(zip(axes, shape))
    cfg = R.model_cfg(model, strategy)
    tp = cfg.sharding != "dp" and sizes["model"] > 1
    assert got["tensor_parallel"] == tp, case
    assert got["model_group_size"] == (sizes["model"] if tp else 1), case
    for counts in got["counts"]:
        gathers = counts["fsdp_gathers"]
        if cfg.sharding == "fsdp_tp" and sizes["data"] > 1:
            # each split leaf once a layer forward, at most once backward
            assert got["n_fsdp"] > 0
            assert gathers["forward"] == got["gather_instances"], case
            assert 0 < gathers["backward"] <= got["gather_instances"], case
        else:
            assert gathers == {"forward": 0, "backward": 0}, case
        if tp:
            assert counts["all_reduce@model"]["calls"] > 0, case
        assert counts["host_staged"]["calls"] == 0      # CPU tensors
    if cfg.sharding == "fsdp_tp" and sizes["data"] * sizes["model"] == 4:
        # the big leaves are cut four ways
        assert got["param_bytes"] < 0.4 * got["whole_param_bytes"], case


# ---------------------------------------------------------------------------
# The Trainer and checkpoints across layouts
# ---------------------------------------------------------------------------

def _states_equal(a, b):
    for key in ("params", "opt", "ef"):
        assert len(a[key]) == len(b[key]), key
        for x, y in zip(a[key], b[key]):
            assert x.dtype == y.dtype and torch.equal(x, y), key


def _state_of(t):
    return {k: tree_util.tree_leaves(v) for k, v in
            (("params", t.params), ("opt", t.opt), ("ef", t.ef))}


def test_trainer_resume_and_checkpoints_across_layouts(spawned):
    out2, res2 = spawned(2)
    got = res2["trainer"]
    # FSDP through the Trainer on (2, 1): a failure resumed bit for bit
    assert got["fired"] == [3] and got["faulty"] == got["clean"]
    assert got["n_fsdp"] > 0
    assert got["param_bytes"] < 0.6 * got["whole_param_bytes"]
    one = _trainer(R.TRAINER["steps"])
    np.testing.assert_allclose(got["clean"], one.loss_trace(), rtol=RTOL)
    # a one-rank checkpoint restored on (2, 1): the whole state the
    # one-rank run's
    assert got["restored_steps"] == []
    written = _trainer(R.CKPT_STEPS)
    _states_equal(torch.load(out2 / "trainer_restored_state.pt"),
                  _state_of(written.state))
    # a (2, 1) checkpoint restored by one rank
    back = _trainer(R.CKPT_STEPS, ckpt_dir=str(out2 / "two_rank"))
    assert back.records == {}
    _states_equal(torch.load(out2 / "trainer_written_state.pt"),
                  _state_of(back.state))
    # on (2, 2): the one-rank and the (2, 1) checkpoints restored into the
    # rule's shards and gathered whole again, equal to what was written
    out4, res4 = spawned(4)
    grid = res4["checkpoints"]
    assert grid["one_rank"] == grid["two_rank"] == R.CKPT_STEPS
    _states_equal(torch.load(out4 / "grid_one_rank_state.pt"),
                  _state_of(written.state))
    _states_equal(torch.load(out4 / "grid_two_rank_state.pt"),
                  torch.load(out2 / "trainer_written_state.pt"))
    # a (2, 2) checkpoint restored by one rank
    grid_back = _trainer(R.CKPT_STEPS, ckpt_dir=str(out4 / "grid"))
    assert grid_back.records == {}
    _states_equal(torch.load(out4 / "grid_one_rank_state.pt"),
                  _state_of(grid_back.state))


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_match_jax(arch, mesh):
    """The serve caches' specs, for every applicable decode cell of the
    config at full width (the KV, Mamba and LSTM caches), on the five
    meshes."""
    jcfg, tcfg = _configs(arch, "full")
    jmesh, tmesh = _meshes(mesh)
    cells = [c for c in SHAPE_CELLS if c.kind == "decode"
             and cell_applicable(tcfg, c)]
    assert cells
    for cell in cells:
        jstate = jax_input_specs(jcfg, cell)["state"]
        tstate = input_specs(tcfg, cell)["state"]
        want = _jax_specs(jsh.cache_shardings(
            jcfg, jmesh, jstate.cache, cell.global_batch))
        got = {tsh._path_names(path): tuple(spec) for path, spec in
               torch.utils._pytree.tree_flatten_with_path(
                   tsh.cache_shardings(tcfg, tmesh, tstate.cache,
                                       cell.global_batch))[0]}
        assert got == want, (arch, mesh, cell.name)


STEP0_MESHES = {"2x2": {"data": 2, "model": 2}, "1x2": {"data": 1, "model": 2}}


@pytest.mark.parametrize("batch", [4, 2, 1])
@pytest.mark.parametrize("mesh", list(STEP0_MESHES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b", "xlstm-125m"])
def test_cache_shardings_raise_where_jax_raises(arch, mesh, batch):
    """A pure-DP config whose batch divides data x model puts the batch on
    ('data', 'model') and 'model' again on the heads or d_head: the JAX
    package's ``NamedSharding`` refuses the spec, and the port's
    ``cache_shardings`` raises ``ValueError`` in the same cases (batch 4
    on both meshes, batch 2 on {data 1, model 2}); elsewhere the two give
    the same specs."""
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jax_get_config
    from repro.models.lm import init_serve_state as jax_init_serve_state
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import META
    from repro_torch.models import init_serve_state
    sizes = STEP0_MESHES[mesh]
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jstate = jax.eval_shape(lambda: jax_init_serve_state(jcfg, batch, 64))
    tstate = init_serve_state(tcfg, batch, 64, META)
    try:
        want = _jax_specs(jsh.cache_shardings(jcfg, jmesh, jstate.cache,
                                              batch))
    except Exception as e:          # jax's DuplicateSpecError
        assert "DuplicateSpec" in type(e).__name__, e
        want = None
    assert (want is None) == (batch == 4 or (batch == 2 and mesh == "1x2"))
    if want is None:
        with pytest.raises(ValueError, match="maps mesh axes"):
            tsh.cache_shardings(tcfg, sizes, tstate.cache, batch)
        return
    got = {tsh._path_names(path): tuple(spec) for path, spec in
           torch.utils._pytree.tree_flatten_with_path(
               tsh.cache_shardings(tcfg, sizes, tstate.cache, batch))[0]}
    assert got == want, (arch, mesh, batch)
