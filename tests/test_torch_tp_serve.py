"""LM serving on the JAX package's meshes (batch over the data axes,
tensor parallelism over 'model', FSDP parameter shards over 'data', the
KV sequence split over 'data' at batch 1) over 2 and 4 gloo ranks on the
CPU, against the JAX package's unsharded serve.

The ranks are subprocesses (``tests/torch_tp_serve_rank.py``)
rendezvousing through a ``FileStore``, one spawn per world size: (1, 2)
and (2, 1) on two ranks; (2, 2), (1, 4) and (pod 2, data 1, model 2) on
four. A case ``model:strategy:mesh:batch`` serves a smoke config under
its own strategy ('fsdp_tp' for deepseek-moe, granite, jamba, grok and
internvl2; 'dp' for qwen3 and the xLSTM) or under 'tp' (the smoke
configs' own): a prompt of ``PROMPT`` tokens, then ``N_DECODE``
teacher-forced decode steps, through ``prefill`` and ``decode_step``
under ``with mesh:``. GSPMD computes the unsharded numbers, so the oracle
is the JAX package's ``prefill``/``decode_step`` jitted without a mesh
on the same numpy weights. Checked:

* the logits of prefill and of every decode step within rtol 1e-5 (max
  |port - jax| / max |jax|; jamba and the xLSTM, which amplify rounding,
  within 3x the JAX package's own noise floor where that is larger: its
  change with the weights moved by one float32 rounding), equal on every
  rank;
* each rank's caches after prefill and after the last step against the
  rule's slice of the JAX caches (``cache_shardings``) at the same bar;
* a rank's parameter and cache bytes what ``shard_bytes`` reckons from
  ``param_shardings`` and ``cache_shardings``, to the byte; the shards
  drawn leaf by leaf (``init_lm(..., cut=plan.cut)``) equal to those cut
  from the whole draw;
* the ALF states bit-equal on the ranks that compute the same rows (a
  'model' group);
* FSDP gathers each leaf split over 'data' once a layer a step, and
  nothing where no leaf is; the collectives where the layout needs them;
* the refusals: the rule's duplicate-axis specs (a pure-DP batch over
  'model' beside a cache split over 'model') raise ``ValueError`` as the
  JAX package's ``NamedSharding`` does; the xLSTM's LSTM caches split over
  'model' raise ``NotImplementedError`` naming ROADMAP item 15; a decode
  graph over gloo ranks raises; ``--production-mesh`` reaches
  ``make_production_mesh``'s error, and ``--mode ode --production-mesh``
  stays refused.
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
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models.lm import init_serve_state as jax_init_serve_state
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import serve as tserve

import torch_tp_serve_rank as R
from test_torch_train_lm import np_weights
from test_torch_train_moe_lm import FLOOR_FACTOR, perturbed
from test_torch_train_optim import _to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# the models held to 3x the JAX package's noise floor where it is larger
# than RTOL: the smoke Jamba amplifies rounding ~100x and the smoke xLSTM
# LM ~50x (tests/test_torch_ssm_serve.py, tests/test_torch_xlstm.py)
FLOOR_MODELS = {"jamba", "xlstm"}
CASES = {2: ["deepseek:own:2x1:4", "deepseek:tp:1x2:4", "granite:own:1x2:4",
             "granite:tp:2x1:1", "jamba:own:1x2:4", "qwen3:own:1x2:1",
             "qwen3:own:2x1:1", "internvl2:tp:1x2:4", "xlstm:own:2x1:4",
             "refusals:1x2:2x1"],
         4: ["deepseek:own:2x2:4", "granite:own:2x2:4", "granite:own:2x2:1",
             "jamba:own:2x2:1", "grok:own:1x4:4", "qwen3:own:2x2:2",
             "qwen3:tp:1x4:1", "internvl2:own:2x1x2:1",
             "deepseek:own:2x1x2:4", "refusals:2x2:1x4:2x1x2"]}
SERVE_CASES = [(w, c) for w, cs in CASES.items() for c in cs
               if not c.startswith("refusals")]


def _jax_cfg(model):
    arch, changes = R.MODELS[model]
    return dataclasses.replace(
        jax_smoke_config(arch, JaxOdeSettings(**R.MALI)), **changes)


@functools.lru_cache(maxsize=None)
def _weights(model):
    return np_weights(_jax_cfg(model), seed=3)


@functools.lru_cache(maxsize=None)
def _jitted(model):
    jcfg = _jax_cfg(model)
    return (jcfg, jax.jit(jax_make_prefill_step(jcfg)),
            jax.jit(jax_make_decode_step(jcfg)))


def _flat_cache(cache):
    return {"/".join(tsh._path_names(path)): torch.tensor(
        np.asarray(leaf, np.float32))
        for path, leaf in jax.tree_util.tree_leaves_with_path(cache)}


@functools.lru_cache(maxsize=None)
def _jax_serve(model, batch, moved=False):
    """The JAX package's prefill + teacher-forced decode steps: (logits
    per step, the cache after prefill, after the last step), flattened by
    key path. ``moved``: from weights moved by one float32 rounding."""
    jcfg, pre, dec = _jitted(model)
    w = _weights(model)
    if moved:
        w = perturbed(w)
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    x = R.inputs(jcfg, batch)
    key = "embeds" if jcfg.input_mode == "embeds" else "tokens"
    state = jax_init_serve_state(jcfg, batch, R.PROMPT + R.N_DECODE)
    jl, js = pre(jw, {key: jnp.asarray(x[:, :R.PROMPT])}, state)
    logits, prefill_cache = [np.asarray(jl)], _flat_cache(js.cache)
    for i in range(R.N_DECODE):
        jl, js = dec(jw, jnp.asarray(x[:, R.PROMPT + i:R.PROMPT + i + 1]),
                     js)
        logits.append(np.asarray(jl))
    return logits, prefill_cache, _flat_cache(js.cache)


def _spawn(world: int, tmp: Path, out: Path):
    """Run the world's cases; returns rank 0's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    store = tmp / f"store{world}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_serve_rank.py"),
         str(r), str(world), str(store), str(out), ",".join(CASES[world])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
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
    world's cases, the weights and the JAX caches saved for the ranks
    first."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    runs = {}

    def get(world):
        if world not in runs:
            out = tmp / f"out{world}"
            out.mkdir()
            for case in CASES[world]:
                if case.startswith("refusals"):
                    continue
                model, _, _, batch = case.split(":")
                batch = int(batch)
                if not (tmp / f"weights_{model}.pt").exists():
                    torch.save(_to_torch(_weights(model), torch.float32),
                               tmp / f"weights_{model}.pt")
                kinds = [("jax", False)] + (
                    [("moved", True)] if model in FLOOR_MODELS else [])
                for kind, moved in kinds:
                    _, pre, last = _jax_serve(model, batch, moved)
                    for stage, cache in (("prefill", pre), ("last", last)):
                        torch.save(cache, tmp / f"{kind}_cache_{model}_"
                                   f"{batch}_{stage}.pt")
            runs[world] = (out, _spawn(world, tmp, out))
        return runs[world]

    return get


def _rel(port, want) -> float:
    p = np.asarray(port.numpy(), np.float64)
    w = np.asarray(want, np.float64)
    assert p.shape == w.shape, (p.shape, w.shape)
    return float(np.abs(p - w).max() / max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("world,case", SERVE_CASES,
                         ids=[c for _, c in SERVE_CASES])
def test_serve_matches_jax(spawned, world, case):
    model, strategy, mesh, batch = case.split(":")
    batch = int(batch)
    out, results = spawned(world)
    got = results[case]
    floor = model in FLOOR_MODELS
    want = _jax_serve(model, batch)[0]
    moved = _jax_serve(model, batch, True)[0] if floor else None
    logits = torch.load(out / f"logits_{model}_{strategy}_{mesh}_"
                        f"{batch}.pt")
    assert len(logits) == len(want) == R.N_DECODE + 1
    for step, (g, w) in enumerate(zip(logits, want)):
        bar = RTOL
        if floor:
            bar = max(bar, FLOOR_FACTOR * _rel(torch.tensor(moved[step]), w))
        assert g.dtype == torch.float32
        assert _rel(g, w) <= bar, (case, step, _rel(g, w), bar)
    for stage in ("cache_prefill", "cache_last"):
        assert got[stage], case
        for name, (err, moved_err) in got[stage].items():
            bar = RTOL if moved_err is None else max(
                RTOL, FLOOR_FACTOR * moved_err)
            assert err <= bar, (case, stage, name, err, bar)
    assert got["pos"] == R.PROMPT + R.N_DECODE
    assert got["logits_equal"] and all(got["states_equal"]), case
    assert got["init_cut_equal"], case
    assert got["param_bytes"] == got["rule_param_bytes"], case
    assert got["cache_bytes"] == got["rule_cache_bytes"], case
    shape, axes = R.parse_mesh(mesh)
    sizes = dict(zip(axes, shape))
    cfg = R.model_cfg(model, strategy)
    for counts in got["counts"]:
        gathers = counts["fsdp_gathers"]
        if cfg.sharding == "fsdp_tp" and sizes["data"] > 1:
            assert gathers["forward"] == got["gather_instances"] > 0, case
        else:
            assert gathers == {"forward": 0, "backward": 0}, case
        assert gathers["backward"] == 0
        if got["model_split"] or got["cache_model_split"]:
            assert counts["all_reduce@model"]["calls"] > 0, case
        if got["row_axes"]:
            assert counts["all_gather"]["calls"] > 0, case
        assert counts["host_staged"]["calls"] == 0      # CPU tensors
    if batch == 1 and sizes["data"] > 1 and "pod" not in sizes:
        # the KV sequence split over 'data': each decode step combines
        # the ranks' partial attention over 'data'
        assert not got["row_axes"]
        for counts in got["counts"][1:]:
            assert counts["all_gather@data"]["calls"] > 0, case
        assert got["cache_bytes"] < got["whole_cache_bytes"], case
    if cfg.sharding == "fsdp_tp" and sizes["data"] * sizes["model"] == 4:
        # the big leaves are cut four ways
        assert got["param_bytes"] < 0.4 * got["whole_param_bytes"], case


def test_refusals(spawned):
    got = {**spawned(2)[1]["refusals:1x2:2x1"],
           **spawned(4)[1]["refusals:2x2:1x4:2x1x2"]}
    for mesh in ("1x2", "2x1", "2x2", "1x4", "2x1x2"):
        shape, axes = R.parse_mesh(mesh)
        model_axis = dict(zip(axes, shape))["model"]
        # a 'dp' batch over 'model' beside a cache split over 'model'
        for batch, raises in ((4, model_axis > 1),
                              (2, model_axis > 1 and np.prod(shape) == 2)):
            res = got[f"qwen3:own:{mesh}:{batch}"]
            if raises:
                assert res[0] == "ValueError", (mesh, batch, res)
                assert "maps mesh axes ['model']" in res[1]
            else:
                assert res is None, (mesh, batch, res)
        # the LSTM caches split over 'model'
        for strategy, batch in (("tp", 4), ("tp", 1), ("own", 4)):
            res = got[f"xlstm:{strategy}:{mesh}:{batch}"]
            if model_axis == 1:
                assert res is None, (mesh, strategy, res)
            elif strategy == "own":
                # the rule's duplicate spec comes first
                assert res[0] == "ValueError", res
            else:
                assert res[0] == "NotImplementedError", res
                assert "ROADMAP queue 1 item 15" in res[1]
        res = got[f"capture:{mesh}"]
        assert res[0] == "NotImplementedError", res
        assert "stages its collectives through the host" in res[1]


def test_production_mesh_reaches_make_production_mesh():
    with pytest.raises(ValueError, match="needs a world of 256 ranks, got 1"):
        tserve.main(["--production-mesh", "--device", "cpu"])
    with pytest.raises(ValueError, match="places nothing on the mesh"):
        tserve.main(["--mode", "ode", "--production-mesh", "--device",
                     "cpu", "--requests", "2"])


def test_decode_graph_needs_a_card():
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_serve_state
    cfg = smoke_config("granite-20b")
    step = tserve.make_decode_step(cfg, capture=True)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        step({}, torch.zeros((1, 1), dtype=torch.int32),
             init_serve_state(cfg, 1, 4, "cpu"))
