"""``ode_batch_axis`` fleets over gloo CPU ranks against the JAX package:
the residual branches solved as the JAX package's ``Sharded(axis)``
``shard_map``, whose n blocks of each microbatch's rows (n the axis
size, block i rows ``[i·nb/n, (i+1)·nb/n)``) each take a controller of
their own, mapped onto the ranks that hold those rows
(``distributed/data_parallel.py``, ``Fleet``):

* where n divides the ranks' row blocks R a block spans R / n ranks,
  whose error norm is summed over them every trial (one group a block);
* where R divides n each rank solves its n / R blocks one after another,
  its rows never sliced over an axis the layers split.

The ranks are subprocesses (``tests/torch_fleet_rank.py``) rendezvousing
through a ``FileStore``, on meshes made with ``init_device_mesh``:

* the solve: ``solve(..., batching=Sharded(axis))`` of each rank's rows
  against the JAX package's ``Sharded(axis)`` solve of the whole batch on
  4 fake CPU devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``), on (pod 2, data 2)
  over 'data' and 'pod' and on (data 2, model 2) over 'model', MALI and
  Naive: per-row counters exact, end states and gradients within
  ``ADAPTIVE_TOL``; one ``error_norm@data`` reduction a trial where a
  block spans two ranks, none where it is one rank's rows; Naive's
  backward reduces over the block's group (``psum``'s transpose), MALI's
  never. Every mesh gives the fleet the same two blocks, so the JAX
  package's Naive solve is run once, on (pod 2, data 2) over 'data';
* training: one step of qwen3's smoke config under 'tp' against the JAX
  package's per-block composition (each block's ``value_and_grad`` of
  ``lm_loss_and_stats`` alone, averaged: the blocks hold equal token
  counts): loss at rtol 1e-5, grad norm at ``ADAPTIVE_TOL``, per-row
  counters equal to their block's exactly, parameters bit-equal on the
  ranks, one ``error_norm`` reduction a trial of each block where it
  spans ranks. F7: on (data 1, model 2) with ``ode_batch_axis="model"``
  the rows were once sliced over the 'model' ranks that split the
  layers, their Megatron sums adding partial products of different
  rows; both fixed and adaptive steps are held here;
* F8: deepseek-moe's smoke config with capacity drops, fixed steps,
  ``ode_batch_axis="data"`` on (pod 2, data 2): each rank's kept masks
  equal its part of a one-rank forward on its fleet block alone (the
  MoE ranks the block's tokens, which span the two data ranks of a
  pod), and differ from a forward on the rank's rows alone; one step
  against the port's own per-block composition.
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
from repro_torch import tree_util
from repro_torch.models import init_lm, lm_loss
from repro_torch.models.moe import recording_routes
from repro_torch.train import loss_and_grads

import torch_fleet_rank as R
from test_torch_train_lm import np_weights
from test_torch_train_optim import _to_jax, _to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# adaptive f32 solves against the JAX package (tests/test_torch_dp_train.py)
ADAPTIVE_TOL = dict(rtol=2e-5, atol=2e-6)
SOLVE_TOL = 2e-5         # max |got - want| / max |want|
# the JAX oracle's cases: mesh:axis:method
JAX_SOLVES = [f"{c}:mali" for c in R.SOLVE_CASES] + ["2x2x1:data:naive"]

JAX_SOLVE = """
import sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4
sys.path.insert(0, {tests!r})
import torch_fleet_rank as R
from repro.core import (solve, MALI, Naive, AdaptiveController, ALF,
                        Sharded)

def f(p, z, t):
    return jnp.tanh(z @ p["w"] + p["b"]) - z + p["c"] * jnp.sin(3.0 * t)

p_np, z_np, w_np = R.inputs("float32")
params = {{k: jnp.asarray(v) for k, v in p_np.items()}}
z0, w = jnp.asarray(z_np), jnp.asarray(w_np)
for case in {cases!r}:
    mesh_name, axis, method = case.split(":")
    shape, names = R.mesh_of(mesh_name)
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape), names)
    with mesh:
        def loss(p, z):
            sol = solve(f, p, z, 0.0, R.T1, solver=ALF(eta=R.ETA),
                        controller=AdaptiveController(R.RTOL, R.ATOL,
                                                      R.MAX_STEPS),
                        gradient=MALI() if method == "mali" else Naive(),
                        batching=Sharded(axis=axis))
            return jnp.sum(sol.ys * w), sol
        (_, sol), (gp, gz) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, z0)
    per = sol.stats.per_sample
    np.savez({out!r} + "/" + case.replace(":", "_") + ".npz",
             ys=np.asarray(sol.ys), g_z0=np.asarray(gz),
             per_sample=np.stack([np.asarray(per.n_accepted),
                                  np.asarray(per.n_rejected),
                                  np.asarray(per.n_fevals)]),
             **{{f"g_{{k}}": np.asarray(v) for k, v in gp.items()}})
print("JAX_OK")
"""


def _jax_cfg(ode, **extra):
    return dataclasses.replace(jax_smoke_config(
        "qwen3-1.7b", JaxOdeSettings(**ode)), **extra)


@functools.lru_cache(maxsize=None)
def _weights():
    return np_weights(_jax_cfg(R.MALI), seed=3)


def _spawn(world: int, tmp: Path):
    """Run the world's scenarios; returns (output directory, rank 0's
    results)."""
    out = tmp / "out"
    out.mkdir()
    torch.save(_to_torch(_weights(), torch.float32), tmp / "weights.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_fleet_rank.py"), str(r),
         str(world), str(tmp / "store"), str(out),
         ",".join(R.WORLDS[world])],
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
    return out, json.loads((out / "result.json").read_text())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: (output directory, rank 0's results) of one run
    of the world's scenarios, shared by the module's tests."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = _spawn(world,
                                 tmp_path_factory.mktemp(f"fleet{world}"))
        return runs[world]

    return get


@pytest.fixture(scope="module")
def jax_solves(tmp_path_factory):
    """The JAX package's Sharded solves on 4 fake CPU devices, by case."""
    out = tmp_path_factory.mktemp("jax_fleet")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    code = JAX_SOLVE.format(tests=str(ROOT / "tests"), cases=JAX_SOLVES,
                            out=str(out))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(out))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "JAX_OK" in r.stdout
    return {case: dict(np.load(out / (case.replace(":", "_") + ".npz")))
            for case in JAX_SOLVES}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# The block map (no process group: one rank's view of a stand-in mesh)
# ---------------------------------------------------------------------------

def test_fleet_blocks_on_stand_in_meshes():
    """Each rank's part of a fleet: the blocks in its rows, and the group
    of the ranks holding its block (its size, this rank's place in it,
    the axes its ranks differ on); straddling sizes refused."""
    from repro_torch.distributed.data_parallel import fleet_of, mesh_group
    from repro_torch.distributed.stand_in import StandInMesh

    def part(axes, coord, axis):
        mesh = StandInMesh(axes, coordinate=coord)
        f = fleet_of(mesh, axis, mesh_group(mesh, ("pod", "data")))
        g = f.group
        return (f.n, f.ranks, f.parts,
                None if g is None else (g.size, g.rank, g.axis))

    multi = {"pod": 2, "data": 16, "model": 16}
    # 'data' on the multi-pod mesh: 16 blocks of 32 row blocks, each 2
    # of a pod's 16 data ranks
    assert part(multi, [1, 5, 3], "data") == (16, 32, 1, (2, 1, "data"))
    assert part(multi, [1, 5, 3], "pod") == (2, 32, 1, (16, 5, "data"))
    assert part(multi, [0, 4, 0], "model") == (16, 32, 1, (2, 0, "data"))
    single = {"data": 16, "model": 16}
    assert part(single, [7, 2], "model") == (16, 16, 1, None)
    assert part({"data": 1, "model": 4}, [0, 3], "model") == (4, 1, 4, None)
    # blocks of 2 over (pod 2, data 3): the middle one spans both pods
    odd = {"pod": 2, "data": 3, "model": 1}
    assert part(odd, [0, 1, 0], "data") == (3, 6, 1, (2, 1, "data"))
    assert part(odd, [0, 2, 0], "data") == (3, 6, 1, (2, 0, "pod+data"))
    assert part(odd, [1, 0, 0], "data") == (3, 6, 1, (2, 1, "pod+data"))
    with pytest.raises(NotImplementedError, match="item 12b"):
        part({"data": 2, "model": 3}, [0, 0], "model")
    with pytest.raises(ValueError, match="axes"):
        part(single, [0, 0], "pod")


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", R.METHODS)
@pytest.mark.parametrize("case", R.SOLVE_CASES)
def test_sharded_solve_matches_jax_fleet(spawned, jax_solves, case, method):
    out, res = spawned(4)
    meta = res["solve"][f"{case}_{method}"]
    mesh_name, axis = case.split(":")
    got = dict(np.load(out / f"solve_{mesh_name}_{axis}_{method}.npz"))
    want = jax_solves.get(f"{case}:{method}",
                          jax_solves["2x2x1:data:naive"])
    # every row's counters are its block's, exactly
    np.testing.assert_array_equal(got["per_sample"], want["per_sample"])
    blocks = want["per_sample"][:, ::R.B // 2]
    assert not np.array_equal(blocks[:, 0], blocks[:, 1])   # two fleets
    assert meta["ys_same"]
    for name in ("ys", "g_z0", "g_b", "g_c", "g_w"):
        assert _rel(got[name], want[name]) <= SOLVE_TOL, (
            case, method, name, _rel(got[name], want[name]))
    counts, trials = meta["counts"], meta["trials"]
    assert meta["parts"] == 1
    if mesh_name == "2x2x1":
        # a block is the two data ranks of a pod: one reduction a trial
        assert (meta["group"], meta["group_size"]) == ("data", 2)
        assert counts["error_norm"] == counts["error_norm@data"] \
            == trials > 0
        vjp = counts.get("error_norm_vjp", 0)
        if method == "mali":
            assert vjp == 0
        else:
            assert 0 < vjp <= trials
            assert counts["error_norm_vjp@data"] == vjp
    else:
        # a block is one data rank's rows; its 'model' replica solves the
        # same rows and reduces nothing
        assert meta["group"] is None and counts == {}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _chunks(name):
    """(the fleet's blocks in batch order, microbatch-major: each block of
    each microbatch; the rows of one)."""
    mesh_name, axis, ode, nb, mb = R.TRAIN_CASES[name]
    n = dict(zip(R.mesh_of(mesh_name)[1], R.mesh_of(mesh_name)[0]))[axis]
    rows = nb // (mb * n)
    return [slice(c * rows, (c + 1) * rows) for c in range(mb * n)], rows


@functools.lru_cache(maxsize=None)
def _jax_blocks(name):
    """The JAX package's per-block composition of one case: (mean loss,
    global norm of the mean gradient, each block's (accepted, rejected,
    f-evals), the rows of a block)."""
    mesh_name, axis, ode, nb, mb = R.TRAIN_CASES[name]
    jcfg = _jax_cfg(ode)
    vg = jax.jit(jax.value_and_grad(jax_loss_and_stats, has_aux=True),
                 static_argnums=1)
    p = _to_jax(_weights(), jnp.float32)
    b = jax_make_batch(jcfg, JaxDataConfig(**{**R.BATCH, "global_batch": nb}),
                       0)
    blocks, rows = _chunks(name)
    losses, grads, stats = [], [], []
    for cs in blocks:
        (loss, st), g = vg(p, jcfg, {k: jnp.asarray(v[cs])
                                     for k, v in b.items()})
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_leaves(g))
        stats.append([int(st.n_accepted), int(st.n_rejected),
                      int(st.n_fevals)])
    return float(np.mean(losses)), _norm(grads), stats, rows


def _port_blocks(name):
    """The port's own per-block composition: (mean loss, global norm of
    the mean gradient)."""
    mesh_name, axis, ode, nb, mb = R.TRAIN_CASES[name]
    cfg = R.qwen_cfg(ode, None)
    full = R.batch(cfg, global_batch=nb)
    params = _to_torch(_weights(), torch.float32)
    losses, grads = [], []
    for cs in _chunks(name)[0]:
        loss, _, g = loss_and_grads(params, {k: v[cs]
                                             for k, v in full.items()},
                                    cfg=cfg)
        losses.append(float(loss))
        grads.append([t.numpy() for t in tree_util.tree_leaves(g)])
    return float(np.mean(losses)), _norm(grads)


def _norm(grads):
    """The global norm of the blocks' gradients averaged, in float64."""
    mean = [sum(np.asarray(g[i], np.float64) for g in grads) / len(grads)
            for i in range(len(grads[0]))]
    return np.sqrt(sum(float(np.sum(np.square(g))) for g in mean))


@pytest.mark.parametrize("name", list(R.TRAIN_CASES))
def test_train_step_matches_jax_block_composition(spawned, name):
    mesh_name, axis, ode, nb, mb = R.TRAIN_CASES[name]
    got = spawned(R.world_of(mesh_name))[1]["train"][name]
    loss, gnorm, stats, rows = _jax_blocks(name)
    m = got["metrics"]
    np.testing.assert_allclose(m["loss"], loss, rtol=RTOL)
    np.testing.assert_allclose(m["grad_norm"], gnorm, **ADAPTIVE_TOL)
    assert m["ode_fevals"] == rows * sum(s[2] for s in stats)
    assert m["ode_accepted"] == rows * sum(s[0] for s in stats)
    assert got["params_equal"]
    adaptive = ode["n_steps"] == 0
    assert stats[0] != stats[1] or not adaptive      # two controllers
    # the port's own blocks, each solved on one rank
    np.testing.assert_allclose([m["loss"], m["grad_norm"]],
                               _port_blocks(name), rtol=RTOL)
    for r, (here, log, counts) in enumerate(zip(
            got["rows"], got["branches"], got["counts"])):
        # each row's counters, summed over the branches of its
        # microbatch, are its block's
        log = np.asarray(log)               # [mb x branches, 3, rows/mb]
        totals = log.reshape(mb, -1, *log.shape[1:]).sum(1)
        totals = np.concatenate(list(totals), axis=1)   # [3, rows here]
        assert totals.shape[1] == len(here)
        for j, row in enumerate(here):
            assert totals[:, j].tolist() == stats[row // rows], (name, r,
                                                                 row)
        trials = sum(sum(stats[row // rows][:2])
                     for row in here[::len(here) // mb])
        if mesh_name == "2x2x1":
            # the block spans the two data ranks of a pod
            assert counts["error_norm"] == counts["error_norm@data"] \
                == trials
        else:
            assert counts == {}, (name, r, counts)


# ---------------------------------------------------------------------------
# F8: the MoE inside a fleet ranks its block's tokens
# ---------------------------------------------------------------------------

def test_moe_ranks_the_fleet_blocks_tokens(spawned):
    out, res = spawned(4)
    got = res["f8"]
    cfg = R.moe_cfg(None)
    params = init_lm(torch.Generator().manual_seed(7), cfg, "cpu")
    full = R.batch(cfg, **R.MOE_BATCH)
    nb = R.MOE_BATCH["global_batch"]
    n_blocks, n_ranks = 2, 4
    per_block, per_rank = nb // n_blocks, nb // n_ranks

    def kept(rows):
        with torch.no_grad(), recording_routes() as log:
            lm_loss(params, cfg, {k: v[rows] for k, v in full.items()})
        return [c.kept.numpy() for c in log]

    blocks = [kept(slice(i * per_block, (i + 1) * per_block))
              for i in range(n_blocks)]
    differs = 0
    for r, here in enumerate(got["rows"]):
        assert here == list(range(r * per_rank, (r + 1) * per_rank))
        with np.load(out / f"f8_kept_{r}.npz") as f:
            mine = [f[f"arr_{i}"] for i in range(got["calls"])]
        block, part = divmod(r * per_rank, per_block)
        assert len(mine) == len(blocks[block]) > 0
        for call, want in zip(mine, blocks[block]):
            n = call.shape[0]
            lo = part // per_rank * n
            np.testing.assert_array_equal(call, want[lo:lo + n])
        alone = kept(slice(r * per_rank, (r + 1) * per_rank))
        differs += sum(int((a != b).sum()) for a, b in zip(mine, alone))
        assert sum(int((~k).sum()) for k in mine) > 0       # drops
    # the rank's rows alone rank their tokens otherwise
    assert differs > 0
    # one step against the port's own per-block composition
    losses, grads = [], []
    for i in range(n_blocks):
        loss, _, g = loss_and_grads(
            params, {k: v[i * per_block:(i + 1) * per_block]
                     for k, v in full.items()}, cfg=cfg)
        losses.append(float(loss))
        grads.append([t.numpy() for t in tree_util.tree_leaves(g)])
    np.testing.assert_allclose(got["metrics"]["loss"], np.mean(losses),
                               rtol=RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], _norm(grads),
                               rtol=RTOL)
    assert got["params_equal"]
