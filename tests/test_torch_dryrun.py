"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
active parameters and model FLOPs of the ten configs against the JAX
package's ``_active_params`` / ``_model_flops`` (through
``jax.eval_shape``), the skip rule cell for cell, the CLI on full-width
cells of each kind on the 16 x 16 mesh and one on 2 x 16 x 16 (one
rank's step on meta tensors under a stand-in mesh), a rank's memory
against the sharding rules' bytes, and the stand-in mesh's groups."""
import dataclasses
import json
import os

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPE_CELLS as JAX_CELLS
from repro.configs.base import cell_applicable as jax_cell_applicable
from repro.launch.specs import param_specs as jax_param_specs
from repro_torch.configs import ARCHS, DEFAULT_ODE, get_config
from repro_torch.configs.base import SHAPE_CELLS, cell_applicable
from repro_torch.distributed.data_parallel import mesh_group
from repro_torch.distributed.sharding import (opt_state_shardings,
                                              param_shardings, shard_bytes)
from repro_torch.distributed.stand_in import StandInMesh
from repro_torch.launch import dryrun
from repro_torch.launch.cost import OpCounter
from repro_torch.launch.mesh import production_axes
from repro_torch.launch.specs import param_specs, serve_shard_bytes

torch.set_num_threads(1)


def _jax_dryrun():
    """The JAX package's dry-run module, imported without keeping the
    512-device XLA flag it sets at import (this process's JAX stays as
    it is)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jd


def test_the_same_configs_and_cells():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in JAX_CELLS]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_and_model_flops_match_jax(arch):
    jd = _jax_dryrun()
    from repro.configs import DEFAULT_ODE as JAX_ODE
    for jode, tode in ((JAX_ODE, DEFAULT_ODE), (None, None)):
        jcfg = jax_get_config(arch, ode=jode)
        tcfg = get_config(arch, ode=tode)
        jp = jax_param_specs(jcfg)
        tp = param_specs(tcfg)
        assert dryrun._active_params(tcfg, tp) == jd._active_params(jcfg, jp)
        for jcell, tcell in zip(JAX_CELLS, SHAPE_CELLS):
            assert dryrun._model_flops(tcfg, tcell, tp) == \
                jd._model_flops(jcfg, jcell, jp), (arch, tcell.name)


def test_skip_rule_matches_jax_cell_for_cell():
    for arch in sorted(ARCHS):
        for jcell, tcell in zip(JAX_CELLS, SHAPE_CELLS):
            assert cell_applicable(get_config(arch), tcell) == \
                jax_cell_applicable(jax_get_config(arch), jcell)
            rec = dryrun.run_cell(arch, tcell.name, False, out_dir="") \
                if not cell_applicable(get_config(arch), tcell)[0] else None
            if rec is not None:
                assert rec["status"] == "skipped"
                assert rec["reason"] == jax_cell_applicable(
                    jax_get_config(arch), jcell)[1]


def _cli(tmp_path, *args):
    assert dryrun.main(["--out", str(tmp_path), *args]) == 0
    return [json.loads(l) for l in
            open(tmp_path / "summary.jsonl").read().splitlines()]


def _check_ok(rec, chips):
    assert rec["status"] == "ok", rec
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert rec["chips"] == chips == roof["chips"]
    assert roof["t_collective_s"] is None
    assert roof["bottleneck"] in ("compute", "memory")
    for key in ("active_params", "model_flops", "memory"):
        assert rec[key]


@pytest.mark.parametrize("arch,shape,mesh", [
    ("stablelm-1.6b", "prefill_32k", "single"),
    ("stablelm-1.6b", "decode_32k", "single"),
    ("jamba-v0.1-52b", "long_500k", "multi"),
])
def test_cli_serve_cells(tmp_path, arch, shape, mesh):
    (rec,) = _cli(tmp_path, "--arch", arch, "--shape", shape, "--mesh",
                  mesh, "--save-hlo")
    chips = 512 if mesh == "multi" else 256
    _check_ok(rec, chips)
    assert rec["mesh"] == ("pod2x16x16" if mesh == "multi" else "pod16x16")
    tag = f"{arch}__{shape}__{rec['mesh']}__ode"
    assert (tmp_path / f"{tag}.json").exists()
    table = json.loads((tmp_path / f"{tag}.ops.json").read_text())
    assert sum(r["bytes"] for r in table) == pytest.approx(
        rec["roofline"]["hbm_bytes"])
    # a rank's memory: the serve plan's shards, by the rules
    cell = next(c for c in SHAPE_CELLS if c.name == shape)
    rules = serve_shard_bytes(get_config(arch, DEFAULT_ODE),
                              production_axes(multi_pod=mesh == "multi"),
                              cell.global_batch, cell.seq_len)
    mem = rec["memory"]
    assert mem["params"] == rules["params"] == mem["rules"]["params"]
    assert mem["cache"] == rules["cache"]
    assert mem["temp_size_in_bytes"] is None
    # the kernel ops the serve path runs, each counted by its declared work
    ops = rec["kernel_ops"]
    assert ops["rmsnorm"]["calls"] > 0 and ops["alf_midpoint"]["calls"] > 0
    if cell.kind == "prefill":
        assert ops["flash_attention"]["calls"] > 0


def test_cli_train_cell(tmp_path):
    """A training cell without the ODE (the fewest ops): one rank's
    ZeRO-1 step on the 16 x 16 mesh, its memory by the rules."""
    arch = "stablelm-1.6b"
    (rec,) = _cli(tmp_path, "--arch", arch, "--shape", "train_4k",
                  "--mesh", "single", "--ode", "off")
    _check_ok(rec, 256)
    roof = rec["roofline"]
    # a 'dp' config: rows over ('data', 'model'), the ZeRO-1 gradient
    # reduce-scatters and parameter all-gathers over the same ranks
    ops = roof["collective_ops"]
    assert ops["reduce-scatter@data+model"] > 0
    assert ops["all-gather@data+model"] == ops["reduce-scatter"]
    assert roof["collective_wire_bytes_per_chip"] > 0
    cfg = get_config(arch, dataclasses.replace(DEFAULT_ODE, mode="off"))
    mesh = production_axes()
    whole = param_specs(cfg)
    p_sh = param_shardings(cfg, mesh, whole)
    assert rec["memory"]["params"] == shard_bytes(p_sh, whole, mesh)
    o_sh = opt_state_shardings(cfg, mesh, p_sh, whole)
    from repro_torch.optim.optimizer import OptimizerConfig
    oc = OptimizerConfig()
    moments = 2 * shard_bytes(o_sh, whole, mesh, dtype=getattr(
        torch, oc.momentum_dtype))
    master = (shard_bytes(o_sh, whole, mesh, dtype=getattr(
        torch, oc.master_dtype)) if oc.master_dtype else 0)
    assert rec["memory"]["optimizer"] == moments + master + 4


def test_cli_refuses_by_roadmap_items(tmp_path):
    """xLSTM serving on a 'model' axis that splits its LSTM caches on
    d_head: recorded, a rank holding its block of every cache; training
    it through its token loops: recorded too (each chunk loop counted by
    its first chunk on meta, 2b.13's dry-run half), no refusal left; the
    CLI exits 0."""
    recs = _cli(tmp_path, "--arch", "xlstm-125m", "--shape", "decode_32k",
                "--mesh", "single")
    assert recs[0]["status"] == "ok"
    cell = next(c for c in SHAPE_CELLS if c.name == "decode_32k")
    rules = serve_shard_bytes(get_config("xlstm-125m", DEFAULT_ODE),
                              production_axes(), cell.global_batch,
                              cell.seq_len)
    assert recs[0]["memory"]["cache"] == rules["cache"] > 0
    rec = dryrun.run_cell("xlstm-125m", "train_4k", False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok" and "item" not in rec
    assert rec["ops"] > 10 ** 6 and rec["roofline"]["flops"] > 0


def _xlstm_meta_step(kind: str, full_loop: bool, monkeypatch):
    """(ops, FLOPs, bytes, the op table) of one step of xLSTM's smoke
    config, cut to one mLSTM and the sLSTM layer, at 4 chunks of 64
    tokens on meta: a train step, or a prefill; ``full_loop`` dispatches
    every chunk."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import LayerSpec
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.launch.specs import META
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import xlstm
    from repro_torch.models.lm import init_serve_state
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    if full_loop:
        monkeypatch.setattr(xlstm, "_by_first_chunk", lambda *a: False)
    ode = dataclasses.replace(DEFAULT_ODE, backend="cuda")
    cfg = dataclasses.replace(
        smoke_config("xlstm-125m", ode), n_periods=1,
        period=(LayerSpec(mixer="mlstm", mlp="none"),
                LayerSpec(mixer="slstm", mlp="none")))
    b, s = 2, 4 * 64
    params = param_specs(cfg)
    tokens = torch.empty((b, s), dtype=torch.int32, device=META)
    if kind == "train":
        opt_cfg = OptimizerConfig()
        opt = init_opt_state(opt_cfg, params)
        step = make_train_step(cfg, opt_cfg)
        run = lambda: step(params, opt, {"tokens": tokens,      # noqa: E731
                                         "labels": tokens})
    else:
        state = init_serve_state(cfg, b, s, META)
        step = make_prefill_step(cfg)
        run = lambda: step(params, {"tokens": tokens}, state)   # noqa: E731
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad, OpCounter() as c:
        run()
    monkeypatch.undo()
    return c.n_ops, c.flops, c.flops_bf16, c.bytes, sorted(
        (k, tuple(v)) for k, v in {**c.by_op, **c.kernels}.items())


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_first_chunk_counting_equals_the_full_loop(kind, monkeypatch):
    """On meta the xLSTM's chunk loop runs its first chunk and charges the
    others its counts (2b.13's dry-run half): the counts of a train step
    and of a prefill equal the full loop's exactly, op by op."""
    from repro_torch.models import xlstm
    calls = []
    real = xlstm._Charged.forward
    monkeypatch.setattr(xlstm._Charged, "forward", staticmethod(
        lambda *a: calls.append(1) or real(*a)))
    first = _xlstm_meta_step(kind, False, monkeypatch)
    assert calls                    # the loop ran its chunks as charged
    full = _xlstm_meta_step(kind, True, monkeypatch)
    assert first == full


def test_cli_exits_1_on_an_error(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--out", str(tmp_path), "--arch", "qwen3-1.7b",
                        "--shape", "decode_32k", "--mesh", "single"]) == 1
    (rec,) = [json.loads(l) for l in
              open(tmp_path / "summary.jsonl").read().splitlines()]
    assert rec["status"] == "error" and "boom" in rec["error"]


def test_stand_in_groups_record_and_compute_nothing():
    mesh = StandInMesh(production_axes(multi_pod=True), coordinate=[1, 2, 3])
    assert mesh.size() == 512 and mesh.get_coordinate() == [1, 2, 3]
    whole = mesh.stand_in_group(("pod", "data", "model"))
    assert (whole.size, whole.rank) == (512, 1 * 256 + 2 * 16 + 3)
    g = mesh_group(mesh, ("pod", "data"))
    assert (g.size, g.rank, g.axis) == (32, 1 * 16 + 2, "pod+data")
    assert mesh_group(mesh, ("model",)) is mesh.stand_in_group(("model",))
    t = torch.empty((64, 8), device="meta")
    with OpCounter() as c:
        assert g.all_reduce(t).shape == (64, 8)
        assert g.reduce_scatter(t).shape == (2, 8)
        assert g.all_gather(t).shape == (64 * 32, 8)
    ops = c.collectives.op_counts
    assert ops == {"all-reduce": 1, "all-reduce@pod+data": 1,
                   "reduce-scatter": 1, "reduce-scatter@pod+data": 1,
                   "all-gather": 1, "all-gather@pod+data": 1}
    nbytes = 64 * 8 * 4
    assert c.collectives.wire_bytes_per_chip == pytest.approx(
        nbytes * 2 * 31 / 32 + nbytes * 31 / 32 + 32 * nbytes * 31 / 32)
    from repro_torch.distributed.sharding import ambient_mesh
    with mesh:
        assert ambient_mesh() is mesh
    assert ambient_mesh() is None
