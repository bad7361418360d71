"""The port's ``repro_torch.train`` on the CPU (``device="cpu"``):
Trainer determinism, telemetry, resumable checkpoints (bit-equality and
the config fingerprint, equal to the JAX package's), fault-injected
recovery continuity, the loop and emitter registries, and the CLI — the
JAX package's ``tests/test_train.py`` on the port, whose JAX ``Trainer``
is not an oracle here (its mesh path fails under this jax).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.optim.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.state import config_fingerprint as jax_config_fingerprint
from repro_torch import tree_util
from repro_torch.configs import smoke_config
from repro_torch.launch.train import main as train_main
from repro_torch.train import (CompressedLoop, ConfigMismatchError,
                               JsonlEmitter, MemoryEmitter, MetricsEmitter,
                               StandardLoop, StdoutEmitter, TRAIN_LOOPS,
                               Trainer, TrainerConfig, TrainLoop,
                               config_fingerprint, get_train_loop,
                               make_emitter, ode_residual_bytes,
                               restore_train_state, state_tree)
from repro_torch.configs import OdeSettings

torch.set_num_threads(1)

TINY = dict(steps=6, global_batch=4, seq_len=16, ode_steps=2,
            ckpt_every=2, keep=5, log_every=100, emit="memory",
            device="cpu")


def tiny_trainer(**kw) -> Trainer:
    return Trainer(TrainerConfig(**{**TINY, **kw}))


@pytest.fixture(scope="module")
def clean_run():
    """One uninterrupted tiny MALI run, shared as the reference trace."""
    t = tiny_trainer()
    assert t.train() == TINY["steps"]
    return t


def test_same_seed_same_trace(clean_run):
    again = tiny_trainer()
    again.train()
    assert again.loss_trace() == clean_run.loss_trace()
    assert all(np.isfinite(v) for v in again.loss_trace())
    assert clean_run.loss_trace()[-1] < clean_run.loss_trace()[0]


def test_step_records_account_for_the_odes(clean_run):
    recs = [clean_run.records[s] for s in sorted(clean_run.records)]
    assert [r.step for r in recs] == list(range(TINY["steps"]))
    # fixed-step solves: the f-eval budget is the same every step
    assert recs[0].fevals == 3 * 4 and recs[0].accepted == 2 * 4
    assert len({(r.fevals, r.accepted, r.rejected) for r in recs}) == 1
    assert recs[0].rejected == 0
    want = ode_residual_bytes(clean_run.cfg, TINY["global_batch"],
                              TINY["seq_len"])
    # MALI: the (z, v) pairs at the 2 observations, 4 branches, f32
    assert want == 4 * 2 * 2 * 4 * 16 * 64 * 4
    assert all(r.residual_bytes == want for r in recs)
    # backend 'auto' is the reference backend on the CPU: no kernel runs
    assert all(r.kernel_launches == 0 for r in recs)
    row = recs[0].as_row()
    assert set(row) >= {"step", "loss", "lr", "grad_norm", "wall_s",
                        "fevals", "residual_bytes", "kernel_launches"}
    assert clean_run.cfg.ode.backend == "reference"


def test_memory_emitter_collects_every_step(clean_run):
    assert isinstance(clean_run.emitter, MemoryEmitter)
    assert [r.step for r in clean_run.emitter.records] == \
        list(range(TINY["steps"]))


def test_jsonl_emitter_round_trips(tmp_path, clean_run):
    path = str(tmp_path / "metrics.jsonl")
    em = JsonlEmitter(path)
    for rec in clean_run.emitter.records:
        em.emit(rec)
    em.close()
    rows = [json.loads(line) for line in open(path)]
    assert rows == [r.as_row() for r in clean_run.emitter.records]


def test_make_emitter_validation():
    assert isinstance(make_emitter("stdout"), StdoutEmitter)
    with pytest.raises(ValueError, match="jsonl"):
        make_emitter("jsonl")
    with pytest.raises(ValueError, match="unknown"):
        make_emitter("bogus")


def _fingerprint(t: Trainer):
    tc = t.config
    return config_fingerprint(t.cfg, t.opt_cfg, arch=tc.arch, loop=tc.loop,
                              microbatches=tc.microbatches, seed=tc.seed,
                              global_batch=tc.global_batch,
                              seq_len=tc.seq_len)


def test_config_fingerprint_equals_the_jax_packages(clean_run):
    """Same payload, same hash, at backend="reference"."""
    tc = clean_run.config
    jcfg = jax_smoke_config(tc.arch, JaxOdeSettings(
        mode="per_block", method="mali", solver="alf", n_steps=2,
        backend="reference"))
    jopt = JaxOptimizerConfig(total_steps=tc.steps,
                              warmup_steps=max(tc.steps // 20, 1))
    want = jax_config_fingerprint(
        jcfg, jopt, arch=tc.arch, loop=tc.loop, microbatches=tc.microbatches,
        seed=tc.seed, global_batch=tc.global_batch, seq_len=tc.seq_len)
    assert _fingerprint(clean_run) == want
    # the kernel backend's names differ: "cuda" here, "pallas" there
    cuda = dataclasses.replace(clean_run.cfg, ode=dataclasses.replace(
        clean_run.cfg.ode, backend="cuda"))
    got = config_fingerprint(cuda, clean_run.opt_cfg, arch=tc.arch,
                             loop=tc.loop, microbatches=1, seed=tc.seed,
                             global_batch=tc.global_batch,
                             seq_len=tc.seq_len)
    assert got["config_hash"] != want["config_hash"]


def test_checkpoint_restores_bit_identical_state(tmp_path):
    t = tiny_trainer(ckpt_dir=str(tmp_path / "run"))
    final = t.train()
    got = restore_train_state(str(tmp_path / "run"), t.state,
                              _fingerprint(t))
    assert got is not None
    step, restored, meta = got
    assert step == final and meta["final"] is True
    live = tree_util.tree_leaves(state_tree(t.state))
    back = tree_util.tree_leaves(state_tree(restored))
    assert len(live) == len(back)
    for a, b in zip(live, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored.rng.tolist() == [t.config.seed + 1, TINY["steps"]]


def test_fault_injection_reproduces_clean_loss_trace(tmp_path, clean_run):
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    t = Trainer(TrainerConfig(**TINY, ckpt_dir=str(tmp_path / "faulty"),
                              max_failures=2), step_hook=hook)
    assert t.train() == TINY["steps"]
    assert fired == [3]
    # recomputed post-checkpoint steps overwrite their first attempt, so
    # the recovered trace equals the uninterrupted run's, bit for bit
    assert t.loss_trace() == clean_run.loss_trace()


def test_resume_under_different_config_refuses(tmp_path):
    d = str(tmp_path / "run")
    tiny_trainer(ckpt_dir=d, steps=2).train()
    other = tiny_trainer(ckpt_dir=d, steps=2, ode_steps=3)
    with pytest.raises(ConfigMismatchError, match="ode"):
        other.train()
    assert not issubclass(ConfigMismatchError,
                          (RuntimeError, ValueError, OSError))


def test_train_loop_registry():
    assert isinstance(get_train_loop("standard"), StandardLoop)
    assert isinstance(get_train_loop("compressed"), CompressedLoop)
    assert set(TRAIN_LOOPS) == {"standard", "compressed"}
    with pytest.raises(ValueError, match="unknown"):
        get_train_loop("bogus")
    for loop in TRAIN_LOOPS.values():
        for member in ("init_carry", "step"):
            assert getattr(type(loop), member) is not getattr(TrainLoop,
                                                              member)
    for cls in (StdoutEmitter, JsonlEmitter, MemoryEmitter):
        assert cls.emit is not MetricsEmitter.emit


def test_compressed_loop_trains_and_carries_ef():
    t = tiny_trainer(steps=3, loop="compressed")
    assert t.train() == 3
    assert t.state.ef is not None
    assert all(np.isfinite(v) for v in t.loss_trace())


def test_microbatch_accumulation_trains():
    t = tiny_trainer(steps=3, microbatches=2)
    assert t.train() == 3
    recs = [t.records[s] for s in range(3)]
    assert all(np.isfinite(r.loss) for r in recs)
    # counters add over the two microbatches
    assert recs[0].fevals == 2 * 3 * 4


@pytest.mark.parametrize("kw", [dict(production_mesh=True),
                                dict(multi_pod=True),
                                dict(ode_batch_axis="data")],
                         ids=["production_mesh", "multi_pod",
                              "ode_batch_axis"])
def test_unported_axes_raise(kw, clean_run):
    """The production meshes need their worlds: on one process the
    Trainer raises ``ValueError`` naming the 256 (512) ranks;
    ``ode_batch_axis="data"`` trains on the one-rank host mesh
    (``Sharded`` over one rank: the lockstep solve of every row), its
    counters summed over the batch's rows."""
    if "ode_batch_axis" not in kw:
        need = "512" if kw.get("multi_pod") else "256"
        with pytest.raises(ValueError, match=f"world of {need} ranks"):
            tiny_trainer(**kw)
        return
    t = tiny_trainer(**kw)
    assert t.cfg.ode.batch_axis == "data" and t.mesh.size() == 1
    assert t.train() == TINY["steps"]
    assert t.loss_trace() == clean_run.loss_trace()
    rows = TINY["global_batch"]
    for s in range(TINY["steps"]):
        assert t.records[s].fevals == rows * clean_run.records[s].fevals


def test_backend_names():
    """'auto' is the reference backend on the CPU; 'pallas' (the JAX
    package's name) means 'cuda'."""
    tc = TrainerConfig(**TINY)
    assert tc.ode_settings().backend == "reference"
    assert TrainerConfig(**{**TINY, "ode_backend": "pallas"}
                         ).ode_settings().backend == "cuda"
    assert TrainerConfig(**{**TINY, "ode": False}).ode_settings().mode == \
        "off"


def test_default_device_is_the_card():
    """Without ``device`` the Trainer computes on the CUDA card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TrainerConfig(**{**TINY, "device": ""}))


def test_cli_smoke_and_resume(tmp_path, capsys):
    argv = ["--smoke", "--steps", "4", "--global-batch", "4",
            "--seq-len", "16", "--ckpt-dir", str(tmp_path / "cli"),
            "--ckpt-every", "2", "--log-every", "100", "--device", "cpu"]
    train_main(argv)
    out = capsys.readouterr().out
    assert "final_step=4" in out
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    train_main(argv)    # restores the final checkpoint, runs 0 new steps
    out = capsys.readouterr().out
    assert "final_step=4" in out and not out.count('"step"')


def test_residual_bytes_off_mode_is_zero():
    cfg = smoke_config("qwen3-1.7b", OdeSettings(mode="off"))
    assert ode_residual_bytes(cfg, 4, 16) == 0


def test_trainer_config_is_value_hashable():
    a = TrainerConfig(**TINY)
    b = TrainerConfig(**TINY)
    assert a == b and hash(a) == hash(b)
    assert dataclasses.replace(a, ode_method="naive") != a


def test_optimizer_config_override():
    """By default the schedule follows the run length (the JAX package's
    rule); ``opt_cfg`` replaces it."""
    from repro_torch.optim import OptimizerConfig
    t = tiny_trainer(steps=2)
    assert (t.opt_cfg.total_steps, t.opt_cfg.warmup_steps) == (2, 1)
    t = Trainer(TrainerConfig(**{**TINY, "steps": 2}),
                opt_cfg=OptimizerConfig(peak_lr=1e-5, warmup_steps=50))
    assert t.train() == 2
    assert t.records[0].lr == pytest.approx(1e-5 / 50 * 1.0, rel=1e-3)
