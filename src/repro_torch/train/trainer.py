"""The Trainer: resumable, fault-tolerant continuous-depth training.

The port of the JAX package's ``repro.train.trainer``::

    from repro_torch.train import Trainer, TrainerConfig
    t = Trainer(TrainerConfig(steps=20, ckpt_dir="/tmp/run1"))
    t.train()
    t.loss_trace()      # per-step losses (records survive restarts)

The model's residual branches are ``solve()`` calls — ``gradient=MALI(...)``
(or naive/aca/adjoint) with ``ALF(backend="cuda")`` on the card
(``ode_backend="auto"``; the JAX name ``"pallas"`` means the same) and the
plain ALF algebra on the CPU. The loop is a registered
:class:`~repro_torch.train.loop.TrainLoop`; the step runs eagerly (the
JAX package jits it). Everything computes on ``device`` (default: the
CUDA card; ``"cpu"`` only when asked), and the Trainer reads the step's
metrics on the host once a step, as the JAX package does with
``float(loss)``.

Resumability: every checkpoint carries ``(params, opt, ef, rng)`` plus the
:func:`~repro_torch.train.state.config_fingerprint` of the
integrator/optimizer settings, and a resume under a different config
raises :class:`~repro_torch.train.state.ConfigMismatchError` instead of
silently continuing a different trajectory. Failures inside the loop
restart from the latest checkpoint via ``run_with_recovery``; batches
are pure functions of (seed, step) and the step is deterministic, so the
recomputed post-checkpoint steps reproduce the uninterrupted run's loss
trace bit for bit.

The JAX package's multi-host meshes (``production_mesh``, ``multi_pod``)
and ``Sharded`` solve batching over a mesh axis (``ode_batch_axis``) need
data parallelism, which the port's Trainer does not have yet: they raise
``NotImplementedError`` (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               list_checkpoints)
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.ode_block import OdeSettings
from repro_torch.data.synthetic import DataConfig, batch_to_device, make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import run_with_recovery
from repro_torch.models import init_lm
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.loop import get_train_loop
from repro_torch.train.metrics import (MetricsEmitter, StepRecord,
                                       kernel_launch_total, make_emitter,
                                       ode_residual_bytes)
from repro_torch.train.state import (TrainState, config_fingerprint,
                                     init_rng, next_rng, restore_train_state,
                                     state_tree)

log = logging.getLogger("repro_torch.train")

# The paper's default pairings (GradientMethod.default_solver()).
_SOLVER_FOR = {"mali": "alf", "naive": "alf", "aca": "heun_euler",
               "adjoint": "dopri5"}
_NOT_PORTED = ("needs data parallelism over several devices, which the "
               "port's Trainer does not have yet (ROADMAP queue 1 item 9)")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Run description (frozen). The fields of the JAX package's, plus
    ``device``."""
    arch: str = "qwen3-1.7b"
    smoke: bool = True              # reduced config; False = full widths
    ode: bool = True                # continuous depth on/off
    ode_steps: int = 2              # 0 = adaptive controller
    ode_method: str = "mali"        # mali | naive | aca | adjoint
    ode_backend: str = "auto"       # auto | reference | cuda ('pallas')
    ode_batch_axis: str = ""        # mesh axis for Sharded() solves
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 64
    microbatches: int = 1
    loop: str = "standard"          # TRAIN_LOOPS key
    ckpt_dir: str = ""
    ckpt_every: int = 20
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    emit: str = "stdout"            # EMITTERS key
    metrics_path: str = ""          # for emit='jsonl'
    production_mesh: bool = False   # multi-host mesh: not ported
    multi_pod: bool = False
    max_failures: int = 3
    device: str = ""                # '' = the CUDA card

    def torch_device(self) -> torch.device:
        return resolve_device(self.device or None)

    def ode_settings(self) -> OdeSettings:
        if not self.ode:
            return OdeSettings(mode="off")
        backend = {"pallas": "cuda"}.get(self.ode_backend, self.ode_backend)
        if backend == "auto":
            backend = ("cuda" if self.torch_device().type == "cuda"
                       else "reference")
        return OdeSettings(
            mode="per_block", method=self.ode_method,
            solver=_SOLVER_FOR[self.ode_method], n_steps=self.ode_steps,
            backend=backend, batch_axis=self.ode_batch_axis or None)


def build(tc: TrainerConfig):
    """(model config, optimizer config) for one run description."""
    if tc.production_mesh or tc.multi_pod:
        raise NotImplementedError(f"production_mesh/multi_pod {_NOT_PORTED}")
    if tc.ode_batch_axis:
        raise NotImplementedError(f"ode_batch_axis {_NOT_PORTED}")
    ode = tc.ode_settings()
    cfg = (smoke_config(tc.arch, ode) if tc.smoke
           else get_config(tc.arch, ode))
    opt_cfg = OptimizerConfig(total_steps=tc.steps,
                              warmup_steps=max(tc.steps // 20, 1))
    return cfg, opt_cfg


class Trainer:
    """One training run. ``step_hook(step)`` (if given) runs before each
    step on the host — the fault-injection point for recovery tests.
    ``opt_cfg`` replaces the optimizer config :func:`build` derives from
    the run length (the JAX package's rule: a cosine over ``steps`` after
    ``steps // 20`` warmup steps, at least one)."""

    def __init__(self, config: TrainerConfig,
                 emitter: Optional[MetricsEmitter] = None,
                 step_hook: Optional[Callable[[int], None]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None):
        self.config = config
        self.device = config.torch_device()
        self.cfg, self.opt_cfg = build(config)
        if opt_cfg is not None:
            self.opt_cfg = opt_cfg
        self.loop = get_train_loop(config.loop)
        self.emitter = emitter if emitter is not None else make_emitter(
            config.emit, config.metrics_path)
        self.step_hook = step_hook
        self.records: Dict[int, StepRecord] = {}
        self.kernel_launches: Optional[int] = None
        self._state: Optional[TrainState] = None

    @property
    def state(self) -> Optional[TrainState]:
        """Final :class:`TrainState` after :meth:`train` (None before)."""
        return self._state

    def loss_trace(self):
        """Per-step losses in step order. Restarted steps overwrite their
        first attempt, so after a recovery this equals the uninterrupted
        run's trace."""
        return [self.records[s].loss for s in sorted(self.records)]

    def init_state(self) -> TrainState:
        """Seeded weights, a fresh optimizer and the loop's carry."""
        tc = self.config
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params = init_lm(gen, self.cfg, self.device)
        return TrainState(params, init_opt_state(self.opt_cfg, params),
                          self.loop.init_carry(params), init_rng(tc.seed))

    def batch(self, step: int):
        """Step ``step``'s global batch on the run's device."""
        tc = self.config
        dcfg = DataConfig(seed=tc.seed, global_batch=tc.global_batch,
                          seq_len=tc.seq_len)
        return batch_to_device(make_batch(self.cfg, dcfg, step), self.device)

    def train(self) -> int:
        tc = self.config
        cfg, opt_cfg = self.cfg, self.opt_cfg
        fingerprint = config_fingerprint(
            cfg, opt_cfg, arch=tc.arch, loop=tc.loop,
            microbatches=tc.microbatches, seed=tc.seed,
            global_batch=tc.global_batch, seq_len=tc.seq_len)
        ckpt = (AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep)
                if tc.ckpt_dir else None)
        residual_bytes = ode_residual_bytes(
            cfg, tc.global_batch // max(tc.microbatches, 1), tc.seq_len)
        state = self.init_state()

        def train_loop(resume: Optional[int]) -> int:
            nonlocal state
            start = 0
            if resume is not None and ckpt is not None:
                got = restore_train_state(tc.ckpt_dir, state, fingerprint)
                if got is not None:
                    start, state, _meta = got
                    log.info("resumed from step %d", start)
            for step in range(start, tc.steps):
                if self.step_hook is not None:
                    self.step_hook(step)
                t0 = time.time()
                launched = kernel_launch_total()
                p, o, carry, metrics = self.loop.step(
                    state.params, state.opt, state.ef, self.batch(step),
                    cfg=cfg, opt_cfg=opt_cfg, microbatches=tc.microbatches)
                if self.kernel_launches is None:
                    self.kernel_launches = kernel_launch_total() - launched
                # the step's one host read
                loss, lr, gnorm, acc, rej, fev = torch.stack([
                    metrics[k].double() for k in (
                        "loss", "lr", "grad_norm", "ode_accepted",
                        "ode_rejected", "ode_fevals")]).tolist()
                if not math.isfinite(loss):
                    raise RuntimeError(f"non-finite loss at step {step}")
                state = TrainState(p, o, carry, next_rng(state.rng, step))
                rec = StepRecord(
                    step=step, loss=loss, lr=lr, grad_norm=gnorm,
                    wall_s=time.time() - t0, fevals=int(fev),
                    accepted=int(acc), rejected=int(rej),
                    residual_bytes=residual_bytes,
                    kernel_launches=self.kernel_launches)
                self.records[step] = rec
                self.emitter.emit(rec)
                if step % tc.log_every == 0 or step == tc.steps - 1:
                    log.info("step %d loss %.4f lr %.2e gnorm %.2f "
                             "fevals %d", step, loss, rec.lr,
                             rec.grad_norm, rec.fevals)
                if ckpt is not None and (step + 1) % tc.ckpt_every == 0:
                    ckpt.save(step + 1, state_tree(state),
                              metadata={**fingerprint, "loss": loss})
            return tc.steps

        def restore_step() -> Optional[int]:
            if ckpt is None:
                return None
            ckpt.wait()   # a crash may race an in-flight save
            ckpts = list_checkpoints(tc.ckpt_dir)
            return ckpts[-1][0] if ckpts else None

        final, rstats = run_with_recovery(
            train_loop, restore_step, max_failures=tc.max_failures)
        if ckpt is not None:
            ckpt.save(final, state_tree(state),
                      metadata={**fingerprint, "final": True})
            ckpt.close()
        self.emitter.close()
        self._state = state
        log.info("done: step %d (failures=%d)", final, rstats.failures)
        return final
