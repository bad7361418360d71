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

Meshes: as in the JAX package every run is on a mesh: ``make_host_mesh``
over the default ``torch.distributed`` process group (a (W, 1) ("data",
"model") mesh, made once a process and reused), or with
``production_mesh`` / ``multi_pod`` the production meshes (16 x 16
("data", "model"), 2 x 16 x 16 ("pod", "data", "model");
``make_production_mesh``, which raises ``ValueError`` naming the 256 or
512 ranks it needs). Side effects: in a process with no process group
the first Trainer makes one of world size 1 (NCCL on the card, gloo on
the CPU), and on the card each Trainer makes its device the current CUDA
device. Over several ranks each rank computes its rows of the global
batch and holds its shards of the state
(:mod:`repro_torch.distributed.data_parallel`): the parameters by
``param_shardings`` (split over 'model' for tensor parallelism, and over
'data' for the ``'fsdp_tp'`` configs, gathered layer by layer), the
optimizer state and the error-feedback carry by ``opt_state_shardings``
(ZeRO-1 for the replicated leaves). The steps, losses and checkpoints
are the one-rank run's. The parameters start from the seed, whole, on
every rank (a checksum all-gather confirms them equal), and each rank
keeps its shards. Rank 0 writes each checkpoint, the whole state
gathered from the shards (the files a one-rank run writes); every rank
restores the whole state and keeps its shards, so checkpoints move
between world sizes and mesh shapes. ``ode_batch_axis="data"`` solves
each rank's rows with its own controller (the JAX package's
``Sharded("data")``). Refused, with a ``NotImplementedError`` naming
ROADMAP queue 1 item 12: adaptive control (``ode_steps=0``) over several
data ranks without ``ode_batch_axis="data"``.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import tree_util as pytree
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               list_checkpoints)
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.core.ode_block import OdeSettings
from repro_torch.data.synthetic import DataConfig, batch_to_device, make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.data_parallel import (DataParallel,
                                                   check_supported, plan_for)
from repro_torch.distributed.fault_tolerance import run_with_recovery
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_lm
from repro_torch.optim.compression import EFState
from repro_torch.optim.optimizer import (OptimizerConfig, OptState,
                                         init_opt_state)
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
    production_mesh: bool = False   # the 16x16 mesh (256 ranks)
    multi_pod: bool = False         # the 2x16x16 one (512; implies it)
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
    """(model config, mesh, optimizer config) for one run description.
    The mesh is ``make_host_mesh`` over the default process group, or a
    production mesh (every rank calls this). A world that is not the
    production mesh's raises ``ValueError``; a mesh or config the port
    cannot train on raises ``NotImplementedError``."""
    ode = tc.ode_settings()
    cfg = (smoke_config(tc.arch, ode) if tc.smoke
           else get_config(tc.arch, ode))
    if tc.production_mesh or tc.multi_pod:
        mesh = make_production_mesh(multi_pod=tc.multi_pod,
                                    device=tc.torch_device())
    else:
        mesh = make_host_mesh(tc.torch_device())
    check_supported(cfg, mesh)
    opt_cfg = OptimizerConfig(total_steps=tc.steps,
                              warmup_steps=max(tc.steps // 20, 1))
    return cfg, mesh, opt_cfg


def _map_shards(state: TrainState, fn, params_fn=None) -> TrainState:
    """``state`` with ``fn`` applied to the trees in the optimizer
    state's layout (the optimizer's m, v and master, the error-feedback
    carry) and ``params_fn`` (if given) to the parameters."""
    o, ef = state.opt, state.ef
    params = state.params if params_fn is None else params_fn(state.params)
    return TrainState(params,
                      OptState(o.step, fn(o.m), fn(o.v), fn(o.master)),
                      None if ef is None else EFState(fn(ef.error)),
                      state.rng)


class Trainer:
    """One training run. ``step_hook(step)`` (if given) runs before each
    step on the host — the fault-injection point for recovery tests.
    ``opt_cfg`` replaces the optimizer config :func:`build` derives from
    the run length (the JAX package's rule: a cosine over ``steps`` after
    ``steps // 20`` warmup steps, at least one); ``model_cfg`` replaces
    the model config (a config ``arch`` names, changed, e.g. in its
    widths or its sharding strategy)."""

    def __init__(self, config: TrainerConfig,
                 emitter: Optional[MetricsEmitter] = None,
                 step_hook: Optional[Callable[[int], None]] = None,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 model_cfg: Optional[ModelConfig] = None):
        self.config = config
        self.device = config.torch_device()
        self.cfg, self.mesh, self.opt_cfg = build(config)
        if opt_cfg is not None:
            self.opt_cfg = opt_cfg
        if model_cfg is not None:
            check_supported(model_cfg, self.mesh)
            self.cfg = model_cfg
        self.loop = get_train_loop(config.loop)
        self.emitter = emitter if emitter is not None else make_emitter(
            config.emit, config.metrics_path)
        self.step_hook = step_hook
        self.records: Dict[int, StepRecord] = {}
        self.kernel_launches: Optional[int] = None
        self.plan: Optional[DataParallel] = None   # set by init_state
        self._state: Optional[TrainState] = None

    @property
    def state(self) -> Optional[TrainState]:
        """The newest :class:`TrainState`: after each step of
        :meth:`train`, the final one after it (None before)."""
        return self._state

    def loss_trace(self):
        """Per-step losses in step order. Restarted steps overwrite their
        first attempt, so after a recovery this equals the uninterrupted
        run's trace."""
        return [self.records[s].loss for s in sorted(self.records)]

    def init_state(self) -> TrainState:
        """Seeded weights, a fresh optimizer and the loop's carry. Over
        several ranks every tree holds this rank's shards (:attr:`plan`):
        the ranks' whole weights are checked equal, each keeps its
        shards, and the whole ones are freed."""
        tc = self.config
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params = init_lm(gen, self.cfg, self.device)
        self.plan = plan_for(self.cfg, self.mesh, params)
        if self.plan is None:
            return TrainState(params, init_opt_state(self.opt_cfg, params),
                              self.loop.init_carry(params),
                              init_rng(tc.seed))
        if not self.plan.checksum_equal(params):
            raise RuntimeError("the ranks' seeded weights differ")
        params = self.plan.param_shards(params)
        local = self.plan.param_to_opt(params)
        return TrainState(params, init_opt_state(self.opt_cfg, local),
                          self.loop.init_carry(local), init_rng(tc.seed))

    def whole_state(self, state: Optional[TrainState] = None
                    ) -> TrainState:
        """``state`` (default: the newest) with every tree whole,
        gathered from the ranks' shards onto the host (a collective:
        every rank calls it); what a checkpoint holds."""
        state = self._state if state is None else state
        if self.plan is None:
            return state
        return _map_shards(
            state, lambda t: self.plan.gather(t, host=True),
            lambda t: self.plan.gather_params(t, host=True))

    def _restore(self, state: TrainState, fingerprint):
        """The latest checkpoint as this rank's state (its shards of the
        whole state), or None."""
        tc, plan = self.config, self.plan
        if plan is None:
            return restore_train_state(tc.ckpt_dir, state, fingerprint)
        got = restore_train_state(tc.ckpt_dir,
                                  _map_shards(state, plan.whole_like,
                                              plan.whole_like),
                                  fingerprint)
        if got is None:
            return None
        step, whole, meta = got

        def mine(tree):
            return pytree.tree_map(lambda t: t.to(self.device).clone(), tree)

        return step, _map_shards(whole, lambda t: mine(plan.shard(t)),
                                 lambda t: mine(plan.param_shards(
                                     t, copy=False))), meta

    def batch(self, step: int):
        """Step ``step``'s global batch on the run's device."""
        tc = self.config
        dcfg = DataConfig(seed=tc.seed, global_batch=tc.global_batch,
                          seq_len=tc.seq_len)
        return batch_to_device(make_batch(self.cfg, dcfg, step), self.device)

    def train(self) -> int:
        with self.mesh:
            return self._train()

    def _train(self) -> int:
        tc = self.config
        cfg, opt_cfg = self.cfg, self.opt_cfg
        fingerprint = config_fingerprint(
            cfg, opt_cfg, arch=tc.arch, loop=tc.loop,
            microbatches=tc.microbatches, seed=tc.seed,
            global_batch=tc.global_batch, seq_len=tc.seq_len)
        rank0 = self.mesh.get_rank() == 0
        # rank 0 writes; the others wait at a barrier before reading
        ckpt = (AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep)
                if tc.ckpt_dir and rank0 else None)
        residual_bytes = ode_residual_bytes(
            cfg, tc.global_batch // max(tc.microbatches, 1), tc.seq_len)
        zero1 = self.mesh.size() > 1
        state = self.init_state()

        def barrier():
            if self.plan is not None:
                dist.barrier(group=self.plan.world.group)

        def save(step: int, metadata: dict):
            tree = state_tree(self.whole_state(state))
            if ckpt is not None:
                ckpt.save(step, tree, metadata=metadata)

        def train_loop(resume: Optional[int]) -> int:
            nonlocal state
            start = 0
            if resume is not None:
                got = self._restore(state, fingerprint)
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
                    cfg=cfg, opt_cfg=opt_cfg, microbatches=tc.microbatches,
                    zero1=zero1)
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
                self._state = state
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
                if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
                    save(step + 1, {**fingerprint, "loss": loss})
            return tc.steps

        def restore_step() -> Optional[int]:
            if not tc.ckpt_dir:
                return None
            if ckpt is not None:
                ckpt.wait()   # a crash may race an in-flight save
            barrier()
            ckpts = list_checkpoints(tc.ckpt_dir)
            return ckpts[-1][0] if ckpts else None

        final, rstats = run_with_recovery(
            train_loop, restore_step, max_failures=tc.max_failures)
        if tc.ckpt_dir:
            save(final, {**fingerprint, "final": True})
            if ckpt is not None:
                ckpt.close()
            barrier()   # the final checkpoint is on disk on every rank
        self.emitter.close()
        self._state = state
        log.info("done: step %d (failures=%d)", final, rstats.failures)
        return final
