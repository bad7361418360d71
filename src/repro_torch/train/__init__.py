"""repro_torch.train — the continuous-depth training subsystem.

The port of the JAX package's ``repro.train``: the
:class:`~repro_torch.train.trainer.Trainer` composes the continuous-depth
LM (whose residual branches are ``solve(..., gradient=MALI(...))`` calls)
with a registered :class:`~repro_torch.train.loop.TrainLoop`,
resumable checkpoint state (:mod:`repro_torch.train.state` — params,
optimizer, error feedback, the rng counter and the solver/gradient config
fingerprint), fault recovery
(:func:`repro_torch.distributed.fault_tolerance.run_with_recovery`) and
structured telemetry (:mod:`repro_torch.train.metrics`).

``python -m repro_torch.launch.train`` is a thin CLI over this package.
"""
from .loop import (TRAIN_LOOPS, CompressedLoop, StandardLoop, TrainLoop,
                   get_train_loop, loss_and_grads, train_step)
from .metrics import (EMITTERS, JsonlEmitter, MemoryEmitter, MetricsEmitter,
                      StdoutEmitter, StepRecord, kernel_launch_total,
                      make_emitter, ode_residual_bytes)
from .state import (ConfigMismatchError, TrainState, config_fingerprint,
                    restore_train_state, state_tree)
from .trainer import Trainer, TrainerConfig

__all__ = [
    "Trainer", "TrainerConfig",
    "TrainLoop", "StandardLoop", "CompressedLoop", "TRAIN_LOOPS",
    "get_train_loop", "loss_and_grads", "train_step",
    "StepRecord", "MetricsEmitter", "StdoutEmitter", "JsonlEmitter",
    "MemoryEmitter", "EMITTERS", "make_emitter", "ode_residual_bytes",
    "kernel_launch_total",
    "TrainState", "ConfigMismatchError", "config_fingerprint",
    "restore_train_state", "state_tree",
]
