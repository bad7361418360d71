"""Structured per-step training telemetry.

The port of the JAX package's ``repro.train.metrics``. A
:class:`StepRecord` is one row of the run's metrics table: optimizer
scalars (loss, lr, grad norm), wall time, and the continuous-depth
accounting — dynamics evaluations and accepted/rejected trials from the
step's ``solve()`` calls, and the analytic backward-residual footprint
(:func:`ode_residual_bytes`: the paper's O(1)-in-steps memory claim as a
number). Where the JAX record has ``pallas_launches`` (the pallas_call
count of the step's jaxpr, static), the port's has ``kernel_launches``:
the CUDA kernel launches its launchers counted over the run's first
step (0 on the CPU, where the kernel ops run their plain versions).

:class:`MetricsEmitter` is the registered sink axis: stdout JSON lines,
a JSONL file, or an in-memory list for tests.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Type

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One training step's telemetry row (all host scalars)."""
    step: int
    loss: float
    lr: float
    grad_norm: float
    wall_s: float           # wall time of this step (s)
    fevals: int             # dynamics evaluations across the step's solves
    accepted: int           # accepted solver trials
    rejected: int           # rejected solver trials
    residual_bytes: int     # analytic backward-residual footprint (static)
    kernel_launches: int    # CUDA kernel launches of the run's first step

    def as_row(self) -> Dict:
        return dataclasses.asdict(self)


def ode_residual_bytes(cfg: ModelConfig, batch_size: int,
                       seq_len: int) -> int:
    """Analytic backward-residual bytes of one train step's solves.

    Per residual branch this is the gradient method's
    ``residual_bytes(z0, n_obs, solver, controller)`` — for MALI the
    per-observation (z, v) pairs, constant in step count; for Naive/ACA it
    grows with the step budget (paper Table 1) — times the number of ODE
    branches in the depth. Shapes only; 0 with ``ode.mode='off'``.
    """
    if cfg.ode.mode == "off":
        return 0
    solver, controller, gradient, _ = cfg.ode.as_objects()
    z0 = torch.empty((batch_size, seq_len, cfg.d_model), dtype=torch.float32,
                     device="meta")
    n_obs = 2 if cfg.ode.obs_times is None else len(cfg.ode.obs_times)
    per = gradient.residual_bytes(z0, n_obs, solver, controller)
    branches = sum(1 + (spec.mlp != "none") for spec in cfg.layers())
    return per * branches


class MetricsEmitter:
    """Base of the metrics-sink axis; registered in :data:`EMITTERS`."""

    name: str = "?"

    def emit(self, record: StepRecord) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Flush/release the sink (default: nothing to do)."""


class StdoutEmitter(MetricsEmitter):
    """One JSON line per step on stdout."""

    name = "stdout"

    def emit(self, record: StepRecord) -> None:
        print(json.dumps(record.as_row()), flush=True)


class JsonlEmitter(MetricsEmitter):
    """Append-only JSONL file (one row per step)."""

    name = "jsonl"

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, record: StepRecord) -> None:
        self._f.write(json.dumps(record.as_row()) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class MemoryEmitter(MetricsEmitter):
    """In-memory record list (tests / programmatic consumers)."""

    name = "memory"

    def __init__(self):
        self.records: List[StepRecord] = []

    def emit(self, record: StepRecord) -> None:
        self.records.append(record)


EMITTERS: Dict[str, Type[MetricsEmitter]] = {
    "stdout": StdoutEmitter,
    "jsonl": JsonlEmitter,
    "memory": MemoryEmitter,
}


def make_emitter(name: str, path: str = "") -> MetricsEmitter:
    try:
        cls = EMITTERS[name]
    except KeyError:
        raise ValueError(f"unknown metrics emitter {name!r}; "
                         f"choose from {sorted(EMITTERS)}") from None
    if cls is JsonlEmitter:
        if not path:
            raise ValueError("emitter 'jsonl' needs a file path")
        return cls(path)
    return cls()


def kernel_launch_total() -> int:
    """Launches counted by every CUDA kernel launcher of the port so far
    (their ``LAUNCHES`` dicts; the launchers count on the host as they
    launch, so reading them syncs nothing)."""
    from repro_torch.kernels.alf_step import alf_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rmsnorm import rmsnorm
    return sum(sum(m.LAUNCHES.values())
               for m in (alf_step, flash_attention, mamba_scan, rmsnorm))
