"""Fault tolerance and elasticity for the training loop.

The port of the JAX package's ``repro.distributed.fault_tolerance``:

* restart on failure: transient failures (preemption, a lost device —
  simulated by exceptions in the tests) restore from the latest
  checkpoint and rerun, up to ``max_failures`` (:func:`run_with_recovery`).
  Training state is (params, optimizer state, data step) and the
  synthetic batches are a pure function of the step, so a resume is
  exact;
* elastic re-meshing: on losing devices the *data* axis shrinks (the
  'model' axis is fixed by the parameter layout) to the largest size
  that divides the global batch (:func:`plan_elastic_mesh`);
* shard reassignment: a lost host's data shards go round-robin to the
  survivors (:func:`reassign_shards`).

The planners are host arithmetic; a data-parallel run over the planned
mesh is :mod:`repro_torch.distributed.data_parallel`.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class MeshPlan:
    pod: int
    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.pod * self.data * self.model


def plan_elastic_mesh(n_available: int, model_size: int, global_batch: int,
                      pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) mesh fitting the surviving devices:
    'model' fixed, 'data' the largest divisor of ``global_batch`` that
    fits."""
    if n_available < model_size:
        raise RuntimeError(
            f"cannot re-mesh: {n_available} devices < model axis {model_size}")
    data = n_available // (model_size * pods)
    while data > 1 and global_batch % data:
        data -= 1
    if data < 1:
        raise RuntimeError("no valid data axis")
    return MeshPlan(pods, data, model_size)


def reassign_shards(healthy_hosts: Sequence[int], n_shards: int
                    ) -> Dict[int, List[int]]:
    """Round-robin shard ownership over the surviving hosts
    (deterministic)."""
    hosts = sorted(healthy_hosts)
    if not hosts:
        raise RuntimeError("no healthy hosts")
    out: Dict[int, List[int]] = {h: [] for h in hosts}
    for s in range(n_shards):
        out[hosts[s % len(hosts)]].append(s)
    return out


@dataclasses.dataclass
class RecoveryStats:
    failures: int = 0
    restores: int = 0
    last_error: Optional[str] = None


def run_with_recovery(train_loop: Callable[[Optional[int]], int],
                      restore_step: Callable[[], Optional[int]],
                      max_failures: int = 3,
                      backoff_s: float = 0.0) -> Tuple[int, RecoveryStats]:
    """Run ``train_loop(resume_step) -> final_step`` with
    restart-on-failure. ``restore_step()`` returns the latest checkpointed
    step (None = fresh). RuntimeError, OSError and ValueError are retried;
    anything else propagates at once."""
    stats = RecoveryStats()
    while True:
        resume = restore_step()
        if resume is not None:
            stats.restores += 1
        try:
            return train_loop(resume), stats
        except (RuntimeError, OSError, ValueError) as e:
            stats.failures += 1
            stats.last_error = f"{type(e).__name__}: {e}"
            log.warning("training failure #%d: %s", stats.failures, e)
            if stats.failures > max_failures:
                raise
            if backoff_s:
                time.sleep(backoff_s)
