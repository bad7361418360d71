"""Restart-on-failure for the training loop.

The port of ``run_with_recovery`` and ``RecoveryStats`` from the JAX
package's ``repro.distributed.fault_tolerance``: transient failures
(preemption, a lost device — simulated by exceptions in the tests)
restore from the latest checkpoint and rerun, up to ``max_failures``.
Training state is (params, optimizer state, data step) and the synthetic
batches are a pure function of the step, so a resume is exact. The mesh
planners of that module (``plan_elastic_mesh``, ``reassign_shards``)
come with data parallelism (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Tuple

log = logging.getLogger("repro_torch.ft")


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
