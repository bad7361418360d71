"""Resumable training state: what a checkpoint must carry to continue a
run bit-identically.

The port of the JAX package's ``repro.train.state``. The state is more
than (params, optimizer): the solver/gradient configuration is part of
it. A run trained with ``gradient=MALI(...)`` follows a different
parameter trajectory than one trained with ``Naive()`` at the same seed,
so silently resuming under another integrator corrupts the run while
looking healthy. Every checkpoint therefore embeds a
:func:`config_fingerprint` of the model's ODE settings + optimizer config
+ data/loop knobs, and :func:`restore_train_state` refuses a mismatched
resume with :class:`ConfigMismatchError`. The fingerprint's payload and
hash are the JAX package's, so the two agree on a run described alike;
with ``backend="reference"`` they are equal, while the kernel backend is
``"cuda"`` here and ``"pallas"`` there.

``TrainState.rng`` differs from the JAX package's: JAX carries a PRNG key
folded with each step; the port carries ``(seed + 1, steps done)`` as an
int64 (2,) tensor on the host. Nothing in the step draws from it (as in
JAX); it is the counter a resumed run continues from.

``ConfigMismatchError`` deliberately subclasses plain ``Exception`` — not
RuntimeError/OSError/ValueError — so it propagates straight through
``distributed.fault_tolerance.run_with_recovery`` (which retries those
three) instead of being retried forever against the same checkpoint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpoint import restore_latest
from repro_torch.configs.base import ModelConfig
from repro_torch.optim.compression import EFState
from repro_torch.optim.optimizer import OptimizerConfig, OptState

Pytree = Any


class TrainState(NamedTuple):
    """Everything tensor-valued a resume needs (the fingerprint rides in
    the checkpoint manifest next to it)."""
    params: Pytree
    opt: OptState
    ef: Optional[EFState]    # error-feedback carry (None for StandardLoop)
    rng: torch.Tensor        # int64 (2,): (seed + 1, steps done), host


def init_rng(seed: int) -> torch.Tensor:
    return torch.tensor([seed + 1, 0], dtype=torch.int64)


def next_rng(rng: torch.Tensor, step: int) -> torch.Tensor:
    """The rng after ``step`` (where the JAX package folds ``step`` into
    its key)."""
    return torch.tensor([int(rng[0]), step + 1], dtype=torch.int64)


class ConfigMismatchError(Exception):
    """A checkpoint's config fingerprint disagrees with the current run's.

    Not a RuntimeError/ValueError subclass on purpose: run_with_recovery
    retries those, and a config mismatch never heals by retrying.
    """


def config_fingerprint(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                       arch: str, loop: str, microbatches: int, seed: int,
                       global_batch: int, seq_len: int) -> Dict[str, Any]:
    """JSON-able config payload + a stable short hash over it: the full
    ODE settings (method/solver/steps/tolerances/backend), the optimizer
    schedule, the data shape/seed, and the loop/microbatch split."""
    payload = {
        "arch": arch,
        "ode": dataclasses.asdict(cfg.ode),
        "opt": dataclasses.asdict(opt_cfg),
        "loop": loop,
        "microbatches": microbatches,
        "seed": seed,
        "global_batch": global_batch,
        "seq_len": seq_len,
        "d_model": cfg.d_model,
        "n_layers": cfg.n_layers,
    }
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
    return {"config": payload, "config_hash": digest}


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The checkpointed tree. ``ef=None`` contributes no leaves, so a
    StandardLoop checkpoint and its restore template agree."""
    return {"params": state.params, "opt": state.opt, "ef": state.ef,
            "rng": state.rng}


def restore_train_state(ckpt_dir: str, like: TrainState,
                        fingerprint: Dict[str, Any]
                        ) -> Optional[Tuple[int, TrainState, dict]]:
    """Restore the latest checkpoint into ``like``'s structure, dtypes and
    devices. Returns (step, state, metadata), or None when the directory
    holds no checkpoint. Raises :class:`ConfigMismatchError` when the
    checkpoint was written under another config fingerprint."""
    got = restore_latest(ckpt_dir, state_tree(like))
    if got is None:
        return None
    step, tree, meta = got
    saved = meta.get("config_hash")
    want = fingerprint["config_hash"]
    if saved is not None and saved != want:
        saved_cfg = meta.get("config", {})
        diff = {k: (saved_cfg.get(k), fingerprint["config"].get(k))
                for k in set(saved_cfg) | set(fingerprint["config"])
                if saved_cfg.get(k) != fingerprint["config"].get(k)}
        raise ConfigMismatchError(
            f"checkpoint at step {step} in {ckpt_dir!r} was written under a "
            f"different training config (hash {saved} != {want}); "
            f"differing fields: {diff}. Resuming would silently change the "
            "parameter trajectory — restart with the original config or a "
            "fresh ckpt dir.")
    state = TrainState(params=tree["params"], opt=tree["opt"],
                       ef=tree["ef"], rng=tree["rng"])
    return step, state, meta
