"""Train-step construction and the TrainLoop registry.

The port of the JAX package's ``repro.train.loop``. The step is a plain
function of tensors, run eagerly: the JAX package jits it once per config
value (``jitted_train_step``); the port has no jit, and no step reads a
tensor on the host, so the card runs it without a sync.

Gradients come from ``torch.autograd.grad`` of
:func:`~repro_torch.models.lm.lm_loss_and_stats`: the continuous-depth
model's residual branches are ``solve(..., gradient=MALI(...))`` calls,
and the :class:`~repro_torch.core.interface.RunStats` beside the loss
carries the step's integration accounting (f-evals, accepted/rejected
trials) out as int32 tensors.

:class:`TrainLoop` is the registered training-loop axis: :class:`StandardLoop`
carries no extra state, :class:`CompressedLoop` threads int8
error-feedback compression state through the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree_util as pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.interface import RunStats
from repro_torch.models.lm import lm_loss_and_stats
from repro_torch.models.transformer import add_run_stats
from repro_torch.optim.compression import (EFState, compress_grads,
                                           init_ef_state)
from repro_torch.optim.optimizer import (OptimizerConfig, OptState,
                                         apply_updates)

Pytree = Any


def _value_and_grad(params: Pytree, cfg: ModelConfig, batch: Pytree
                    ) -> Tuple[torch.Tensor, RunStats, Pytree]:
    """(loss, RunStats, grads) of one batch; each grad in its parameter's
    dtype (zeros for a parameter the loss does not reach, as in JAX)."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [leaf.detach().requires_grad_() for leaf in leaves]
    loss, stats = lm_loss_and_stats(pytree.tree_unflatten(leaves, spec),
                                    cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), stats, pytree.tree_unflatten(grads, spec)


def _split_microbatches(batch: Pytree, n: int):
    return [pytree.tree_map(lambda a: a.reshape(n, a.shape[0] // n,
                                                *a.shape[1:])[i], batch)
            for i in range(n)]


def loss_and_grads(params: Pytree, batch: Pytree, *, cfg: ModelConfig,
                   microbatches: int = 1
                   ) -> Tuple[torch.Tensor, RunStats, Pytree]:
    """(mean loss, summed RunStats, mean grads) for one global batch.

    With ``microbatches > 1`` the global batch is split on its leading
    axis and the microbatches run one after another (peak memory is one
    microbatch's activations), their gradients accumulated in float32.
    Loss and grads are averaged over microbatches; the integration
    counters are *summed* (they count work actually done).
    """
    if microbatches <= 1:
        return _value_and_grad(params, cfg, batch)
    loss = torch.zeros((), dtype=torch.float32,
                       device=pytree.tree_leaves(params)[0].device)
    grads = pytree.tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), params)
    stats = None
    for mb in _split_microbatches(batch, microbatches):
        mb_loss, mb_stats, g = _value_and_grad(params, cfg, mb)
        loss = loss + mb_loss
        stats = mb_stats if stats is None else add_run_stats(stats, mb_stats)
        grads = pytree.tree_map(torch.add, grads, g)
    inv = 1.0 / microbatches
    return loss * inv, stats, pytree.tree_map(lambda g: g * inv, grads)


def train_step(params: Pytree, opt_state: OptState, ef: Optional[EFState],
               batch: Pytree, *, cfg: ModelConfig, opt_cfg: OptimizerConfig,
               microbatches: int = 1, compress: bool = False,
               zero1: bool = False
               ) -> Tuple[Pytree, OptState, Optional[EFState], Dict]:
    """One full training step as a pure function: returns new (params,
    opt_state, ef) and the metrics ``loss``, ``lr``, ``grad_norm``,
    ``ode_accepted``, ``ode_rejected``, ``ode_fevals`` as 0-d tensors on
    the device.

    ``compress=True`` routes the gradients through int8 error-feedback
    compression, threading ``ef``. ``zero1=True`` shards the optimizer
    update over data-parallel ranks in the JAX package; on one process it
    changes nothing, and over several it is not ported yet.
    """
    if zero1 and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "zero1 over several ranks needs data parallelism, which is not "
            "ported yet (ROADMAP queue 1 item 9)")
    loss, stats, grads = loss_and_grads(params, batch, cfg=cfg,
                                        microbatches=microbatches)
    if compress:
        grads, ef = compress_grads(grads, ef)
    params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                               opt_state)
    metrics["loss"] = loss
    metrics["ode_accepted"] = stats.n_accepted
    metrics["ode_rejected"] = stats.n_rejected
    metrics["ode_fevals"] = stats.n_fevals
    return params, opt_state, ef, metrics


class TrainLoop:
    """Base of the training-loop axis: how one optimizer step is driven.

    A loop owns the step's *extra state* (``carry`` — e.g. error-feedback
    compression state) and maps ``(params, opt_state, carry, batch)`` to
    their successors plus a metrics dict. Subclasses are frozen
    dataclasses registered in :data:`TRAIN_LOOPS`.
    """

    name: str = "?"

    def init_carry(self, params: Pytree) -> Pytree:
        """Initial extra state for this loop (None when stateless)."""
        raise NotImplementedError

    def step(self, params: Pytree, opt_state: OptState, carry: Pytree,
             batch: Pytree, *, cfg: ModelConfig, opt_cfg: OptimizerConfig,
             microbatches: int = 1, zero1: bool = False
             ) -> Tuple[Pytree, OptState, Pytree, Dict]:
        """One optimizer step; returns (params, opt_state, carry,
        metrics)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StandardLoop(TrainLoop):
    """Plain AdamW step (no gradient compression; carry is None)."""

    name = "standard"

    def init_carry(self, params: Pytree) -> None:
        return None

    def step(self, params, opt_state, carry, batch, *, cfg, opt_cfg,
             microbatches=1, zero1=False):
        params, opt_state, _, metrics = train_step(
            params, opt_state, None, batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=microbatches, compress=False, zero1=zero1)
        return params, opt_state, None, metrics


@dataclasses.dataclass(frozen=True)
class CompressedLoop(TrainLoop):
    """int8 error-feedback gradient compression; carry is the EF residual
    (part of the resumable state — dropping it on restore silently
    changes the gradient stream)."""

    name = "compressed"

    def init_carry(self, params: Pytree) -> EFState:
        return init_ef_state(params)

    def step(self, params, opt_state, carry, batch, *, cfg, opt_cfg,
             microbatches=1, zero1=False):
        return train_step(params, opt_state, carry, batch, cfg=cfg,
                          opt_cfg=opt_cfg, microbatches=microbatches,
                          compress=True, zero1=zero1)


TRAIN_LOOPS: Dict[str, TrainLoop] = {
    "standard": StandardLoop(),
    "compressed": CompressedLoop(),
}


def get_train_loop(name: str) -> TrainLoop:
    try:
        return TRAIN_LOOPS[name]
    except KeyError:
        raise ValueError(f"unknown train loop {name!r}; "
                         f"choose from {sorted(TRAIN_LOOPS)}") from None
