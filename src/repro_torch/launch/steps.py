"""Step-function factories of the training path.

The port of ``make_loss_fn`` and ``make_train_step`` from the JAX
package's ``repro.launch.steps``: closures over the configs around
:mod:`repro_torch.train.loop`. ``make_train_step`` returns the full step
— loss, grads (optionally micro-batched, optionally through int8
error-feedback compression), clip, AdamW/SGD update — as
``(params, opt_state[, ef], batch) -> (params, opt_state[, ef], metrics)``;
the metrics include the step's integration accounting (``ode_accepted``,
``ode_rejected``, ``ode_fevals``). The JAX factory's ``grad_shardings``
(a sharding constraint on the gradients) has no counterpart on one card.
The serving steps are ``launch.serve.make_decode_step`` and
``models.prefill``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import lm_loss
from repro_torch.optim.compression import EFState
from repro_torch.optim.optimizer import OptimizerConfig, OptState
from repro_torch.train.loop import train_step as _train_step

Pytree = Any


def make_loss_fn(cfg: ModelConfig
                 ) -> Callable[[Pytree, Pytree], torch.Tensor]:
    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1, compress: bool = False,
                    zero1: bool = False):
    """``zero1=True``: the step over the ambient mesh (``train_step``'s
    ``zero1``), the parameters and optimizer state the rank's shards."""
    if compress:
        def train_step(params, opt_state: OptState, ef: EFState, batch):
            return _train_step(params, opt_state, ef, batch, cfg=cfg,
                               opt_cfg=opt_cfg, microbatches=microbatches,
                               compress=True, zero1=zero1)
        return train_step

    def train_step(params, opt_state: OptState, batch):
        params, opt_state, _, metrics = _train_step(
            params, opt_state, None, batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=microbatches, zero1=zero1)
        return params, opt_state, metrics

    return train_step
