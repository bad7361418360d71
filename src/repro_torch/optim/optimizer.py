"""Optimizers: AdamW (low-precision moments + float32 master weights) and
SGD with momentum, with a warmup + cosine schedule and global-norm
clipping.

The port of the JAX package's ``repro.optim.optimizer``, operation for
operation (the bias corrections divide the moments, as there, rather than
folding into the learning rate). Parameters may live in bf16; the
optimizer then carries a float32 master copy plus bf16 m and v by default
(8 bytes a parameter of state). Every function is pure: it returns new
tensors and leaves its inputs as they were.

Scalars (the step, the learning rate, the norm) are 0-d tensors on the
parameters' device, made by fill kernels: no step reads one on the host.
Divisors are tensors too, so the card divides as the CPU does (it turns a
division by a Python number into a multiplication by its reciprocal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree_util as pytree
from repro_torch.models.common import torch_dtype

Pytree = Any
_tm = pytree.tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # 'adamw' | 'sgd'
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    momentum_dtype: str = "bfloat16"   # m/v storage dtype
    master_dtype: str = "float32"      # master weight copy ('' = none)
    momentum: float = 0.9              # sgd


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Pytree
    v: Pytree            # sgd: a (0,) placeholder per leaf
    master: Pytree       # float32 master copy ('' master_dtype: placeholders)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device (a fill kernel)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``total_steps``; a 0-d float32 tensor."""
    s = step.float()
    warm = torch.clamp_max(s / _const(max(cfg.warmup_steps, 1), s), 1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / _const(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * decay


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares,
    added leaf by leaf in tree order."""
    total = None
    for leaf in pytree.tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Pytree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Pytree, torch.Tensor]:
    """max_norm <= 0 disables clipping (the norm is still computed).
    ``norm`` given: the global norm of gradients of which ``grads`` hold
    this rank's blocks (a mesh's data and 'model' shards:
    ``DataParallel.global_norm`` counts each element once)."""
    if norm is None:
        norm = global_norm(grads)
    if max_norm <= 0:
        return grads, norm
    scale = torch.clamp_max(
        _const(max_norm, norm) / torch.clamp_min(norm, 1e-12), 1.0)
    return _tm(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def init_opt_state(cfg: OptimizerConfig, params: Pytree) -> OptState:
    mdt = torch_dtype(cfg.momentum_dtype)

    def placeholder(p):
        return torch.zeros((0,), dtype=torch.float32, device=p.device)

    m = _tm(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
            params)
    if cfg.name == "adamw":
        v = _tm(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                params)
    else:
        v = _tm(placeholder, params)
    if cfg.master_dtype:
        master = _tm(lambda p: p.to(torch_dtype(cfg.master_dtype)).clone(),
                     params)
    else:
        master = _tm(placeholder, params)
    step = torch.zeros((), dtype=torch.int32,
                       device=pytree.tree_leaves(params)[0].device)
    return OptState(step, m, v, master)


def _per_leaf(fn, trees):
    """``fn`` over the leaves of ``trees`` (one structure), returning a
    tuple of results per leaf, as a tuple of trees."""
    leaves, spec = pytree.tree_flatten(trees[0])
    cols = [leaves] + [pytree.tree_leaves(t) for t in trees[1:]]
    outs = [fn(*args) for args in zip(*cols)]
    return tuple(pytree.tree_unflatten([o[i] for o in outs], spec)
                 for i in range(len(outs[0])))


def apply_updates(cfg: OptimizerConfig, params: Pytree, grads: Pytree,
                  state: OptState, grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Pytree, OptState, Dict]:
    """One optimizer step; returns (new_params, new_state, metrics) with
    metrics ``{"lr", "grad_norm"}`` as 0-d float32 tensors.

    Under data parallelism every tree holds this rank's shard of each
    leaf (``params``, ``grads`` and the state's m, v and master alike) and
    ``grad_norm`` is the global gradient norm; the update is elementwise,
    so each new parameter shard is the new master shard cast."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    mdt = torch_dtype(cfg.momentum_dtype)
    master_dt = torch_dtype(cfg.master_dtype) if cfg.master_dtype else None

    def current_master(p, mw):
        return mw.float() if cfg.master_dtype else p.float()

    if cfg.name == "adamw":
        sf = step.float()
        bc1 = 1 - torch.pow(cfg.b1, sf)
        bc2 = 1 - torch.pow(cfg.b2, sf)

        def upd(p, g, m, v, mw):
            gf = g.float()
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            mhat = mf / bc1
            vhat = vf / bc2
            w = current_master(p, mw)
            w = w - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * w)
            new_master = w.to(master_dt) if master_dt is not None else mw
            return w.to(p.dtype), mf.to(mdt), vf.to(mdt), new_master

        new_p, new_m, new_v, new_master = _per_leaf(
            upd, (params, grads, state.m, state.v, state.master))
        return (new_p, OptState(step, new_m, new_v, new_master),
                {"lr": lr, "grad_norm": gnorm})

    # SGD + momentum (the paper's Cifar/ImageNet optimizer)
    def upd_sgd(p, g, m, mw):
        gf = g.float()
        w = current_master(p, mw)
        gf = gf + cfg.weight_decay * w
        mf = cfg.momentum * m.float() + gf
        w = w - lr * mf
        new_master = w.to(master_dt) if master_dt is not None else mw
        return w.to(p.dtype), mf.to(mdt), new_master

    new_p, new_m, new_master = _per_leaf(
        upd_sgd, (params, grads, state.m, state.master))
    return (new_p, OptState(step, new_m, state.v, new_master),
            {"lr": lr, "grad_norm": gnorm})
