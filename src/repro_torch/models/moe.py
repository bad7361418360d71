"""Mixture-of-Experts FFN: top-k softmax router, capacity-bounded dispatch,
optional shared experts (DeepSeekMoE-style fine-grained + shared).

The port of the JAX package's ``repro.models.moe``, decision for
decision: a float32 router, top-k over the softmax then
renormalised, each (token, choice)'s rank within its expert from a stable
argsort of the expert ids, ``keep = (rank < capacity) & (gate > 0)``,
scatter-add dispatch into [E, capacity, D] expert buffers, the three
expert products as batched matmuls (cuBLAS on the card, as the JAX
package leaves them to XLA), and a gather back. Capacity is a Python int
and nothing is indexed by a mask, so no call syncs the host with the
card. ``eval_mode=False`` (training) takes ``moe_capacity_factor``, which
drops the (token, choice) pairs past their expert's capacity; autograd
differentiates the dispatch (the scatter-add into the expert buffers) and
the gather back, under ``torch.func.vjp`` too (MALI's backward).
:func:`aux_load_balance_loss` is the Switch-style auxiliary loss; as in
the JAX package, no loss calls it.

:func:`recording_routes` collects each call's routing decisions, so a
caller can see which routes two runs took and which were dropped.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig

from .common import dense_inits, silu, torch_dtype
from .mlp import apply_mlp, mlp_inits

Pytree = Any


class Routes(NamedTuple):
    """One apply_moe call's decisions: expert ids ``idx`` [N, k] and
    whether each (token, choice) fit its expert's capacity, ``kept``
    [N, k]."""
    idx: torch.Tensor
    kept: torch.Tensor


# The open recording_routes() lists, innermost last.
_ROUTE_LOGS: List[List[Routes]] = []


def routes_recording() -> bool:
    """Whether a :func:`recording_routes` block is open."""
    return bool(_ROUTE_LOGS)


@contextlib.contextmanager
def recording_routes() -> Iterator[List[Routes]]:
    """Collect the :class:`Routes` of every apply_moe call inside the
    ``with`` block, in call order (tensors stay on their device)."""
    log: List[Routes] = []
    _ROUTE_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTE_LOGS.pop()


def moe_inits(generator: torch.Generator, cfg: ModelConfig,
              device) -> Pytree:
    """Leaf initializers (``common.materialize``) of one MoE FFN."""
    dt = torch_dtype(cfg.param_dtype)
    d, e, dff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff or cfg.d_ff
    params = {
        "router": dense_inits(generator, (d, e), torch.float32, device),
        "w_gate": dense_inits(generator, (e, d, dff), dt, device),
        "w_up": dense_inits(generator, (e, d, dff), dt, device),
        "w_down": dense_inits(generator, (e, dff, d), dt, device, fan_in=dff),
    }
    if cfg.moe_shared_experts > 0:
        params["shared"] = mlp_inits(generator, cfg,
                                     dff * cfg.moe_shared_experts, device)
    return params


def _capacity(n_tokens: int, cfg: ModelConfig, factor: float) -> int:
    cap = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts * factor))
    return max(min(cap, n_tokens), cfg.moe_top_k)


def apply_moe(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
              eval_mode: bool = False) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. eval_mode uses the (laxer) serve-time
    capacity factor."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(b * s, d)
    n = b * s
    factor = (cfg.moe_eval_capacity_factor if eval_mode
              else cfg.moe_capacity_factor)
    cap = _capacity(n, cfg, factor)

    logits = xt.float() @ params["router"]                       # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # [N, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                   # renormalise

    # rank of each (token, choice) within its expert: stable sort of the
    # expert ids, rank = index - the group's start, scattered back
    eidx = gate_idx.reshape(-1)                                  # [N*k]
    order = torch.argsort(eidx, stable=True)
    sorted_e = eidx[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=eidx.dtype, device=x.device),
        right=False)                                             # [E]
    pos_sorted = (torch.arange(n * k, dtype=eidx.dtype, device=x.device)
                  - group_start[sorted_e])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = (pos < cap) & (gate_vals.reshape(-1) > 0)
    pos_safe = torch.clamp_max(pos, cap - 1)
    for log in _ROUTE_LOGS:
        log.append(Routes(gate_idx, keep.reshape(n, k)))

    cdt = torch_dtype(cfg.compute_dtype)
    x_rep = torch.repeat_interleave(xt, k, dim=0)                # [N*k, D]
    contrib = torch.where(keep[:, None], x_rep, 0).to(cdt)
    expert_in = torch.zeros((e, cap, d), dtype=cdt, device=x.device)
    expert_in.index_put_((eidx, pos_safe), contrib, accumulate=True)
    h = torch.bmm(expert_in, params["w_gate"])                   # [E, cap, F]
    u = torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(silu(h) * u, params["w_down"])        # [E, cap, D]
    gathered = expert_out[eidx, pos_safe]                        # [N*k, D]
    w = (gate_vals.reshape(-1) * keep).to(cdt)
    out = (gathered * w[:, None]).reshape(n, k, d).sum(dim=1)

    if cfg.moe_shared_experts > 0:
        out = out + apply_mlp(params["shared"], xt)
    return out.reshape(b, s, d)


def aux_load_balance_loss(params: Pytree, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (fraction * prob)."""
    b, s, d = x.shape
    probs = torch.softmax(x.reshape(b * s, d).float() @ params["router"],
                          dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.nn.functional.one_hot(top1, cfg.moe_experts).float().mean(0)
    return cfg.moe_experts * torch.sum(frac * probs.mean(0))
