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
the JAX package, no loss calls it. Under data parallelism
(:func:`~repro_torch.distributed.data_parallel.row_split`; in training and
in a serve step on a mesh, ``eval_mode``) the capacity
and each (token, choice)'s rank come from the global batch: the ranks'
expert ids are all-gathered (a kept token's output does not depend on
the other tokens, so each rank computes its own tokens' outputs).

:func:`recording_routes` collects each call's routing decisions, so a
caller can see which routes two runs took and which were dropped.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.data_parallel import row_split
from repro_torch.distributed.sharding import _Summed
from repro_torch.distributed.tensor_parallel import (block, enter,
                                                     enter_leaves, leave,
                                                     model_split, splits)

from .common import dense_inits, silu, torch_dtype
from .mlp import mlp_inits, mlp_partial

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
    dff = cfg.moe_d_ff or cfg.d_ff
    n = b * s
    factor = (cfg.moe_eval_capacity_factor if eval_mode
              else cfg.moe_capacity_factor)
    # the data group whose ranks' tokens make this call's batch (None
    # inside a training branch that solves the rank's rows on their own,
    # the JAX package's shard_map; its serve path has no such branch)
    split = row_split(None if eval_mode else cfg.ode)
    n_all = n if split is None else n * split.size
    cap = _capacity(n_all, cfg, factor)
    # the rule's splits over 'model': the experts, else their d_ff; the
    # shared experts' d_ff
    tp = model_split()
    split_e = splits(tp, e)
    split_f = not split_e and splits(tp, dff)
    shared = cfg.moe_shared_experts > 0
    split_s = shared and splits(tp, dff * cfg.moe_shared_experts)
    xt = x.reshape(n, d)
    # the routed experts (and the router feeding them) and the shared
    # ones each read the tokens whole or, when split, through enter()
    xr, xs, p = xt, xt, params
    if split_e or split_f:
        xr = enter(xt)
        p = enter_leaves(params, ["router"])
    if split_s:
        xs = xr if xr is not xt else enter(xt)

    logits = xr.float() @ p["router"]                            # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # [N, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                   # renormalise

    # rank of each (token, choice) within its expert: stable sort of the
    # expert ids, rank = index - the group's start, scattered back
    eidx = gate_idx.reshape(-1)                                  # [N*k]
    # under data parallelism, ranked in the global token order: the
    # ranks' ids in rank order, this rank's block taken back
    eidx_all = eidx if split is None else split.all_gather(eidx)
    order = torch.argsort(eidx_all, stable=True)
    sorted_e = eidx_all[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=eidx.dtype, device=x.device),
        right=False)                                             # [E]
    pos_sorted = (torch.arange(n_all * k, dtype=eidx.dtype, device=x.device)
                  - group_start[sorted_e])
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    if split is not None:
        pos = pos[split.rank * n * k:(split.rank + 1) * n * k]
    keep = (pos < cap) & (gate_vals.reshape(-1) > 0)
    pos_safe = torch.clamp_max(pos, cap - 1)
    for log in _ROUTE_LOGS:
        log.append(Routes(gate_idx, keep.reshape(n, k)))

    mine, n_e = keep, e
    if split_e:
        # this rank's experts: the routes to the others add nothing here
        lo, n_e = block(tp, e)
        mine = keep & (eidx >= lo) & (eidx < lo + n_e)
        eidx = torch.clamp(eidx - lo, 0, n_e - 1)
    cdt = torch_dtype(cfg.compute_dtype)
    x_rep = torch.repeat_interleave(xr, k, dim=0)                # [N*k, D]
    contrib = torch.where(mine[:, None], x_rep, 0).to(cdt)
    expert_in = torch.zeros((n_e, cap, d), dtype=cdt, device=x.device)
    expert_in.index_put_((eidx, pos_safe), contrib, accumulate=True)
    h = torch.bmm(expert_in, p["w_gate"])                        # [E, cap, F]
    u = torch.bmm(expert_in, p["w_up"])
    expert_out = torch.bmm(silu(h) * u, p["w_down"])             # [E, cap, D]
    gathered = expert_out[eidx, pos_safe]                        # [N*k, D]
    w = (gate_vals.reshape(-1) * mine).to(cdt)
    out = (gathered * w[:, None]).reshape(n, k, d).sum(dim=1)

    # the ranks' partial outputs summed once, whole ones added after
    partial, whole = [], []
    (partial if split_e or split_f else whole).append(out)
    if shared:
        y = mlp_partial(params["shared"], xs)
        (partial if split_s else whole).append(y)
    out = leave(sum(partial[1:], partial[0])) if partial else whole.pop(0)
    for y in whole:
        out = out + y
    return out.reshape(b, s, d)


def aux_load_balance_loss(params: Pytree, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (fraction * prob).
    Under data parallelism (:func:`~repro_torch.distributed.data_parallel.
    row_split`) the fractions and mean probabilities are the global
    batch's: the ranks' sums are summed over the group (their gradients
    each rank's own), so every rank returns the global batch's loss."""
    b, s, d = x.shape
    probs = torch.softmax(x.reshape(b * s, d).float() @ params["router"],
                          dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    counts = torch.nn.functional.one_hot(top1, cfg.moe_experts).float()
    counts, mass, n = counts.sum(0), probs.sum(0), b * s
    split = row_split(cfg.ode)
    if split is not None:
        counts = split.all_reduce(counts)
        mass = _Summed.apply(mass, split)
        n *= split.size
    return cfg.moe_experts * torch.sum((counts / n) * (mass / n))
