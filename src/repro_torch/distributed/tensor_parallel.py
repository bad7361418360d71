"""Tensor parallelism over the mesh's ``'model'`` axis, inside the layers.

In the JAX package GSPMD is this module: the rules of
:mod:`repro_torch.distributed.sharding` split a leaf over ``'model'``,
its ``hint`` calls pin a few activations, and XLA inserts the collectives.
The port places them itself, Megatron-style. A training step over a mesh
whose ``'model'`` axis is larger than 1 (for a ``'tp'`` or ``'fsdp_tp'``
config) opens :func:`splitting_model` with the axis's group; the layer
code reads it (:func:`model_split`), as it reads the rows' group through
:func:`~repro_torch.distributed.data_parallel.row_split`, and works on
its block of each split leaf:

* activations entering and leaving a mixer or an MLP are whole on every
  rank of the group; a split computation starts with :func:`enter`
  (identity forward, the cotangent summed over the group) and its
  partial results leave through :func:`leave` (summed forward, identity
  backward). Whole leaves used inside the split computation (the router,
  K/V projections that the group does not divide, the q/k norms, Mamba's
  per-channel vectors) enter through :func:`enter_leaves`, one
  collective for all of them, so their gradients are summed over the
  group as well;
* :func:`gather_last` puts the ranks' blocks of a last dimension
  together (the embedding split on D), its backward taking the rank's
  block of the cotangent; :func:`gather_last_summed` does the same with
  the cotangents' blocks summed (Mamba's in-projection, whose blocks are
  then sliced per rank).

So the ODE state that a residual branch integrates is whole and bit-equal
on the ranks of a group: each f-eval's result is the output of one
all-reduce, and the ALF state algebra and the controller run on it on
every rank. :func:`recording_states` collects the branches' end states,
so a caller can check that.

**Serving** (no autograd) opens :func:`serving` with the 'model' group
whose blocks the serve caches hold (:func:`serve_model`; None where the
batch is split over 'model' or the axis has one rank) and the 'data'
group over which a KV cache's sequence may be split (:func:`serve_data`).
Attention and Mamba read them, since a pure-DP config keeps its weights
whole while the rule still splits its caches over 'model'; the MLP, the
MoE, the embedding and the head read :func:`model_split`, the weights'
split, as in training. The no-grad collectives they use:
:func:`gather_dim` (the ranks' blocks of one dimension put together),
:func:`sum_over` (an all-reduce) and :func:`combine_split_kv`
(flash-decoding's log-sum-exp combine of partial attention over the
ranks that each hold a block of the positions).

:func:`block` gives a rank's range of a dimension that the rule splits,
:func:`splits` whether the rule splits a dimension of a given size.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch

from repro_torch import tree_util

from .sharding import _plain, _Replicated, _Summed

# The 'model' groups of the computations now running, innermost last (a
# list, not thread-local state: autograd runs backward functions on its
# own threads).
_MODEL_SPLITS: List = []
# The open recording_states() lists, innermost last.
_STATE_LOGS: List[List[torch.Tensor]] = []
# The open serving() groups, (model, data), innermost last.
_SERVING: List[Tuple[Any, Any]] = []


def model_split():
    """The group (a :class:`~repro_torch.distributed.data_parallel.
    DataGroup` over ``'model'``) that the current computation's split
    leaves are split over, or None."""
    return _MODEL_SPLITS[-1] if _MODEL_SPLITS else None


@contextlib.contextmanager
def splitting_model(group) -> Iterator[None]:
    """Inside the block (forward and backward), the layers work on
    ``group``'s blocks of the leaves the rule splits over 'model'. A
    group of one rank (or None) changes nothing."""
    if group is None or group.size == 1:
        yield
        return
    _MODEL_SPLITS.append(group)
    try:
        yield
    finally:
        _MODEL_SPLITS.pop()


def splits(tp, size: int) -> bool:
    """Whether the rule splits a dimension of ``size`` over the group
    ``tp`` (every rule is divisibility-guarded)."""
    return tp is not None and size % tp.size == 0


def block(tp, size: int) -> Tuple[int, int]:
    """(start, length) of the rank's block of a dimension of ``size``
    split over ``tp``."""
    n = size // tp.size
    return tp.rank * n, n


def enter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, whole on every rank, entering a split computation (over
    ``group``, default :func:`model_split`)."""
    return _Replicated.apply(x, group or model_split())


def leave(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' partial results summed: whole on every rank (over
    ``group``, default :func:`model_split`)."""
    return _Summed.apply(x, group or model_split())


class _EnterLeaves(torch.autograd.Function):
    """Identity forward of several tensors; the backward sums all their
    cotangents over the group in one collective (a flat float32
    buffer)."""

    @staticmethod
    def forward(group, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[0]

    @staticmethod
    def backward(ctx, *gs):
        gs = [_plain(g) for g in gs]
        flat = ctx.group.all_reduce(torch.cat([g.reshape(-1).float()
                                               for g in gs]))
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None, *out)


def enter_leaves(params: Dict[str, Any], names: Sequence[str]
                 ) -> Dict[str, Any]:
    """``params`` with its whole entries ``names`` (those present; a
    tensor or a subtree) marked as used inside a split computation: their
    gradients (each rank's a partial one) are summed over the group, in
    one collective."""
    names = [n for n in names if n in params]
    if not names:
        return params
    leaves, spec = tree_util.tree_flatten([params[n] for n in names])
    entered = tree_util.tree_unflatten(
        _EnterLeaves.apply(model_split(), *leaves), spec)
    out = dict(params)
    out.update(zip(names, entered))
    return out


class _GatherLast(torch.autograd.Function):
    """The ranks' blocks of the last dimension put together; the backward
    takes the rank's block of the cotangent (``summed=False``: the
    cotangent is whole on every rank) or of its sum over the group."""

    @staticmethod
    def forward(x, group, summed):
        x = _plain(x)
        out = group.all_gather(x.movedim(-1, 0))
        return out.movedim(0, -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.summed = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        g = _plain(g).movedim(-1, 0)
        if ctx.summed:
            g = ctx.group.reduce_scatter(g)
        else:
            n = g.shape[0] // ctx.group.size
            g = g[ctx.group.rank * n:(ctx.group.rank + 1) * n]
        return g.movedim(0, -1).contiguous(), None, None


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of ``x``'s last dimension, concatenated; the
    result is used whole on every rank."""
    return _GatherLast.apply(x, model_split(), False)


def gather_last_summed(x: torch.Tensor) -> torch.Tensor:
    """As :func:`gather_last`, for a result of which each rank uses a
    part: the backward sums the ranks' cotangents."""
    return _GatherLast.apply(x, model_split(), True)


def record_state(z: torch.Tensor) -> None:
    """Note a residual branch's end state (detached) in every open
    :func:`recording_states` list."""
    for log in _STATE_LOGS:
        log.append(z.detach())


@contextlib.contextmanager
def recording_states() -> Iterator[List[torch.Tensor]]:
    """Collect the end state of every residual branch's solve inside the
    block, in call order."""
    log: List[torch.Tensor] = []
    _STATE_LOGS.append(log)
    try:
        yield log
    finally:
        _STATE_LOGS.pop()


# ---------------------------------------------------------------------------
# Serving: the caches' groups and the no-grad collectives
# ---------------------------------------------------------------------------

def serve_model():
    """The 'model' group whose blocks the serve caches of the step now
    running hold (heads, ``d_head`` or d_inner), or None."""
    return _SERVING[-1][0] if _SERVING else None


def serve_data():
    """The 'data' group of the serve step now running (a KV cache whose
    sequence the rule splits holds this rank's block of positions), or
    None."""
    return _SERVING[-1][1] if _SERVING else None


@contextlib.contextmanager
def serving(model, data) -> Iterator[None]:
    """Inside the block, a serve step's caches are split over the groups
    ``model`` and ``data`` (either None) as the rule places them."""
    _SERVING.append((model, data))
    try:
        yield
    finally:
        _SERVING.pop()


def gather_dim(group, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x``'s dimension ``dim`` put together in
    rank order, on every rank (no gradient)."""
    return group.all_gather(_plain(x).movedim(dim, 0)).movedim(0, dim)


def sum_over(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``group`` (no gradient; the identity without a
    group)."""
    return x if group is None else group.all_reduce(_plain(x))


def combine_split_kv(group, m: torch.Tensor, l: torch.Tensor,
                     o: torch.Tensor) -> torch.Tensor:
    """Attention over positions split across ``group`` from each rank's
    partial softmax over its block: ``m`` the block's maximum score
    [...], ``l`` its sum of ``exp(s - m)`` [...], ``o`` its unnormalised
    output ``exp(s - m) @ v`` [..., d]. The partials are gathered and
    combined by log-sum-exp in rank order, the same arithmetic on every
    rank: sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, M = max_r m_r."""
    part = torch.cat([m[..., None], l[..., None], o], -1)
    every = group.all_gather(part[None])          # [ranks, ..., 2 + d]
    ms, ls, os_ = every[..., 0], every[..., 1], every[..., 2:]
    w = torch.exp(ms - ms.amax(0))
    return (w[..., None] * os_).sum(0) / (w * ls).sum(0)[..., None]


__all__ = ["model_split", "splitting_model", "splits", "block", "enter",
           "leave", "enter_leaves", "gather_last", "gather_last_summed",
           "record_state", "recording_states", "serve_model", "serve_data",
           "serving", "gather_dim", "sum_over", "combine_split_kv"]
