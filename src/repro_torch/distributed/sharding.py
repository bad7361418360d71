"""The ambient device mesh and the collectives of ``Sharded`` batching.

The JAX package finds its mesh through ``with mesh:`` and splits a batch
with ``shard_map(in_specs=(P(), P(axis)), out_specs=P(axis))``: inputs
replicated, outputs sharded over the axis. The port does the same over a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`repro_torch.launch.mesh.make_host_mesh`): ``with mesh:`` makes it
ambient (:func:`ambient_mesh`); each rank takes its slice of the rows of
a replicated input; :func:`gather_rows` puts the whole batch back on
every rank, its backward taking the rank's own slice of the cotangent;
and :func:`replicated` marks a replicated input, its backward summing
the ranks' cotangents. The gradient of a loss of the gathered output is
then the unsharded solve's on every rank. A mesh dimension of size 1
makes every one of these the identity, with no collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def ambient_mesh():
    """The mesh of the innermost active ``with mesh:`` context, or
    None."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = getattr(_mesh_resources, "mesh_stack", [])
    return stack[-1] if stack else None


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the cotangent
    over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the backward takes this rank's
    slice of the cotangent (each rank's loss already sees the whole
    batch, so a sum would count it ``size`` times)."""

    @staticmethod
    def forward(ctx, x, group, size: int, rank: int):
        ctx.rows, ctx.rank = x.shape[0], rank
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def replicated(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x``, replicated on the ``size`` ranks of ``group``: its gradient
    is the sum of the ranks' (the identity when ``size`` is 1)."""
    if size == 1:
        return x
    return _Replicated.apply(x, group)


def gather_rows(x: torch.Tensor, group, size: int,
                rank: int) -> torch.Tensor:
    """The ranks' row slices of ``group`` concatenated in rank order, on
    every rank (the identity when ``size`` is 1). Integer tensors (the
    per-row counters) are gathered without a gradient."""
    if size == 1:
        return x
    if not x.is_floating_point():
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)
    return _GatherRows.apply(x, group, size, rank)


def axis_group(mesh, axis: str):
    """(process group, size, this rank's coordinate) of one mesh
    dimension."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


__all__ = ["ambient_mesh", "replicated", "gather_rows", "axis_group"]
