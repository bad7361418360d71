"""Stand-in meshes: one rank's view of a production mesh, with no process
group.

The JAX package's dry run lowers a step on 512 fake host devices. The
port's (:mod:`repro_torch.launch.dryrun`) runs one rank's step on meta
tensors inside ``with StandInMesh({axis: size}):``. The mesh answers what
the layout code asks of a ``DeviceMesh`` (its dimension names and sizes,
the rank's coordinate), so ``ParamLayout``, ``DataParallel`` and
``ServePlan`` cut the rank's shards as on a real mesh, and
:func:`~repro_torch.distributed.data_parallel.mesh_group` takes its groups
from :meth:`StandInMesh.stand_in_group`: :class:`StandInGroup`, shaped
as a ``DataGroup`` (``axis``, ``axes``, ``size``, ``rank``,
``all_reduce``, ``reduce_scatter``, ``all_gather``). A stand-in
collective returns a new tensor of the result's shape (on meta tensors:
a shape and nothing else) and records its kind, axis and bytes in every
open op counter (``launch/cost.py``). No ``torch.distributed`` backend
is touched.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import _mesh_resources

from repro_torch import kernels


class StandInGroup:
    """The group of one or several mesh dimensions of a stand-in mesh
    (``axes``, first axis major): its size and this rank's place in it.
    Its collectives compute nothing; they return tensors of the result's
    shape and dtype and record themselves."""

    backend = "stand-in"
    group = None

    def __init__(self, axes: Tuple[str, ...], size: int, rank: int):
        self.axes, self.size, self.rank = axes, size, rank
        self.axis = "+".join(axes)

    def _record(self, kind: str, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        for c in kernels.COUNTERS:
            c.record_collective(kind, self.axis, self.size, nbytes)

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """A new tensor of ``t``'s shape (the sum over the group)."""
        out = t.contiguous().clone()
        self._record("all-reduce", out)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of dimension 0 (of the sum)."""
        t = t.contiguous()
        self._record("reduce-scatter", t)
        return t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))

    def all_gather(self, t: torch.Tensor, name=None) -> torch.Tensor:
        """The ranks' tensors along dimension 0 (this rank's repeated)."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * self.size,) + tuple(t.shape[1:]))
        self._record("all-gather", out)
        return out


class StandInMesh:
    """One rank (``coordinate``, default the first) of a mesh of
    ``{axis: size}``, e.g. ``launch.mesh.production_axes()``. Use it as
    ``with StandInMesh(axes) as mesh:``: inside the block it is the
    ambient mesh (``sharding.ambient_mesh``), as a ``DeviceMesh`` is."""

    def __init__(self, axes: Dict[str, int],
                 coordinate: Optional[Sequence[int]] = None):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(int(n) for n in axes.values())
        self.coordinate = list(coordinate or [0] * len(self.shape))
        self._groups: Dict[Tuple[str, ...], StandInGroup] = {}

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_coordinate(self):
        return list(self.coordinate)

    def stand_in_group(self, axes: Tuple[str, ...],
                       block: Optional[int] = None) -> StandInGroup:
        """The group over the mesh dimensions ``axes`` (in that order,
        first axis major); with ``block``, the ``block`` consecutive
        ranks of that order that hold this rank, named after the axes
        they differ on (``data_parallel.mesh_group``)."""
        idx = [self.mesh_dim_names.index(a) for a in axes]
        size, rank = 1, 0
        for i in idx:
            size *= self.shape[i]
            rank = rank * self.shape[i] + self.coordinate[i]
        if block is not None and block != size:
            from repro_torch.distributed.data_parallel import _block_axes
            over = _block_axes(tuple(axes), [self.shape[i] for i in idx],
                               rank, block)
            return StandInGroup(over, block, rank % block)
        if axes not in self._groups:
            self._groups[axes] = StandInGroup(tuple(axes), size, rank)
        return self._groups[axes]

    def __enter__(self):
        _mesh_resources.mesh_stack.append(self)
        return self

    def __exit__(self, *exc):
        _mesh_resources.mesh_stack.pop()
        return False


__all__ = ["StandInGroup", "StandInMesh"]
