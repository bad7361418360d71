"""Data parallelism: a sharding layout executed over a process group.

In the JAX package GSPMD does this work: the Trainer places the batch,
parameters and optimizer state by the rules of
:mod:`repro_torch.distributed.sharding`'s counterpart, and XLA inserts
the collectives. The port runs them itself, over the ``'data'`` dimension
of a ``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`repro_torch.launch.mesh.make_host_mesh`), with the JAX package's
numbers:

* **Rows** (:meth:`DataParallel.local_rows`). Rank r takes its rows of
  the global batch as ``batch_shardings`` places them: block r, and with
  ``microbatches = n`` block r of each of the n contiguous microbatches
  (the JAX package splits the global batch into microbatches, each
  sharded over the data axis).
* **Coupled rows.** Two computations couple a batch's rows: the mean
  cross-entropy, whose count of labels is all-reduced, so each rank's
  loss is its share of the global mean (the shares sum to the loss), and
  the MoE's capacity and buffer positions, which follow the global token
  order. Both read :func:`row_split`, the group the current
  computation's rows are split over (:meth:`DataParallel.splitting_rows`);
  inside a residual branch that solves each rank's rows on its own
  (:func:`solves_per_shard`) the MoE's tokens are the rank's.
* **Gradients** (:meth:`DataParallel.reduce_grads`). A leaf whose
  optimizer state is whole on every rank is all-reduced (summed: each
  rank's gradient is that of its share); one whose optimizer state is
  sharded (ZeRO-1 for the ``'dp'`` configs, the ``'data'`` dimension of
  the ``'fsdp_tp'`` rule) is reduce-scattered along its sharded
  dimension, and the optimizer updates that shard only.
* **Parameters** (:meth:`DataParallel.gather`). After the update each
  sharded leaf is all-gathered, so every rank holds the same whole
  parameters: the port holds parameters whole on every rank (the
  ``'fsdp_tp'`` rule shards them over ``'data'`` too in the JAX package:
  the same numbers, more memory a rank; ROADMAP queue 1 item 11).
* **The global norm and the int8 scale** (:meth:`DataParallel.global_norm`,
  :meth:`DataParallel.max_over_ranks`): per-leaf partial sums of squares
  (or maxima) reduced in one collective, then added leaf by leaf in tree
  order as ``optim.optimizer.global_norm`` does.

Refused (:func:`check_supported`): a mesh axis other than ``'data'``
larger than 1 (tensor parallelism over ``'model'``, multi-pod meshes:
ROADMAP queue 1 item 10), and adaptive step control over several data
ranks without ``ode.batch_axis='data'`` (the controller's error norm
would have to be reduced over the group: item 12).

Collectives go through :class:`DataGroup`, chosen by the group's
backend: NCCL takes device tensors (one card a rank); gloo takes CPU
tensors, and a CUDA tensor is staged through the host (two ranks sharing
one card, where NCCL refuses to run: gloo on CUDA tensors offers only
``broadcast``, ``all_reduce`` and ``barrier``). Every collective is
counted with its bytes and host seconds in :data:`COLLECTIVES`, every
host staging in :data:`HOST_STAGED`, as the kernel wrappers count their
launches.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as _pt

from repro_torch import tree_util as pytree
from repro_torch.configs.base import ModelConfig

from .sharding import (axis_group, batch_shardings, mesh_axes,
                       opt_state_shardings, param_shardings)

Pytree = Any

TENSOR_PARALLEL_ITEM = "ROADMAP queue 1 item 10"
ADAPTIVE_ITEM = "ROADMAP queue 1 item 12"

# torch 2.13 renamed the tensor-form collectives
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

# kind -> [calls, bytes of the whole tensor each call reduced or made,
# host seconds the calls took]
COLLECTIVES: Dict[str, list] = {}
# CUDA tensors copied through the host for a gloo collective (each one a
# device-to-host copy the host waits for)
HOST_STAGED = {"calls": 0, "bytes": 0}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()
    HOST_STAGED.update(calls=0, bytes=0)


def collective_counts() -> Dict[str, Dict[str, float]]:
    """``{kind: {"calls": n, "bytes": b, "seconds": s}}`` plus
    ``"host_staged"``."""
    out = {k: {"calls": c, "bytes": b, "seconds": t}
           for k, (c, b, t) in COLLECTIVES.items()}
    out["host_staged"] = dict(HOST_STAGED)
    return out


class DataGroup:
    """One mesh dimension's process group: its size, this rank's
    coordinate, and how a collective reaches it (by backend)."""

    def __init__(self, axis: str, group, size: int, rank: int):
        self.axis, self.group, self.size, self.rank = axis, group, size, rank
        self.backend = dist.get_backend(group)

    def _call(self, kind: str, fn, out: torch.Tensor, inp: torch.Tensor,
              whole_bytes: int) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.backend == "gloo" and inp.is_cuda:
            # through pinned host buffers: the copy down is the host's
            # one wait, the copy back is queued on the stream
            HOST_STAGED["calls"] += 1
            HOST_STAGED["bytes"] += inp.numel() * inp.element_size()
            inp_h = torch.empty(inp.shape, dtype=inp.dtype,
                                pin_memory=True).copy_(inp)
            out_h = inp_h if out is inp else torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True)
            fn(out_h, inp_h)
            out.copy_(out_h, non_blocking=True)
        else:
            fn(out, inp)
        calls = COLLECTIVES.setdefault(kind, [0, 0, 0.0])
        calls[0] += 1
        calls[1] += whole_bytes
        calls[2] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """A new tensor: ``t`` reduced over the group."""
        out = t.contiguous().clone()
        return self._call(
            "all_reduce",
            lambda o, _: dist.all_reduce(o, op=op, group=self.group),
            out, out, out.numel() * out.element_size())

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of dimension 0 of the sum over the group."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        return self._call(
            "reduce_scatter",
            lambda o, i: _reduce_scatter(o, i, group=self.group),
            out, t, t.numel() * t.element_size())

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated along dimension 0."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * self.size,) + tuple(t.shape[1:]))
        return self._call(
            "all_gather",
            lambda o, i: _all_gather(o, i, group=self.group),
            out, t, out.numel() * out.element_size())


# The groups the rows of the computation now running are split over,
# innermost last (a list, not thread-local state: autograd runs CUDA
# backward functions on its own threads).
_ROW_SPLITS: List[DataGroup] = []


def solves_per_shard(ode) -> bool:
    """Whether a residual branch under the ODE settings ``ode`` solves
    this rank's rows on their own: the rows are split over the branch's
    ``batch_axis`` (the JAX package's ``shard_map``, whose shard is the
    rank's rows)."""
    return (bool(_ROW_SPLITS) and ode.mode != "off"
            and ode.batch_axis == _ROW_SPLITS[-1].axis)


def row_split(ode=None) -> Optional[DataGroup]:
    """The group the current computation's rows are split over (inside
    :meth:`DataParallel.splitting_rows`), else None. Code that runs
    inside a residual branch passes the branch's ODE settings: in a
    branch that :func:`solves_per_shard` the rows are the shard's own,
    and this is None too."""
    if not _ROW_SPLITS or (ode is not None and solves_per_shard(ode)):
        return None
    return _ROW_SPLITS[-1]


def check_supported(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for what the port's data parallelism
    does not run: an axis other than 'data' larger than 1, and adaptive
    control over several data ranks unless each rank solves its own rows
    (``ode.batch_axis='data'``)."""
    axes = mesh_axes(mesh)
    wide = {a: n for a, n in axes.items() if a != "data" and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the port trains data-parallel over the "
            "'data' axis only; tensor parallelism over 'model' (the "
            "production meshes) and multi-pod meshes are not ported "
            f"({TENSOR_PARALLEL_ITEM})")
    if (axes.get("data", 1) > 1 and cfg.ode.mode != "off"
            and cfg.ode.n_steps == 0 and cfg.ode.batch_axis != "data"):
        raise NotImplementedError(
            "adaptive step control (ode_steps=0) over several data ranks "
            "needs ode_batch_axis='data' (each rank's controller on its "
            "own rows); one controller over the global batch would reduce "
            f"the error norm over the group ({ADAPTIVE_ITEM})")


def _split_dim(spec, axes: Dict[str, int]) -> Optional[int]:
    """The one dimension ``spec`` splits over ranks (an axis of size
    > 1), or None."""
    dims = []
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        if any(axes.get(a, 1) > 1 for a in names):
            dims.append(d)
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec} splits {len(dims)} dimensions over ranks "
            f"({TENSOR_PARALLEL_ITEM})")
    return dims[0] if dims else None


class DataParallel:
    """A training step's data-parallel plan on a mesh: the layout of
    ``params``' optimizer state by ``opt_state_shardings`` (which dimension
    of each leaf, if any, is split over the data ranks) and the collectives
    that execute it. Every rank of the mesh builds the same plan and calls
    its collective methods in the same order."""

    def __init__(self, cfg: ModelConfig, mesh, params: Pytree):
        check_supported(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.group = DataGroup("data", *axis_group(mesh, "data"))
        axes = mesh_axes(mesh)
        specs = opt_state_shardings(cfg, mesh,
                                    param_shardings(cfg, mesh, params),
                                    params)
        self.dims: List[Optional[int]] = [
            _split_dim(s, axes) for s in _pt.tree_leaves(specs)]

    @property
    def n_sharded(self) -> int:
        """How many leaves have their optimizer state sharded."""
        return sum(d is not None for d in self.dims)

    # -- rows ---------------------------------------------------------------

    def local_rows(self, batch: Pytree, microbatches: int = 1
                   ) -> Tuple[Pytree, bool]:
        """(this rank's rows of the global ``batch``, whether the rows are
        split). Block r of each microbatch; every row on every rank when
        ``batch_shardings`` replicates the batch or a microbatch does not
        divide over the ranks."""
        specs = batch_shardings(self.cfg, self.mesh, batch)
        lead = _pt.tree_leaves(specs)[0][0]
        if lead is None:
            return batch, False
        names = (lead,) if isinstance(lead, str) else lead
        axes = mesh_axes(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        n_split, idx = 1, 0
        for a in names:
            n_split *= axes[a]
            idx = idx * axes[a] + coord[a]
        per_mb = pytree.tree_leaves(batch)[0].shape[0] // microbatches
        if per_mb % n_split:
            return batch, False
        b = per_mb // n_split

        def rows(a):
            a = a.reshape(microbatches, per_mb, *a.shape[1:])
            return a[:, idx * b:(idx + 1) * b].reshape(
                microbatches * b, *a.shape[2:])

        return pytree.tree_map(rows, batch), True

    @contextlib.contextmanager
    def splitting_rows(self, split: bool = True) -> Iterator[None]:
        """Inside the block (forward and backward), the loss and the MoE
        see rows split over the data group (:func:`row_split`)."""
        if not split:
            yield
            return
        _ROW_SPLITS.append(self.group)
        try:
            yield
        finally:
            _ROW_SPLITS.pop()

    # -- leaves ---------------------------------------------------------------

    def _block(self, t: torch.Tensor, d: int) -> torch.Tensor:
        n = t.shape[d] // self.group.size
        return t.narrow(d, self.group.rank * n, n)

    def _leaves(self, tree: Pytree):
        """(leaves, spec, each leaf's split dimension or None) of a
        params-shaped tree; an empty leaf (the optimizer's placeholder
        for a state it does not keep) is never split."""
        leaves, spec = pytree.tree_flatten(tree)
        return leaves, spec, [None if t.numel() == 0 else d
                              for t, d in zip(leaves, self.dims)]

    def shard(self, tree: Pytree) -> Pytree:
        """This rank's block of each sharded leaf of a params-shaped tree
        (views); other leaves as they are."""
        leaves, spec, dims = self._leaves(tree)
        return pytree.tree_unflatten(
            [t if d is None else self._block(t, d)
             for t, d in zip(leaves, dims)], spec)

    def gather(self, tree: Pytree, host: bool = False) -> Pytree:
        """The whole leaves of a tree of shards (an all-gather along each
        sharded dimension; other leaves as they are). ``host=True`` moves
        each leaf to the host as soon as it is whole (a checkpoint holds
        one whole leaf at a time on the device)."""
        leaves, spec, dims = self._leaves(tree)
        out = []
        for t, d in zip(leaves, dims):
            if d is not None:
                t = self.group.all_gather(t.movedim(d, 0)).movedim(
                    0, d).contiguous()
            out.append(t.cpu() if host else t)
        return pytree.tree_unflatten(out, spec)

    def whole_like(self, tree: Pytree) -> Pytree:
        """Uninitialised host tensors of the whole leaves' shapes and
        dtypes, for a tree of shards (a restore template)."""
        leaves, spec, dims = self._leaves(tree)
        out = []
        for t, d in zip(leaves, dims):
            shape = list(t.shape)
            if d is not None:
                shape[d] *= self.group.size
            out.append(torch.empty(shape, dtype=t.dtype))
        return pytree.tree_unflatten(out, spec)

    def reduce_grads(self, grads: Pytree, split: bool = True) -> Pytree:
        """The global gradient, each leaf in its optimizer state's layout:
        summed over the ranks (whole leaves) or reduce-scattered along the
        sharded dimension. With ``split=False`` every rank computed the
        whole batch: the sharded leaves are cut, nothing is reduced."""
        leaves, spec = pytree.tree_flatten(grads)
        out = []
        for g, d in zip(leaves, self.dims):
            if not split:
                out.append(g if d is None else self._block(g, d))
            elif d is None:
                out.append(self.group.all_reduce(g))
            else:
                out.append(self.group.reduce_scatter(
                    g.movedim(d, 0)).movedim(0, d))
        return pytree.tree_unflatten(out, spec)

    def global_norm(self, grads: Pytree) -> torch.Tensor:
        """``optim.optimizer.global_norm`` of the global gradient, from
        ``grads`` in the layout :meth:`reduce_grads` gives: the leaves'
        float32 sums of squares (a whole leaf's counted on rank 0 only)
        summed over the ranks in one collective, then added leaf by leaf
        in tree order."""
        leaves = pytree.tree_leaves(grads)
        sq = self.group.all_reduce(torch.stack([
            torch.sum(torch.square(g.float()))
            if d is not None or self.group.rank == 0
            else g.new_zeros((), dtype=torch.float32)
            for g, d in zip(leaves, self.dims)]))
        total = sq[0]
        for i in range(1, len(leaves)):
            total = total + sq[i]
        return torch.sqrt(total)

    def max_over_ranks(self, values: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Per-leaf 0-d maxima over the ranks, in one collective (a whole
        leaf's maximum is already the same on every rank)."""
        return list(self.group.all_reduce(torch.stack(values),
                                          op=dist.ReduceOp.MAX).unbind(0))

    def checksum_equal(self, params: Pytree) -> bool:
        """Whether every rank holds the same parameters: each leaf's
        float64 sum and sum of squares, all-gathered and compared."""
        sums = torch.stack([torch.stack([
            torch.sum(p, dtype=torch.float64),
            torch.sum(torch.square(p.float()), dtype=torch.float64)])
            for p in pytree.tree_leaves(params)]).reshape(1, -1)
        every = self.group.all_gather(sums)
        return bool(torch.equal(every, sums.expand_as(every)))


# (cfg, mesh, the parameters' shapes) -> their plan: made once, then
# shared by the Trainer and every step
_PLANS: Dict[tuple, DataParallel] = {}
_MAX_PLANS = 8


def plan_for(cfg: ModelConfig, mesh, params: Pytree
             ) -> Optional[DataParallel]:
    """The data-parallel plan of a mesh of several ranks, None for one
    rank (or no mesh). Made once for each config, mesh and parameter
    shapes, then reused."""
    if mesh is None or mesh.size() <= 1:
        return None
    key = (cfg, mesh, tuple(tuple(t.shape)
                            for t in pytree.tree_leaves(params)))
    if key not in _PLANS:
        if len(_PLANS) >= _MAX_PLANS:
            del _PLANS[next(iter(_PLANS))]
        _PLANS[key] = DataParallel(cfg, mesh, params)
    return _PLANS[key]


__all__ = ["COLLECTIVES", "HOST_STAGED", "DataGroup", "DataParallel",
           "check_supported", "collective_counts", "plan_for",
           "reset_collective_counts", "row_split", "solves_per_shard"]
