"""Data parallelism, FSDP and the layout of a training step over a mesh.

In the JAX package GSPMD does this work: the Trainer places the batch,
parameters and optimizer state by the rules of
:mod:`repro_torch.distributed.sharding`'s counterpart, and XLA inserts
the collectives. The port runs them itself over a ``torch.distributed``
:class:`~torch.distributed.device_mesh.DeviceMesh` whose axes the rules
name: the host mesh ``("data", "model")`` of
:func:`repro_torch.launch.mesh.make_host_mesh`, or a two- or
three-dimensional mesh ``("data", "model")`` / ``("pod", "data",
"model")`` (the production meshes' layout). The numbers are the
unsharded step's:

* **Rows** (:meth:`DataParallel.local_rows`). Rank r takes its rows of
  the global batch as ``batch_shardings`` places them: over ``('pod',
  'data')``, and for the ``'dp'`` configs over ``'model'`` too when it
  divides, block r of each of the n contiguous microbatches. Under
  adaptive step control the rows are never split over ``'model'``: the
  ranks of a ``'model'`` group then solve their data shard's rows whole
  (one controller needs no collective; ROADMAP queue 1 item 12).
* **Coupled rows.** The mean cross-entropy's count of labels is summed
  over the rows' group, so each rank's loss is its share of the global
  mean, and the MoE's capacity and buffer positions follow the global
  token order. Both read :func:`row_split` (:meth:`DataParallel.
  splitting_rows`); inside a residual branch that solves each rank's rows
  on its own (:func:`solves_per_shard`) the MoE's tokens are the rank's.
* **Parameters.** Each rank holds its block of every leaf by
  ``param_shardings``, on both axes (:meth:`DataParallel.param_shards`).
  A leaf split over ``'model'`` stays split: the layers compute on their
  block (:mod:`repro_torch.distributed.tensor_parallel`). A leaf split
  over ``'data'`` (the ``'fsdp_tp'`` configs) is all-gathered over
  ``'data'`` where a layer starts (:func:`fsdp_gathered`), once for its
  forward, and freed when the layer ends: whatever the layer's autograd
  nodes save of it (MALI's residuals, the products' operands) is packed
  as the shard by ``saved_tensors_hooks`` and gathered again, once, when
  its backward unpacks it. Its gradient is reduce-scattered over
  ``'data'`` by the gather's backward. :data:`FSDP_GATHERS` counts the
  gathers.
* **Gradients** (:meth:`DataParallel.reduce_grads`) come out in the
  optimizer state's layout (``opt_state_shardings``): summed over the
  rows' axes, reduce-scattered where the state is ZeRO-1 sharded, and
  the update runs on the shards. The parameters a rank holds are then
  gathered back from the shards where ZeRO-1 cut finer than the rule.
  ``train_step`` takes and returns the rank's shards.
* **The global norm and the int8 scale** (:meth:`DataParallel.
  global_norm`, :meth:`DataParallel.max_over_ranks`): per-leaf partial
  sums of squares (each element counted on one rank) or maxima, reduced
  over the mesh in one collective, then added leaf by leaf in tree order
  as ``optim.optimizer.global_norm`` does.

Refused (:func:`check_supported`): adaptive step control over several
data ranks without ``ode.batch_axis='data'`` (the controller's error norm
would have to be reduced over the group every trial: ROADMAP queue 1
item 12).

**Serving** (:class:`ServePlan`, :func:`serve_plan_for`): a prefill or
decode step on a mesh, on the parameter leaves' layout that training
uses too (:class:`ParamLayout`, the base of both plans). The parameters
are the rank's shards by ``param_shardings`` (cut leaf by leaf as
``init_lm`` draws them, :meth:`ServePlan.cut`), the caches the rank's blocks by
``cache_shardings`` (:meth:`ServePlan.cache_shape`), and the rows those
of the caches' batch dimension (:meth:`ServePlan.local_rows`; every row
on every rank where the batch does not divide the data axes). Inside
:meth:`ServePlan.computing` the layers split over 'model' as in training
(the caches' 'model' group beside the weights',
:func:`~repro_torch.distributed.tensor_parallel.serving`), the MoE ranks
its tokens in the global order (:func:`row_split`), and each layer
gathers its leaves split over 'data' once (:func:`fsdp_gathered`).
Refused by the serve plan: caches that the rule splits over 'model' where
the serve path does not split its compute (the xLSTM's LSTM states, whose
weights the rule replicates; a Mamba cache split on its window or state
axis): ROADMAP queue 1 item 15.

Collectives go through :class:`DataGroup`, one for each mesh dimension
or set of dimensions (:func:`mesh_group`), chosen by the group's
backend: NCCL takes device tensors (one card a rank); gloo takes CPU
tensors, and a CUDA tensor is staged through the host (ranks sharing one
card, where NCCL refuses to run: gloo on CUDA tensors offers only
``broadcast``, ``all_reduce`` and ``barrier``). Every collective is
counted with its bytes and host seconds in :data:`COLLECTIVES`, by kind
(``"all_reduce"``) and by kind and axis (``"all_reduce@model"``), every
host staging in :data:`HOST_STAGED`, as the kernel wrappers count their
launches.
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as _pt

from repro_torch import tree_util as pytree
from repro_torch.configs.base import ModelConfig

from .sharding import (_cache_batch_axes, _path_names, axis_group,
                       batch_shardings, cache_leaf_spec, cache_shardings,
                       dp_axes, local_shape, mesh_axes, opt_state_shardings,
                       param_shardings)
from .tensor_parallel import serving, splitting_model

Pytree = Any

ADAPTIVE_ITEM = "ROADMAP queue 1 item 12"
SERVE_ITEM = "ROADMAP queue 1 item 15"

# torch 2.13 renamed the tensor-form collectives
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

# kind, and kind@axis -> [calls, bytes of the whole tensor each call
# reduced or made, host seconds the calls took]
COLLECTIVES: Dict[str, list] = {}
# CUDA tensors copied through the host for a gloo collective (each one a
# device-to-host copy the host waits for)
HOST_STAGED = {"calls": 0, "bytes": 0}
# FSDP's all-gathers over 'data': where a layer starts ("forward") and
# where a backward unpacks a saved leaf ("backward")
FSDP_GATHERS = {"forward": 0, "backward": 0}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()
    HOST_STAGED.update(calls=0, bytes=0)
    FSDP_GATHERS.update(forward=0, backward=0)


def collective_counts() -> Dict[str, Dict[str, float]]:
    """``{kind: {"calls": n, "bytes": b, "seconds": s}}`` (each kind
    also as ``kind@axis``), plus ``"host_staged"`` and
    ``"fsdp_gathers"``."""
    out = {k: {"calls": c, "bytes": b, "seconds": t}
           for k, (c, b, t) in COLLECTIVES.items()}
    out["host_staged"] = dict(HOST_STAGED)
    out["fsdp_gathers"] = dict(FSDP_GATHERS)
    return out


class DataGroup:
    """The process group of one mesh dimension or of several flattened
    (``axes``, first axis major): its size, this rank's coordinate, and
    how a collective reaches it (by backend)."""

    def __init__(self, axis: str, group, size: int, rank: int,
                 axes: Optional[Tuple[str, ...]] = None):
        self.axis, self.group, self.size, self.rank = axis, group, size, rank
        self.axes = axes or (axis,)
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
        seconds = time.perf_counter() - t0
        for key in (kind, f"{kind}@{self.axis}"):
            calls = COLLECTIVES.setdefault(key, [0, 0, 0.0])
            calls[0] += 1
            calls[1] += whole_bytes
            calls[2] += seconds
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


# (mesh, axes) -> their DataGroup: a flattened group is made with
# dist.new_group, a collective call, so once
_GROUPS: Dict[tuple, DataGroup] = {}


def mesh_group(mesh, axes) -> Optional[DataGroup]:
    """The :class:`DataGroup` over the mesh dimensions ``axes`` of size
    > 1 (one dimension's own group, or the dimensions flattened in the
    order given), None when there are none. Every rank of the mesh must
    ask for the same groups in the same order."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return None
    key = (mesh, axes)
    if key not in _GROUPS:
        if len(axes) == 1:
            _GROUPS[key] = DataGroup(axes[0], *axis_group(mesh, axes[0]))
        else:
            names = list(mesh.mesh_dim_names)
            rest = [names.index(a) for a in names if a not in axes]
            ranks = mesh.mesh.permute(rest + [names.index(a) for a in axes])
            me, mine = dist.get_rank(), None
            for row in ranks.reshape(-1, math.prod(
                    sizes[a] for a in axes)).tolist():
                pg = dist.new_group(row)
                if me in row:
                    mine = (pg, len(row), row.index(me))
            _GROUPS[key] = DataGroup("+".join(axes), *mine, axes=axes)
    return _GROUPS[key]


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
            and ode.batch_axis in _ROW_SPLITS[-1].axes)


def row_split(ode=None) -> Optional[DataGroup]:
    """The group the current computation's rows are split over (inside
    :meth:`DataParallel.splitting_rows`), else None. Code that runs
    inside a residual branch passes the branch's ODE settings: in a
    branch that :func:`solves_per_shard` the rows are the shard's own,
    and this is None too."""
    if not _ROW_SPLITS or (ode is not None and solves_per_shard(ode)):
        return None
    return _ROW_SPLITS[-1]


def _adaptive(cfg: ModelConfig) -> bool:
    return cfg.ode.mode != "off" and cfg.ode.n_steps == 0


def _check_axes(mesh) -> Dict[str, int]:
    axes = mesh_axes(mesh)
    unknown = set(axes) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the rules name "
                         "'pod', 'data' and 'model'")
    return axes


def check_supported(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for what the port does not train on
    a mesh: adaptive control over several data ranks unless each rank
    solves its own rows (``ode.batch_axis='data'``)."""
    axes = _check_axes(mesh)
    ranks = math.prod(axes.get(a, 1) for a in ("pod", "data"))
    if (ranks > 1 and _adaptive(cfg) and cfg.ode.batch_axis != "data"):
        raise NotImplementedError(
            "adaptive step control (ode_steps=0) over several data ranks "
            "needs ode_batch_axis='data' (each rank's controller on its "
            "own rows); one controller over the global batch would reduce "
            f"the error norm over the group ({ADAPTIVE_ITEM})")


# ---------------------------------------------------------------------------
# FSDP: the per-layer gathers of the leaves split over 'data'
# ---------------------------------------------------------------------------

class _Fsdp:
    """One step's FSDP state: the data group, whether the rows are split
    over it (the gradients are then summed), each flattened leaf's data
    dimension, and the leaves of the running step registered by
    identity (strong references, so no id is reused while it is)."""

    def __init__(self, group: DataGroup, split: bool,
                 dims: List[Optional[int]]):
        self.group, self.split, self.dims = group, split, dims
        self.leaves: Dict[int, Tuple[torch.Tensor, int]] = {}
        self.cache: Dict[Tuple[int, int], weakref.ref] = {}

    def register(self, t: torch.Tensor, dim: int) -> None:
        self.leaves[id(t)] = (t, dim)

    def dim_of(self, t) -> Optional[int]:
        got = self.leaves.get(id(t))
        return None if got is None or got[0] is not t else got[1]

    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        return self.group.all_gather(shard.detach().movedim(dim, 0)
                                     ).movedim(0, dim).contiguous()

    def regather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf again for a backward, shared by the unpacks
        that need it while one of them still holds it."""
        key = (id(shard), dim)
        ref = self.cache.get(key)
        whole = ref() if ref is not None else None
        if whole is None:
            FSDP_GATHERS["backward"] += 1
            whole = self.gather(shard, dim)
            self.cache[key] = weakref.ref(whole)
        return whole


_FSDP: List[_Fsdp] = []


class _GatherData(torch.autograd.Function):
    """A leaf's 'data' shard all-gathered into its layer's whole leaf;
    the backward reduce-scatters the gradient into the shard (the rows
    split over the group) or takes the shard's block of it (every rank
    computed every row)."""

    @staticmethod
    def forward(ctx, shard, fsdp, dim):
        ctx.fsdp, ctx.dim = fsdp, dim
        FSDP_GATHERS["forward"] += 1
        return fsdp.gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        fsdp, d = ctx.fsdp, ctx.dim
        g = g.movedim(d, 0)
        if fsdp.split:
            g = fsdp.group.reduce_scatter(g)
        else:
            n = g.shape[0] // fsdp.group.size
            g = g[fsdp.group.rank * n:(fsdp.group.rank + 1) * n]
        return g.movedim(0, d).contiguous(), None, None


class _Packed(NamedTuple):
    """A saved view of a gathered leaf, kept as its shard."""
    shard: torch.Tensor
    dim: int
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


@contextlib.contextmanager
def fsdp_leaves(leaves: List[torch.Tensor]) -> Iterator[None]:
    """Inside a step's FSDP context, register the flattened parameter
    leaves the loss is computed from (in the plan's order) by identity,
    with their data dimensions; otherwise nothing."""
    if not _FSDP:
        yield
        return
    fsdp = _FSDP[-1]
    for t, d in zip(leaves, fsdp.dims):
        if d is not None:
            fsdp.register(t, d)
    try:
        yield
    finally:
        fsdp.leaves.clear()
        fsdp.cache.clear()


def fsdp_unbind(stacked: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``stacked.unbind(0)``; the periods of a registered leaf are
    registered too, each with its data dimension one lower."""
    parts = stacked.unbind(0)
    d = _FSDP[-1].dim_of(stacked) if _FSDP else None
    if d is not None:
        for part in parts:
            _FSDP[-1].register(part, d - 1)
    return parts


def _storage(t: torch.Tensor) -> Optional[int]:
    if torch._C._functorch.is_functorch_wrapped_tensor(t) or t.is_meta:
        return None
    return t.untyped_storage().data_ptr()


@contextlib.contextmanager
def fsdp_gathered(tree: Pytree) -> Iterator[Pytree]:
    """``tree`` with each registered leaf all-gathered over 'data' (once)
    for the ``with`` block, the forward of one layer. What autograd saves
    of a gathered leaf inside the block is packed as its shard and
    gathered again when a backward unpacks it, so no whole leaf outlives
    the block. Outside a step's FSDP context, ``tree`` itself."""
    fsdp = _FSDP[-1] if _FSDP else None
    leaves, spec = pytree.tree_flatten(tree)
    dims = [None if fsdp is None else fsdp.dim_of(t) for t in leaves]
    if all(d is None for d in dims):
        yield tree
        return
    whole: Dict[int, Tuple[torch.Tensor, int]] = {}
    out = []
    for t, d in zip(leaves, dims):
        if d is not None:
            w = _GatherData.apply(t, fsdp, d)
            whole[_storage(w)] = (t, d)
            t = w
        out.append(t)

    def pack(t):
        got = whole.get(_storage(t)) if torch.is_tensor(t) else None
        if got is None:
            return t
        return _Packed(got[0], got[1], tuple(t.shape), tuple(t.stride()),
                       t.storage_offset())

    def unpack(p):
        if not isinstance(p, _Packed):
            return p
        return fsdp.regather(p.shard, p.dim).as_strided(p.size, p.stride,
                                                        p.offset)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield pytree.tree_unflatten(out, spec)
    whole.clear()


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

Dims = Tuple[Tuple[int, Tuple[str, ...]], ...]


def _dims(spec, sizes: Dict[str, int]) -> Dims:
    """(dimension, its axes of size > 1) for each dimension ``spec``
    splits over ranks."""
    out = []
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        names = tuple(a for a in names if sizes.get(a, 1) > 1)
        if names:
            out.append((d, names))
    return tuple(out)


class _Leaf(NamedTuple):
    whole: Tuple[int, ...]      # the leaf's whole shape
    param: Dims                 # where the parameter is split
    opt: Dims                   # where its optimizer state is split


class ParamLayout:
    """Each parameter leaf's layout on a mesh by ``param_shardings`` (found
    by key path, from the config's whole shapes) and this rank's place in
    it: what a training plan (:class:`DataParallel`) and a serve plan
    (:class:`ServePlan`) share. With ``opt=True`` each leaf also carries
    its optimizer state's layout by ``opt_state_shardings`` (else the
    parameter's)."""

    def __init__(self, cfg: ModelConfig, mesh, opt: bool = False):
        from repro_torch.launch.specs import param_specs
        self.cfg, self.mesh = cfg, mesh
        self.sizes = sizes = _check_axes(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        meta = param_specs(cfg)
        p_sh = param_shardings(cfg, mesh, meta)
        o_sh = opt_state_shardings(cfg, mesh, p_sh, meta) if opt else p_sh
        self.by_path: Dict[Tuple[str, ...], _Leaf] = {}
        for (path, leaf), ps, os_ in zip(
                _pt.tree_flatten_with_path(meta)[0],
                _pt.tree_leaves(p_sh), _pt.tree_leaves(o_sh)):
            self.by_path[_path_names(path)] = _Leaf(
                tuple(leaf.shape), _dims(ps, sizes), _dims(os_, sizes))

    def layouts(self, tree: Pytree) -> List[_Leaf]:
        """Each leaf's layout, in ``tree``'s leaf order."""
        return [self.by_path[_path_names(path)]
                for path, _ in _pt.tree_flatten_with_path(tree)[0]]

    @staticmethod
    def fsdp_dim(lay: _Leaf) -> Optional[int]:
        """The dimension a leaf is split on over 'data' (FSDP), or None."""
        return next((d for d, names in lay.param if "data" in names), None)

    def _make_groups(self, extra) -> None:
        """Every group the plan uses, made now in one order on every rank:
        each axis, then ``extra``."""
        for names in [(a,) for a in self.mesh.mesh_dim_names] + list(extra):
            mesh_group(self.mesh, names)

    def _group(self, names) -> DataGroup:
        return mesh_group(self.mesh, names)

    def _index(self, names) -> Tuple[int, int]:
        """(this rank's block index, the number of blocks) over the axes
        ``names``, first axis major."""
        idx, n = 0, 1
        for a in names:
            idx = idx * self.sizes[a] + self.coord[a]
            n *= self.sizes[a]
        return idx, n

    def _narrow(self, t: torch.Tensor, dims: Dims) -> torch.Tensor:
        """The rank's block of ``t`` along each of ``dims`` (a view)."""
        for d, names in dims:
            idx, n = self._index(names)
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size)
        return t

    def param_shards(self, params: Pytree, copy: bool = True) -> Pytree:
        """The rank's block of each leaf of the whole ``params`` by
        ``param_shardings`` (copies, so the whole leaves can be freed;
        views with ``copy=False``)."""
        def one(path, t):
            # an empty leaf (an optimizer's placeholder) is never split
            dims = self.by_path[_path_names(path)].param if t.numel() else ()
            s = self._narrow(t, dims)
            return s.clone() if copy and dims else s
        return _pt.tree_map_with_path(one, params)

    @contextlib.contextmanager
    def _splitting(self, rows: Optional[DataGroup], model, fsdp_split: bool,
                   fsdp_dims: List[Optional[int]]) -> Iterator[None]:
        """Inside the block the loss and the MoE see rows split over
        ``rows`` (:func:`row_split`), the layers split over ``model``, and
        the flattened leaves with a dimension in ``fsdp_dims`` are gathered
        over 'data' per layer (their gradients reduce-scattered where
        ``fsdp_split``, the rows being split over 'data')."""
        data = self._group(("data",))
        fsdp = (_Fsdp(data, fsdp_split, fsdp_dims)
                if data is not None and any(d is not None for d in fsdp_dims)
                else None)
        if rows is not None:
            _ROW_SPLITS.append(rows)
        if fsdp is not None:
            _FSDP.append(fsdp)
        try:
            with splitting_model(model):
                yield
        finally:
            if fsdp is not None:
                _FSDP.pop()
            if rows is not None:
                _ROW_SPLITS.pop()


class DataParallel(ParamLayout):
    """A training step's plan on a mesh: each parameter leaf's layout by
    ``param_shardings`` and its optimizer state's by
    ``opt_state_shardings`` (:class:`ParamLayout`), the rows' group, and
    the collectives that execute them. Every rank of the mesh builds the
    same plan and calls its collective methods in the same order.
    ``params`` is any tree of the model's parameters (whole or the rank's
    shards) in the caller's leaf order."""

    def __init__(self, cfg: ModelConfig, mesh, params: Pytree):
        check_supported(cfg, mesh)
        super().__init__(cfg, mesh, opt=True)
        sizes = self.sizes
        self.leaves: List[_Leaf] = self.layouts(params)
        for leaf in self.leaves:
            if not set(leaf.param) <= set(leaf.opt):
                raise ValueError(f"optimizer layout {leaf.opt} does not "
                                 f"refine the parameter's {leaf.param}")
        self.dims: List[Optional[int]] = [
            leaf.opt[0][0] if leaf.opt else None for leaf in self.leaves]
        self.fsdp_dims: List[Optional[int]] = [
            self.fsdp_dim(leaf) for leaf in self.leaves]
        # the rows', the ZeRO-1 sets, the whole mesh
        self.row_axes = self._row_axes(None)
        self._make_groups([self.row_axes, dp_axes(mesh)]
                          + sorted({names for leaf in self.leaves
                                    for _, names in leaf.opt})
                          + [tuple(mesh.mesh_dim_names)])
        self.group = (mesh_group(mesh, self.row_axes)
                      or mesh_group(mesh, ("data",))
                      or DataGroup("data", *axis_group(mesh, "data")))
        self.world = mesh_group(mesh, tuple(mesh.mesh_dim_names))
        tp = (cfg.sharding != "dp" and sizes.get("model", 1) > 1)
        self.model = mesh_group(mesh, ("model",)) if tp else None

    @property
    def n_sharded(self) -> int:
        """How many leaves have their optimizer state sharded."""
        return sum(d is not None for d in self.dims)

    @property
    def n_fsdp(self) -> int:
        """How many leaves are split over 'data' (gathered per layer)."""
        return sum(d is not None for d in self.fsdp_dims)

    def _gather(self, t: torch.Tensor, dims: Dims) -> torch.Tensor:
        for d, names in dims:
            t = self._group(names).all_gather(t.movedim(d, 0)).movedim(0, d)
        return t.contiguous()

    # -- rows ---------------------------------------------------------------

    def _row_axes(self, batch) -> Tuple[str, ...]:
        """The axes (of size > 1) the batch's rows are split over: the
        lead of ``batch_shardings``, without 'model' under adaptive
        control."""
        if batch is None:
            # the rule's first choice, for a batch that divides
            axes = dp_axes(self.mesh) + (
                ("model",) if self.cfg.sharding == "dp" else ())
        else:
            lead = _pt.tree_leaves(batch_shardings(self.cfg, self.mesh,
                                                   batch))[0][0]
            axes = (lead,) if isinstance(lead, str) else (lead or ())
        if _adaptive(self.cfg):
            axes = tuple(a for a in axes if a != "model")
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def local_rows(self, batch: Pytree, microbatches: int = 1
                   ) -> Tuple[Pytree, Optional[DataGroup]]:
        """(this rank's rows of the global ``batch``, the group they are
        split over or None). Block r of each microbatch; every row on
        every rank when ``batch_shardings`` replicates the batch or a
        microbatch does not divide over the ranks."""
        names = self._row_axes(batch)
        if not names:
            return batch, None
        idx, n_split = self._index(names)
        per_mb = pytree.tree_leaves(batch)[0].shape[0] // microbatches
        if per_mb % n_split:
            return batch, None
        b = per_mb // n_split

        def rows(a):
            a = a.reshape(microbatches, per_mb, *a.shape[1:])
            return a[:, idx * b:(idx + 1) * b].reshape(
                microbatches * b, *a.shape[2:])

        return pytree.tree_map(rows, batch), self._group(names)

    @contextlib.contextmanager
    def splitting_rows(self, split=True) -> Iterator[None]:
        """Inside the block (forward and backward), the loss and the MoE
        see rows split over ``split`` (a group from :meth:`local_rows`;
        True: the plan's rows' group) (:func:`row_split`)."""
        if not split:
            yield
            return
        _ROW_SPLITS.append(self.group if split is True else split)
        try:
            yield
        finally:
            _ROW_SPLITS.pop()

    @contextlib.contextmanager
    def computing(self, split) -> Iterator[None]:
        """Where a step computes its loss and gradients from the rank's
        parameter shards: the rows split over ``split``, the layers
        split over 'model', the 'data' shards gathered per layer."""
        with self._splitting(split, self.model,
                             split is not None and "data" in split.axes,
                             self.fsdp_dims):
            yield

    # -- leaves ---------------------------------------------------------------

    def _zip(self, tree: Pytree):
        """(leaves, spec, layouts) of a params-shaped tree; an empty leaf
        (the optimizer's placeholder for a state it does not keep) is
        never split."""
        leaves, spec = pytree.tree_flatten(tree)
        return leaves, spec, [
            _Leaf(lay.whole, (), ()) if t.numel() == 0 else lay
            for t, lay in zip(leaves, self.leaves)]

    def shard(self, tree: Pytree) -> Pytree:
        """This rank's block of each leaf of a whole params-shaped tree in
        the optimizer state's layout (views)."""
        leaves, spec, lays = self._zip(tree)
        return pytree.tree_unflatten(
            [self._narrow(t, lay.opt) for t, lay in zip(leaves, lays)], spec)

    def param_to_opt(self, params: Pytree) -> Pytree:
        """The rank's parameter shards cut to the optimizer state's
        layout (views; ZeRO-1 cuts a replicated leaf)."""
        leaves, spec, lays = self._zip(params)
        return pytree.tree_unflatten(
            [self._narrow(t, tuple(x for x in lay.opt
                                   if x not in lay.param))
             for t, lay in zip(leaves, lays)], spec)

    def opt_to_param(self, tree: Pytree) -> Pytree:
        """The rank's parameter shards from their optimizer-state
        blocks (an all-gather where ZeRO-1 cut finer)."""
        leaves, spec, lays = self._zip(tree)
        return pytree.tree_unflatten(
            [self._gather(t, tuple(x for x in lay.opt if x not in lay.param))
             if len(lay.opt) > len(lay.param) else t
             for t, lay in zip(leaves, lays)], spec)

    def gather_params(self, params: Pytree, host: bool = False) -> Pytree:
        """The whole leaves from the rank's parameter shards."""
        return self._gather_tree(params, "param", host)

    def gather(self, tree: Pytree, host: bool = False) -> Pytree:
        """The whole leaves of a tree in the optimizer state's layout.
        ``host=True`` moves each leaf to the host as soon as it is whole
        (a checkpoint holds one whole leaf at a time on the device)."""
        return self._gather_tree(tree, "opt", host)

    def _gather_tree(self, tree: Pytree, layout: str, host: bool) -> Pytree:
        leaves, spec, lays = self._zip(tree)
        out = []
        for t, lay in zip(leaves, lays):
            dims = getattr(lay, layout)
            if dims:
                t = self._gather(t, dims)
            out.append(t.cpu() if host else t)
        return pytree.tree_unflatten(out, spec)

    def whole_like(self, tree: Pytree) -> Pytree:
        """Uninitialised host tensors of the whole leaves' shapes and
        dtypes (a restore template)."""
        leaves, spec, lays = self._zip(tree)
        return pytree.tree_unflatten(
            [torch.empty(lay.whole if t.numel() else t.shape, dtype=t.dtype)
             for t, lay in zip(leaves, lays)], spec)

    def reduce_grads(self, grads: Pytree, split=None) -> Pytree:
        """The global gradient, each leaf in its optimizer state's layout,
        from the rank's gradients of its parameter shards: summed over the
        rows' axes (``split``, the group of :meth:`local_rows`; None:
        every rank computed every row, nothing is summed), reduce-
        scattered where ZeRO-1 cuts a replicated leaf. A leaf split over
        'data' arrives already reduce-scattered over 'data' (FSDP's
        gather backward)."""
        rows = split.axes if split is not None else ()
        leaves, spec, lays = self._zip(grads)
        out = []
        for g, lay, fsdp in zip(leaves, lays, self.fsdp_dims):
            todo = [a for a in rows if not (fsdp is not None and a == "data")]
            extra = tuple(x for x in lay.opt if x not in lay.param)
            if extra and todo:
                (d, names), = extra
                cut = [a for a in names if a in todo]
                other = [a for a in todo if a not in names]
                left = [a for a in names if a not in todo]
                if cut and left and names.index(left[0]) < names.index(
                        cut[-1]):
                    raise ValueError(f"ZeRO-1 axes {names} against rows "
                                     f"{rows}")
                if cut:
                    g = self._group(cut).reduce_scatter(
                        g.movedim(d, 0)).movedim(0, d)
                if other:
                    g = self._group(other).all_reduce(g)
                if left:
                    g = self._narrow(g, ((d, tuple(left)),))
            else:
                if todo:
                    g = self._group(todo).all_reduce(g)
                g = self._narrow(g, extra)
            out.append(g.contiguous())
        return pytree.tree_unflatten(out, spec)

    def _counts_here(self, lay: _Leaf) -> bool:
        """Whether this rank counts a leaf's optimizer-layout block in a
        sum over the mesh: its coordinate is 0 on every axis the block
        is replicated over."""
        split = {a for _, names in lay.opt for a in names}
        return all(self.coord[a] == 0 for a, n in self.sizes.items()
                   if n > 1 and a not in split)

    def global_norm(self, grads: Pytree) -> torch.Tensor:
        """``optim.optimizer.global_norm`` of the global gradient, from
        ``grads`` in the layout :meth:`reduce_grads` gives: the leaves'
        float32 sums of squares (each block counted on one rank) summed
        over the mesh in one collective, then added leaf by leaf in tree
        order."""
        leaves, _, lays = self._zip(grads)
        sq = torch.stack([
            torch.sum(torch.square(g.float())) if self._counts_here(lay)
            else g.new_zeros((), dtype=torch.float32)
            for g, lay in zip(leaves, lays)])
        sq = self.world.all_reduce(sq)
        total = sq[0]
        for i in range(1, len(leaves)):
            total = total + sq[i]
        return torch.sqrt(total)

    def max_over_ranks(self, values: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Per-leaf 0-d maxima over the mesh, in one collective."""
        return list(self.world.all_reduce(torch.stack(values),
                                          op=dist.ReduceOp.MAX).unbind(0))

    def checksum_equal(self, params: Pytree) -> bool:
        """Whether every rank of the mesh holds the same (whole)
        parameters: each leaf's float64 sum and sum of squares,
        all-gathered and compared."""
        sums = torch.stack([torch.stack([
            torch.sum(p, dtype=torch.float64),
            torch.sum(torch.square(p.float()), dtype=torch.float64)])
            for p in pytree.tree_leaves(params)]).reshape(1, -1)
        every = self.world.all_gather(sums)
        return bool(torch.equal(every, sums.expand_as(every)))


# (cfg, mesh, the parameters' key paths) -> their plan: made once, then
# shared by the Trainer and every step
_PLANS: Dict[tuple, DataParallel] = {}
_MAX_PLANS = 8


def plan_for(cfg: ModelConfig, mesh, params: Pytree
             ) -> Optional[DataParallel]:
    """The plan of a mesh of several ranks, None for one rank (or no
    mesh). Made once for each config, mesh and parameter tree, then
    reused."""
    if mesh is None or mesh.size() <= 1:
        return None
    key = (cfg, mesh, tuple(_path_names(path) for path, _ in
                            _pt.tree_flatten_with_path(params)[0]))
    if key not in _PLANS:
        if len(_PLANS) >= _MAX_PLANS:
            del _PLANS[next(iter(_PLANS))]
        _PLANS[key] = DataParallel(cfg, mesh, params)
    return _PLANS[key]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

_LSTM_FIELDS = ("c", "n", "m", "h")
# a Mamba cache leaf's d_inner dimension (without the period dimension):
# the only one the serve path splits its compute on
_MAMBA_D_INNER = {"conv": 3, "ssm": 2}


def _check_servable(names: Tuple[str, ...], spec, sizes) -> None:
    """Raise ``NotImplementedError`` for a cache leaf that the rule splits
    over 'model' (off its batch dimension) where the serve path computes
    whole (module docstring)."""
    core = spec[1:] if "period" in names else spec
    at = [d for d, e in enumerate(core) if d > 1 and sizes.get("model", 1) > 1
          and "model" in ((e,) if isinstance(e, str) else (e or ()))]
    if not at:
        return
    field = names[-1]
    if field in _LSTM_FIELDS:
        raise NotImplementedError(
            f"serving an xLSTM on a mesh whose 'model' axis splits its LSTM "
            f"caches ({'/'.join(names)}: {spec}): the rule replicates the "
            f"LSTM weights, so each rank would compute every head and keep "
            f"a block of the state ({SERVE_ITEM}); serve it under a data "
            "split alone")
    if field in _MAMBA_D_INNER and at != [_MAMBA_D_INNER[field]]:
        raise NotImplementedError(
            f"a Mamba cache split over 'model' off its d_inner dimension "
            f"({'/'.join(names)}: {spec}; {SERVE_ITEM})")


class ServePlan(ParamLayout):
    """A serve step's layout on a mesh (module docstring): each parameter
    leaf's block by ``param_shardings`` (:class:`ParamLayout`), each cache
    leaf's by ``cache_shardings`` at the global ``batch``, the rows, and
    the groups that run the layers' collectives. Every rank of the mesh
    builds the same plan. Raises ``ValueError`` where ``cache_shardings``
    does (a spec naming an axis twice) and ``NotImplementedError`` for the
    caches of :data:`SERVE_ITEM`."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int):
        from repro_torch.launch.specs import META
        from repro_torch.models.transformer import init_cache
        super().__init__(cfg, mesh)
        sizes, self.batch = self.sizes, batch
        # the caches' layout off the sequence dimension does not depend
        # on its length
        cache = init_cache(cfg, batch, 1, META)
        for (path, _), spec in zip(
                _pt.tree_flatten_with_path(cache)[0],
                _pt.tree_leaves(cache_shardings(cfg, mesh, cache, batch))):
            _check_servable(_path_names(path), spec, sizes)
        lead = _cache_batch_axes(cfg, mesh, batch) or ()
        self.row_axes = tuple(a for a in lead if sizes[a] > 1)
        self._make_groups([self.row_axes])
        self.rows = mesh_group(mesh, self.row_axes)
        model = mesh_group(mesh, ("model",))
        # the weights' split (MLP, MoE, embedding, head), and the caches'
        # (attention, Mamba): a pure-DP config's caches split over 'model'
        # unless its batch is
        self.model = model if cfg.sharding != "dp" else None
        self.tp = model if "model" not in self.row_axes else None
        self.data = mesh_group(mesh, ("data",))

    # -- parameters ---------------------------------------------------------

    def cut(self, names: Tuple[str, ...], t: torch.Tensor,
            period: bool = False) -> torch.Tensor:
        """The rank's block of the leaf at key path ``names`` (a copy;
        ``period=True``: ``t`` is one period of a period-stacked leaf,
        whose stacked dimension is never split)."""
        dims = self.by_path[names].param
        if period:
            dims = tuple((d - 1, a) for d, a in dims)
        return self._narrow(t, dims).clone() if dims else t

    def check_params(self, params: Pytree) -> None:
        """Raise ``ValueError`` unless ``params`` holds this rank's blocks
        (a whole tree passed by mistake would be summed over 'model')."""
        for path, t in _pt.tree_flatten_with_path(params)[0]:
            names = _path_names(path)
            want = list(self.by_path[names].whole)
            for d, axes in self.by_path[names].param:
                want[d] //= self._index(axes)[1]
            if list(t.shape) != want:
                raise ValueError(
                    f"serving on a mesh takes the rank's parameter shards "
                    f"(ServePlan.param_shards): {'/'.join(names)} has shape "
                    f"{tuple(t.shape)}, its shard {tuple(want)}")

    # -- caches and rows ----------------------------------------------------

    def cache_shape(self, name: str, shape: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
        """The rank's block of a cache leaf (field ``name``, whole shape
        ``shape`` without a period dimension)."""
        spec = cache_leaf_spec(self.cfg, self.mesh, name, tuple(shape),
                               self.batch)
        return local_shape(spec, shape, self.mesh)

    def local_rows(self, tree: Pytree) -> Pytree:
        """This rank's rows of a tree of global-batch leaves."""
        if self.rows is None:
            return tree
        idx, n = self._index(self.row_axes)
        b = self.batch // n
        return pytree.tree_map(lambda a: a[idx * b:(idx + 1) * b], tree)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' rows of ``t`` put together: the global batch."""
        return t if self.rows is None else self.rows.all_gather(t)

    # -- the step -----------------------------------------------------------

    @contextlib.contextmanager
    def computing(self, params: Pytree) -> Iterator[None]:
        """Where a serve step runs on the rank's shards ``params``: the
        rows split over the caches' batch axes, the layers over 'model',
        each layer's 'data' shards gathered once (and freed after it)."""
        dims = [self.fsdp_dim(lay) for lay in self.layouts(params)]
        with self._splitting(self.rows, self.model, False, dims), \
                serving(self.tp, self.data), \
                fsdp_leaves(_pt.tree_leaves(params)):
            yield


# (cfg, mesh, batch) -> its serve plan, made once
_SERVE_PLANS: Dict[tuple, ServePlan] = {}


def serve_plan_for(cfg: ModelConfig, mesh, batch: int
                   ) -> Optional[ServePlan]:
    """The serve plan of a mesh of several ranks at the global ``batch``,
    None for one rank (or no mesh). Made once, then reused."""
    if mesh is None or mesh.size() <= 1:
        return None
    key = (cfg, mesh, batch)
    if key not in _SERVE_PLANS:
        if len(_SERVE_PLANS) >= _MAX_PLANS:
            del _SERVE_PLANS[next(iter(_SERVE_PLANS))]
        _SERVE_PLANS[key] = ServePlan(cfg, mesh, batch)
    return _SERVE_PLANS[key]


__all__ = ["COLLECTIVES", "HOST_STAGED", "FSDP_GATHERS", "DataGroup",
           "DataParallel", "ParamLayout", "check_supported",
           "collective_counts",
           "fsdp_gathered", "fsdp_leaves", "fsdp_unbind", "mesh_group",
           "plan_for", "reset_collective_counts", "row_split",
           "solves_per_shard", "ServePlan", "serve_plan_for", "SERVE_ITEM"]
