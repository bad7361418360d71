"""Sharding rules, the ambient device mesh and the collectives of
``Sharded`` batching.

**Rules.** The port of the JAX package's ``repro.distributed.sharding``
rules, decision for decision: :func:`param_shardings`,
:func:`batch_shardings`, :func:`zero1_sharding` and
:func:`opt_state_shardings` are pure functions of the model config, the
mesh's axis names and sizes, and each leaf's key path and shape. They
return trees of :class:`Spec`, the counterpart of ``PartitionSpec``: per
dimension ``None``, an axis name or a tuple of names. A mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
or a plain ``{axis name: size}`` dict (tests and planning). Strategies
(``ModelConfig.sharding``):

* ``'dp'`` — pure data parallel: parameters replicated, the batch over
  every mesh axis (``'model'`` included) when divisible, the optimizer
  state ZeRO-1 sharded (:func:`zero1_sharding`);
* ``'tp'`` — weights over ``'model'`` only;
* ``'fsdp_tp'`` — the same ``'model'`` sharding plus the complementary
  large dimension over ``'data'``.

Every rule is divisibility-guarded: a dimension is sharded only if the
axis size divides it. A spec over an axis of size 1 is still a spec, not
``None``: on a (W, 1) host mesh a ``'tp'`` leaf is "sharded" over
``'model'``, so its optimizer state inherits the parameter's layout and
is not ZeRO-1'd, as in the JAX package. What the port executes of these
layouts, and how, is :mod:`repro_torch.distributed.data_parallel` (the
rows, the gradients, the shards and FSDP's gathers) and
:mod:`repro_torch.distributed.tensor_parallel` (the layers' collectives
over ``'model'``). :func:`cache_shardings` is the serve caches' rule;
:func:`shard_bytes` reckons what a rank holds under a spec tree.

The JAX package's activation ``hint`` (a ``with_sharding_constraint``
that pins where GSPMD places an activation) has no counterpart, nor have
the helpers only its hints call (``replicated``, ``model_axis_size`` and
its ``REPRO_NO_HINTS`` switch): the port's layers place their
activations themselves, by the conjugate collectives below, at the
points where the JAX package hints, and read the 'model' group from
:func:`repro_torch.distributed.tensor_parallel.model_split`.

**Ambient mesh and ``Sharded``.** The JAX package finds its mesh through
``with mesh:`` and splits a batch with ``shard_map(in_specs=(P(),
P(axis)), out_specs=P(axis))``: inputs replicated, outputs sharded over
the axis. The port does the same over a ``DeviceMesh``
(:func:`repro_torch.launch.mesh.make_host_mesh`): ``with mesh:`` makes it
ambient (:func:`ambient_mesh`); each rank takes its slice of the rows of
a replicated input; :func:`gather_rows` puts the whole batch back on
every rank, its backward taking the rank's own slice of the cotangent;
and :func:`mark_replicated` marks a replicated input, its backward
summing the ranks' cotangents. The gradient of a loss of the gathered
output is then the unsharded solve's on every rank. A mesh dimension of
size 1 makes every one of these the identity, with no collective.

**Conjugate collectives.** :class:`_Replicated` (identity forward, the
cotangent summed over the group) and :class:`_Summed` (the sum over the
group forward, identity backward) are Megatron's f and g: an activation
that every rank of a group holds whole enters a split computation
through f, and the ranks' partial results leave it through g. Each
takes either a raw process group or a
:class:`~repro_torch.distributed.data_parallel.DataGroup` (which counts
the collective), and each works under ``torch.func`` transforms
(MALI's backward runs the dynamics under ``torch.func.vjp``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as _pt

from repro_torch.configs.base import ModelConfig

Pytree = Any


class Spec(tuple):
    """A partition spec: one entry per leading dimension, ``None``
    (replicated), an axis name, or a tuple of axis names. A one-name tuple
    is stored as the name, as ``PartitionSpec`` stores it. A tree leaf of
    its own (torch's pytree does not descend into a tuple subclass)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or of such a dict."""
    if isinstance(mesh, dict):
        return mesh
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _maybe(dim: int, axis: Optional[str], mesh) -> Optional[str]:
    """Shard ``dim`` over ``axis`` only if divisible."""
    if axis is None or axis not in mesh_axes(mesh):
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _leaf_spec(cfg: ModelConfig, mesh, path: Tuple[str, ...],
               shape: Tuple[int, ...]) -> Spec:
    if cfg.sharding == "dp":
        return Spec()
    fsdp = cfg.sharding == "fsdp_tp"
    data = "data" if fsdp else None
    name = path[-1]

    # xLSTM mixers: replicated (125M: data parallelism only)
    if name in ("w_i", "w_f", "f_bias", "r_in", "out_norm") or \
            (name in ("w_up", "w_q", "w_k", "w_v", "w_down", "w_in", "bias")
             and _in_lstm_path(cfg, path)):
        return Spec()

    if len(shape) <= 1:
        return Spec()  # norms, biases, scalars

    if name in ("embed", "head"):
        return Spec(_maybe(shape[0], data, mesh),
                    _maybe(shape[1], "model", mesh))

    # attention: the fused (H*dh) dimension only on whole heads; K/V
    # projections replicated on 'model' where kv_heads do not divide it
    if name == "wq":
        ok = cfg.n_heads % _axis_size(mesh, "model") == 0
        return Spec(_maybe(shape[0], data, mesh),
                    _maybe(shape[1], "model", mesh) if ok else None)
    if name in ("wk", "wv"):
        ok = cfg.n_kv_heads % _axis_size(mesh, "model") == 0
        return Spec(_maybe(shape[0], data, mesh),
                    _maybe(shape[1], "model", mesh) if ok else None)
    if name == "wo":
        return Spec(_maybe(shape[0], "model", mesh),
                    _maybe(shape[1], data, mesh))

    # dense mlp
    if name in ("w_gate", "w_up") and len(shape) == 2:
        return Spec(_maybe(shape[0], data, mesh),
                    _maybe(shape[1], "model", mesh))
    if name == "w_down" and len(shape) == 2:
        return Spec(_maybe(shape[0], "model", mesh),
                    _maybe(shape[1], data, mesh))

    # moe experts [E, D, F] / [E, F, D]
    if name in ("w_gate", "w_up") and len(shape) == 3:
        ep = _maybe(shape[0], "model", mesh)
        if ep:
            return Spec(ep, _maybe(shape[1], data, mesh), None)
        return Spec(None, _maybe(shape[1], data, mesh),
                    _maybe(shape[2], "model", mesh))
    if name == "w_down" and len(shape) == 3:
        ep = _maybe(shape[0], "model", mesh)
        if ep:
            return Spec(ep, None, _maybe(shape[2], data, mesh))
        return Spec(None, _maybe(shape[1], "model", mesh),
                    _maybe(shape[2], data, mesh))
    if name == "router":
        return Spec()

    # mamba
    if name == "in_proj":
        return Spec(_maybe(shape[0], data, mesh),
                    _maybe(shape[1], "model", mesh))
    if name in ("conv_w", "dt_proj"):
        return Spec(None, _maybe(shape[1], "model", mesh))
    if name in ("x_proj", "A_log"):
        return Spec(_maybe(shape[0], "model", mesh), None)
    if name == "out_proj":
        return Spec(_maybe(shape[0], "model", mesh),
                    _maybe(shape[1], data, mesh))

    return Spec()


def _in_lstm_path(cfg: ModelConfig, path: Tuple[str, ...]) -> bool:
    """True if this parameter belongs to an mLSTM/sLSTM mixer (any layer
    spec of the config uses those mixers and the path is a mixer's)."""
    if "mixer" not in path:
        return False
    return any(spec.mixer in ("mlstm", "slstm")
               for spec in cfg.prelude + cfg.period)


def _path_names(path) -> Tuple[str, ...]:
    """A key path (torch's or JAX's key entries) as names: dict keys,
    attribute names, sequence indices."""
    names = []
    for p in path:
        if hasattr(p, "key"):
            names.append(str(p.key))
        elif hasattr(p, "name"):
            names.append(str(p.name))
        elif hasattr(p, "idx"):
            names.append(str(p.idx))
    return tuple(names)


def param_shardings(cfg: ModelConfig, mesh, params_like: Pytree) -> Pytree:
    """The :class:`Spec` tree of ``params_like`` (any leaves with a
    ``shape``)."""

    def one(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        # scanned-period parameters carry a leading n_periods dimension:
        # the rule applies to the per-layer shape, the stack replicated
        if "period" in names:
            spec = Spec(None, *_leaf_spec(cfg, mesh, names, shape[1:]))
        else:
            spec = _leaf_spec(cfg, mesh, names, shape)
        if len(spec) > len(shape):
            spec = Spec(*spec[:len(shape)])
        return spec

    return _pt.tree_map_with_path(one, params_like)


def batch_shardings(cfg: ModelConfig, mesh, batch_like: Pytree) -> Pytree:
    """Each batch leaf's leading dimension over the data axes (pure-DP
    configs over the otherwise idle 'model' axis too) when divisible."""
    candidates = []
    if cfg.sharding == "dp":
        candidates.append(dp_axes(mesh) + ("model",))
    candidates.append(dp_axes(mesh))

    def one(leaf):
        shape = tuple(leaf.shape)
        lead = None
        for axes in candidates:
            total = 1
            for a in axes:
                total *= _axis_size(mesh, a)
            if total > 1 and shape[0] % total == 0:
                lead = axes
                break
        return Spec(lead, *([None] * (len(shape) - 1)))

    return _pt.tree_map(one, batch_like)


def _cache_batch_axes(cfg: ModelConfig, mesh, batch: int
                      ) -> Optional[Tuple[str, ...]]:
    """The axes a serve cache's batch dimension is split over (the data
    axes, for pure-DP configs 'model' too when the batch divides them
    all), or None when the batch does not divide them."""
    dp = dp_axes(mesh)
    if cfg.sharding == "dp":
        full = dp + ("model",)
        if batch % max(math.prod(_axis_size(mesh, a) for a in full), 1) == 0:
            dp = full
    dp_total = math.prod(_axis_size(mesh, a) for a in dp)
    return dp if batch % max(dp_total, 1) == 0 and dp_total > 1 else None


def cache_leaf_spec(cfg: ModelConfig, mesh, name: str,
                    core: Tuple[int, ...], batch: int) -> Spec:
    """The spec of one serve-cache leaf without a period dimension:
    ``name`` is its field (``'k'``/``'v'`` of a KV cache [slots, B, S, K,
    dh]; Mamba's ``'conv'``/``'ssm'``; the LSTMs' ``'c'``/``'n'``/``'m'``/
    ``'h'``), ``core`` its shape. Raises ``ValueError`` where the spec
    would name one mesh axis twice (a pure-DP batch over 'model', and
    'model' again on the heads or ``d_head``), as ``NamedSharding``
    refuses such a spec in the JAX package."""
    names_of_mesh = mesh_axes(mesh)
    lead = _cache_batch_axes(cfg, mesh, batch)
    # KV leaves are the 'k'/'v' fields, [slots, B, S, K, dh]; the
    # recurrent states (Mamba's conv/ssm, the LSTMs' c/n/m/h) have no
    # sequence dimension to split
    is_kv = name in ("k", "v") and len(core) == 5

    def fits(dim_size, axis):
        sz = _axis_size(mesh, axis)
        return sz > 1 and dim_size % sz == 0

    spec: list = [None] * len(core)
    if len(core) >= 2 and lead is not None:
        spec[1] = lead
    elif is_kv and "data" in names_of_mesh and fits(core[2], "data"):
        spec[2] = "data"
    if "model" in names_of_mesh:
        for d in range(3 if is_kv else 2, len(core)):
            if spec[d] is None and fits(core[d], "model"):
                spec[d] = "model"
                break
    used = [a for e in spec
            for a in ((e,) if isinstance(e, str) else (e or ()))]
    twice = sorted({a for a in used if used.count(a) > 1})
    if twice:
        raise ValueError(
            f"cache leaf {name!r} {tuple(core)} at batch {batch}: the spec "
            f"{Spec(*spec)} maps mesh axes {twice} to more than one "
            "dimension (a NamedSharding spec maps each mesh axis to at "
            "most one dimension)")
    return Spec(*spec)


def cache_shardings(cfg: ModelConfig, mesh, cache_like: Pytree,
                    batch: int) -> Pytree:
    """The serve caches' specs (:func:`cache_leaf_spec` for each leaf; a
    period-stacked leaf's leading ``n_periods`` dimension replicated):
    the batch dimension over the data axes when it divides (pure-DP
    configs over 'model' too); otherwise (long-context, batch 1) a KV
    cache's sequence dimension over 'data' (flash-decoding's split KV);
    then the widest model-side dimension that divides over 'model',
    scanning from the heads outward (for a KV cache the sequence
    dimension is kept for 'data'). Raises ``ValueError`` where a spec
    would name one mesh axis twice, as the JAX package's does."""

    def one(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        # period-stacked caches have a leading n_periods dimension
        lead = "period" in names
        spec = cache_leaf_spec(cfg, mesh, names[-1] if names else "",
                               shape[1:] if lead else shape, batch)
        return Spec(None, *spec) if lead else spec

    return _pt.tree_map_with_path(one, cache_like)


def local_shape(spec, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec``."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[d] //= axes.get(a, 1)
    return tuple(out)


def spec_ways(spec, mesh) -> int:
    """Into how many blocks ``spec`` cuts a leaf on ``mesh``."""
    axes = mesh_axes(mesh)
    n = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n *= axes.get(a, 1)
    return n


def shard_bytes(specs: Pytree, like: Pytree, mesh, dtype=None) -> int:
    """The bytes one rank holds of ``like``'s leaves (any leaves with a
    shape and a dtype, meta tensors included) laid out by the matching
    ``specs`` tree: each leaf's bytes over the blocks its spec cuts it
    into. ``dtype`` replaces the leaves' own (the optimizer's moments
    and master copy)."""
    total = 0
    for spec, leaf in zip(_pt.tree_leaves(specs), _pt.tree_leaves(like)):
        dt = dtype or leaf.dtype
        size = torch.empty((), dtype=dt).element_size()
        total += leaf.numel() * size // spec_ways(spec, mesh)
    return total


def ambient_mesh():
    """The mesh of the innermost active ``with mesh:`` context, or
    None."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = getattr(_mesh_resources, "mesh_stack", [])
    return stack[-1] if stack else None


def zero1_sharding(mesh, leaf) -> Spec:
    """ZeRO-1 spec for the optimizer state of a replicated parameter: the
    largest dimension divisible by ('data', 'model') (then 'data', then
    'model'; a tie to the lower index) over those axes, for leaves of at
    least 2^16 elements; else replicated."""
    shape = tuple(leaf.shape)
    size = 1
    for d in shape:
        size *= d
    if not shape or size < (1 << 16):
        return Spec()
    names = mesh_axes(mesh)
    for axes in (("data", "model"), ("data",), ("model",)):
        if not all(a in names for a in axes):
            continue
        total = 1
        for a in axes:
            total *= _axis_size(mesh, a)
        best = -1
        for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[d] % total == 0:
                best = d
                break
        if best >= 0:
            spec = [None] * len(shape)
            spec[best] = axes
            return Spec(*spec)
    return Spec()


def opt_state_shardings(cfg: ModelConfig, mesh, p_sh: Pytree,
                        params_like: Pytree) -> Pytree:
    """Optimizer-state specs: a sharded parameter's own spec; ZeRO-1 for
    a replicated one."""
    def one(sh, leaf):
        if any(ax is not None for ax in sh):
            return sh
        return zero1_sharding(mesh, leaf)

    return _pt.tree_map(one, p_sh, params_like)


# ---------------------------------------------------------------------------
# The row collectives of Sharded batching
# ---------------------------------------------------------------------------

def _plain(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under ``torch.func``'s wrappers (a collective
    needs a data pointer)."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def _sum_over(group, t: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group`` (a DataGroup, which
    counts the call, or a raw process group)."""
    t = _plain(t)
    if hasattr(group, "all_reduce"):
        return group.all_reduce(t)
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group
    (Megatron's f: a whole activation entering computations split over
    the group, each rank's cotangent a partial one)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _sum_over(ctx.group, g), None


class _Summed(_Replicated):
    """The conjugate of :class:`_Replicated`: the sum over the group
    forward, identity backward (Megatron's g: the ranks' partial results
    leaving a split computation, whole on every rank after it)."""

    @staticmethod
    def forward(x, group):
        return _sum_over(group, x)

    @staticmethod
    def backward(ctx, g):
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


def mark_replicated(x: torch.Tensor, group, size: int) -> torch.Tensor:
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


__all__ = ["Spec", "mesh_axes", "dp_axes", "param_shardings",
           "batch_shardings", "cache_shardings", "zero1_sharding",
           "opt_state_shardings", "ambient_mesh", "spec_ways",
           "shard_bytes", "cache_leaf_spec", "local_shape",
           "mark_replicated", "gather_rows", "axis_group"]
