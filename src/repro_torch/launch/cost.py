"""The op cost counter: FLOPs and bytes of a step, on any device.

The port's counterpart of the JAX package's ``repro.launch.hlo_cost``.
There is no HLO to parse: :class:`OpCounter` is a ``TorchDispatchMode``
that counts every aten op a step dispatches, on meta, CPU or CUDA
tensors, by ``hlo_cost.py``'s rules restated for eager PyTorch:

  flops
    products (mm, addmm, bmm, baddbmm, convolution, the SDPA kernels)
              ``torch.utils.flop_counter``'s formulas, 2 * prod(result)
              * contracted; bf16/f16 operands count on the tensor cores
              (class ``"bf16"``), any other as ``"f32"``
    pointwise ops (``torch.Tag.pointwise``)       prod(result)
    reductions (``torch.Tag.reduction``, softmax)  prod(operand)
    copies and casts (clone, copy_, _to_copy, fill_)  none
  bytes
    operand + result bytes of each op: eager PyTorch runs one kernel an
    op, each reading its inputs from HBM and writing its outputs there.
    Views, metadata and allocations are free. Dtype casts are real
    kernels here, so their bytes count (XLA fuses its ``convert``).

A kernel op of ``repro_torch.kernels`` counts its declared work
(``kernels.Work``, the closed forms of ``chip_smoke.py``'s bounds) once,
and nothing that runs inside it: the same work whether it launches its
CUDA kernel, runs its plain version on the CPU or computes shapes on the
meta device. Collectives (``DataGroup`` and the dry run's stand-in
groups) are recorded by kind, mesh axis and bytes in a
:class:`~repro_torch.launch.roofline.CollectiveStats`.

:func:`count` runs a function under a counter; :func:`count_kernel_launches`
(the JAX package's ``count_pallas_launches``) counts the kernel ops one
call of a function makes, from the ops' ``OP_CALLS``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.launch.roofline import CollectiveStats

_aten = torch.ops.aten

# ops that move or fill memory but do no arithmetic (some carry the
# pointwise tag)
_MOVES = {_aten.clone.default, _aten.copy_.default, _aten._to_copy.default,
          _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default,
          _aten.lift_fresh_copy.default}
# softmax and its backward: a reduction and pointwise work, counted as
# one op an operand element, as a reduction
_SOFTMAX = {_aten._softmax.default, _aten._log_softmax.default,
            _aten._softmax_backward_data.default,
            _aten._log_softmax_backward_data.default}
# allocations, host reads and the view a product's result is reshaped
# through (``_unsafe_view``, not marked a view in its schema): no traffic
# of their own
_FREE_PREFIXES = ("empty", "new_empty", "_local_scalar_dense", "sym_",
                  "resize_", "set_", "lift_fresh", "_unsafe_view")

_LOW = (torch.bfloat16, torch.float16)


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _free(func) -> bool:
    if func.is_view:
        return True
    name = func._schema.name.split("::")[-1]
    return name.startswith(_FREE_PREFIXES)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter() as c:``.

    ``c.flops`` (all classes), ``c.flops_bf16`` (the tensor-core part),
    ``c.bytes``, ``c.n_ops``; ``c.by_op`` maps an aten op to ``[calls,
    flops, bytes]``, ``c.kernels`` a kernel op to the same, and
    ``c.collectives`` holds the collectives. Counting goes on in
    autograd's backward threads (a dispatch mode is passed on to them;
    the kernel ops' "inside" mark is module state)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_bf16 = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.by_op: Dict[str, list] = {}
        self.kernels: Dict[str, list] = {}
        self.collectives = CollectiveStats()

    def __enter__(self):
        kernels.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels.COUNTERS.remove(self)

    # -- records --------------------------------------------------------

    def _add(self, table: Dict[str, list], key: str, flops: float,
             nbytes: float, cls: str) -> None:
        self.flops += flops
        if cls == "bf16":
            self.flops_bf16 += flops
        self.bytes += nbytes
        self.n_ops += 1
        row = table.get(key)
        if row is None:
            table[key] = [1, flops, nbytes]
        else:
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def record_kernel(self, name: str, work: "kernels.Work") -> None:
        """One kernel op's declared work (``kernels.declared``)."""
        self._add(self.kernels, name, float(work.flops), float(work.bytes),
                  work.flop_class)

    def record_collective(self, kind: str, axis: str, group: int,
                          nbytes: float) -> None:
        """One collective over a mesh axis (see ``CollectiveStats.add``)."""
        self.collectives.add(kind, axis, group, nbytes)

    # -- the dispatch ---------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if kernels.inside_op() or _free(func):
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        flops, cls = 0.0, "f32"
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](
                *args, **kwargs, out_val=out))
            if any(t.dtype in _LOW for t in ins):
                cls = "bf16"
        elif func in _MOVES:
            pass
        elif func in _SOFTMAX or torch.Tag.reduction in func.tags:
            flops = float(ins[0].numel()) if ins else 0.0
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in outs))
        self._add(self.by_op, str(packet), flops,
                  float(_nbytes(ins) + _nbytes(outs)), cls)
        return out

    # -- reading --------------------------------------------------------

    def summary(self) -> dict:
        """The totals, JSON-ready."""
        return {"flops": self.flops, "flops_bf16": self.flops_bf16,
                "hbm_bytes": self.bytes, "ops": self.n_ops,
                "kernel_ops": {k: {"calls": c, "flops": f, "bytes": b}
                               for k, (c, f, b) in sorted(
                                   self.kernels.items())},
                "collectives": dict(self.collectives.op_counts)}

    def table(self, top: Optional[int] = None) -> List[dict]:
        """One row for each aten op and kernel op (``kind`` "aten" or
        "kernel"): calls, FLOPs, bytes; the most bytes first."""
        rows = [{"op": k, "kind": kind, "calls": c, "flops": f, "bytes": b}
                for kind, tab in (("kernel", self.kernels),
                                  ("aten", self.by_op))
                for k, (c, f, b) in tab.items()]
        rows.sort(key=lambda r: (-r["bytes"], -r["flops"], r["op"]))
        return rows[:top] if top else rows


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCounter]:
    """(``fn(*args, **kwargs)``, the counter of what it dispatched)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c


def _op_calls() -> Dict[str, int]:
    from repro_torch.kernels.alf_step import ops as alf
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.rmsnorm import ops as rn
    out: Dict[str, int] = {}
    for mod in (alf, rn, fa, ms):
        out.update(mod.OP_CALLS)
    return out


def count_kernel_launches(fn: Callable, *args, by_op: bool = False,
                          **kwargs):
    """How many kernel-op calls one call of ``fn(*args, **kwargs)`` makes
    (each one launch on the card; the reverse rules of the ALF forward
    ops counted where they run): the total, or with ``by_op`` a dict by
    op. A graph replay calls no op, so it counts none."""
    before = _op_calls()
    fn(*args, **kwargs)
    after = _op_calls()
    diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return diff if by_op else sum(diff.values())


__all__ = ["OpCounter", "count", "count_kernel_launches"]
