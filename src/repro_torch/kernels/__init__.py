"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it. ``build`` compiles them at first launch; nothing here
imports it eagerly, so the package imports on hosts without ``nvcc``.

Every public op declares the work its kernel does (:class:`Work`: FLOPs
of one class and bytes, the closed forms of ``chip_smoke.py``'s bounds)
inside :class:`declared`. An open op counter (``launch/cost.py``) records
that once for the op and does not count what runs inside it, so an op
counts the same work whether it launches its kernel on the card, runs its
plain version on the CPU, or only computes shapes on the meta device.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

# The kernel packages, each with its CUDA source in <package>/csrc/.
PACKAGES = ("alf_step", "rmsnorm", "flash_attention", "mamba_scan")


def on_cuda(name: str, device: torch.device) -> bool:
    """Dispatch of every op by the device of its tensors: True on a CUDA
    device (launch the kernel, or raise), False on the CPU (the plain
    version) and on the meta device, where the plain version computes
    only the shapes (``launch/cost.py`` counts a step there; nothing
    runs). There is no fallback from one to the other."""
    if device.type == "cuda":
        return True
    if device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{device}")


class Work(NamedTuple):
    """What one kernel call must do: ``flops`` operations of one class
    (``"bf16"``: bf16/f16 products on the tensor cores; ``"f32"``:
    everything else) and ``bytes`` moved (each input read once, each
    output written once)."""
    flops: float
    bytes: float
    flop_class: str = "f32"


# The op counters now open, innermost last, and how deep the running code
# is inside declared ops: module state, not thread-local, since autograd
# runs the reverse rules' kernels on threads of its own.
COUNTERS: List = []
_INSIDE = [0]


def inside_op() -> bool:
    """Whether the running code is inside a declared kernel op."""
    return _INSIDE[0] > 0


class declared:
    """``with declared(name, work_fn, *args):`` around a kernel op's
    launch (or plain version). With a counter open, ``work_fn(*args)``
    (a :class:`Work`) is recorded once under ``name`` in each, and what
    the block dispatches is not counted; otherwise nothing happens. An op
    called inside another declared op is the outer one's work."""

    __slots__ = ("name", "fn", "args", "on")

    def __init__(self, name: str, fn: Callable[..., Work], *args):
        self.name, self.fn, self.args, self.on = name, fn, args, False

    def __enter__(self):
        if COUNTERS:
            if not _INSIDE[0]:
                work = self.fn(*self.args)
                for c in COUNTERS:
                    c.record_kernel(self.name, work)
            _INSIDE[0] += 1
            self.on = True
        return self

    def __exit__(self, *exc):
        if self.on:
            _INSIDE[0] -= 1
        return False
