"""Reverse-rule registry for the port's kernel ops.

Every public op in ``kernels/*/ops.py`` either has a reverse rule
(a ``torch.autograd.Function`` whose backward is itself a kernel) or is
listed here in ``NO_REVERSE_RULE`` with the reason it is forward-only.

:func:`repro_torch.core.naive.check_direct_backprop` reads this registry:
a gradient method that backpropagates directly through the recorded
solver steps looks up every op the solver's step launches
(``Solver.kernel_step_ops``) and refuses any op listed here, quoting the
reason, instead of differentiating through a launch autograd cannot see.

This module imports nothing, so ``repro_torch.core`` can read it freely.
"""
from __future__ import annotations

from typing import Optional

# "<kernel package>.<op name>" -> why the op is forward-only. The forward
# step's ops (alf_midpoint, alf_update) are absent: their reverse rules are
# the midpoint_vjp / update_vjp kernels.
NO_REVERSE_RULE = {
    "alf_step.alf_inverse":
        "full psi^-1 reconstruction; runs only inside MALI's unfused "
        "backward (autograd.Function backward), which is never itself "
        "differentiated",
    "alf_step.alf_inverse_update":
        "psi^-1 tail given the recovered midpoint; a backward-sweep op "
        "like alf_inverse, never itself differentiated",
    "alf_step.alf_bwd_pre":
        "fused head of one MALI backward step (inverse midpoint + f-eval "
        "cotangent); runs inside MALI's autograd.Function backward and is "
        "never itself differentiated",
    "alf_step.alf_bwd_post":
        "fused tail of one MALI backward step (inverse tail + adjoint "
        "propagation); runs inside MALI's autograd.Function backward and "
        "is never itself differentiated",
    "flash_attention.flash_attention":
        "serving path only; as in the JAX package, training runs the "
        "plain attention (the direct einsum, or the chunked online "
        "softmax with its FA2-style backward written in PyTorch), which "
        "autograd differentiates",
    "rmsnorm.rmsnorm":
        "serving path only; as in the JAX package, training runs the "
        "plain RMSNorm, which autograd differentiates",
    "mamba_scan.selective_scan":
        "serving path only; as in the JAX package, training scans with "
        "the plain chunked scan, which autograd differentiates",
}


def no_reverse_reason(qualname: str) -> Optional[str]:
    """The reason ``qualname`` ("package.op") is forward-only, else None."""
    return NO_REVERSE_RULE.get(qualname)


def forward_only_ops(package: str) -> list:
    """The sorted names of the forward-only ops of one kernel package."""
    prefix = package + "."
    return sorted(k[len(prefix):] for k in NO_REVERSE_RULE
                  if k.startswith(prefix))
