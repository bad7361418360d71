"""Public ops of the fused ALF state updates, over arbitrary pytrees.

One op call is ONE kernel launch for the whole tree: the leaves are packed
into one contiguous buffer in their common dtype (``torch.result_type``
across the leaves — a bf16 tree stays bf16, float64 stays float64), the
kernel runs once over it, and the outputs are split back with every leaf's
own dtype restored. A tree of one contiguous leaf in that dtype is passed
as a ``reshape(-1)`` view, without a copy.

Dispatch is by device: CUDA tensors launch the kernel (or raise — there is
no fallback), CPU tensors take the plain version of ``ref.py`` over the
same packed buffer. The step size ``h`` rides as a 0-d tensor of at least
float32 (float64 for float64 states) on the state's device and is never
read on the host.

None of these ops is differentiable through: autograd through the forward
ops needs the reverse-rule kernels of a later slice, see
:mod:`repro_torch.kernels.registry`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.utils._pytree as pytree

from . import alf_step, ref

Pytree = Any

# Op calls per op since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"alf_midpoint": 0, "alf_update": 0,
                            "alf_bwd_pre": 0, "alf_bwd_post": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def _common_dtype(*trees) -> torch.dtype:
    leaves = [l for t in trees for l in pytree.tree_leaves(t)]
    dt = leaves[0].dtype
    for l in leaves[1:]:
        dt = torch.promote_types(dt, l.dtype)
    return dt


def _as_h(h, cdtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The step size as a 0-d tensor of at least f32 (f64 for f64 states)
    on the state's device. A tensor is converted on the device; a Python
    number is uploaded once."""
    hd = torch.promote_types(cdtype, torch.float32)
    return torch.as_tensor(h, dtype=hd, device=device).reshape(())


class _Meta:
    """Structure, shapes and dtypes of a tree: what _unflatten restores."""

    __slots__ = ("spec", "shapes", "dtypes", "sizes")

    def __init__(self, tree: Pytree):
        leaves, self.spec = pytree.tree_flatten(tree)
        self.shapes = [l.shape for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [l.numel() for l in leaves]


def _flatten(tree: Pytree, dtype: torch.dtype) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    if len(leaves) == 1 and leaves[0].dtype == dtype:
        return leaves[0].reshape(-1).contiguous()
    return torch.cat([l.reshape(-1).to(dtype) for l in leaves])


def _unflatten(flat: torch.Tensor, meta: _Meta) -> Pytree:
    parts = torch.split(flat, meta.sizes) if len(meta.sizes) > 1 else [flat]
    leaves: List[torch.Tensor] = [
        p.reshape(s).to(d)
        for p, s, d in zip(parts, meta.shapes, meta.dtypes)]
    return pytree.tree_unflatten(leaves, meta.spec)


def _device(tree: Pytree) -> torch.device:
    return pytree.tree_leaves(tree)[0].device


def _on_cuda(name: str, dev: torch.device) -> bool:
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {dev}")


def alf_midpoint(z: Pytree, v: Pytree, h, *, sign: float = 1.0) -> Pytree:
    """k1 = z + sign*v*h/2 over a pytree state, in one launch."""
    OP_CALLS["alf_midpoint"] += 1
    cd = _common_dtype(z, v)
    dev = _device(z)
    hh = _as_h(h, cd, dev)
    zf, vf = _flatten(z, cd), _flatten(v, cd)
    if _on_cuda("alf_midpoint", dev):
        k1 = alf_step.midpoint_call(zf, vf, hh, sign=sign)
    else:
        k1 = ref.midpoint_ref(zf, vf, hh, sign)
    return _unflatten(k1, _Meta(z))


def alf_update(k1: Pytree, v: Pytree, u1: Pytree, h, *,
               eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """Forward tail (z_out, v_out) in one launch."""
    OP_CALLS["alf_update"] += 1
    cd = _common_dtype(k1, v, u1)
    dev = _device(k1)
    hh = _as_h(h, cd, dev)
    kf, vf, uf = _flatten(k1, cd), _flatten(v, cd), _flatten(u1, cd)
    if _on_cuda("alf_update", dev):
        zo, vo = alf_step.update_call(kf, vf, uf, hh, eta=eta)
    else:
        zo, vo = ref.update_ref(kf, vf, uf, hh, eta)
    return _unflatten(zo, _Meta(k1)), _unflatten(vo, _Meta(v))


def alf_bwd_pre(z_i: Pytree, v_i: Pytree, a_z: Pytree, a_v: Pytree, h, *,
                eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """Fused head of one MALI backward step: the inverse's midpoint
    k1 = z_i - v_i*h/2 and the f-eval cotangent
    cot_u1 = 2*eta*(a_v + (h/2)*a_z), in one launch."""
    OP_CALLS["alf_bwd_pre"] += 1
    cd = _common_dtype(z_i, v_i, a_z, a_v)
    dev = _device(z_i)
    hh = _as_h(h, cd, dev)
    bufs = [_flatten(t, cd) for t in (z_i, v_i, a_z, a_v)]
    if _on_cuda("alf_bwd_pre", dev):
        k1, cu = alf_step.bwd_pre_call(*bufs, hh, eta=eta)
    else:
        k1, cu = ref.bwd_pre_ref(*bufs, hh, eta)
    return _unflatten(k1, _Meta(z_i)), _unflatten(cu, _Meta(a_z))


def alf_bwd_post(k1: Pytree, v_out: Pytree, u1: Pytree, a_z: Pytree,
                 a_v: Pytree, dk1: Pytree, h, *, eta: float = 1.0
                 ) -> Tuple[Pytree, Pytree, Pytree, Pytree]:
    """Fused tail of one MALI backward step, given dk1 = vjp_f(cot_u1):
    (z_prev, v_prev, dz_prev, dv_prev), in one launch."""
    OP_CALLS["alf_bwd_post"] += 1
    cd = _common_dtype(k1, v_out, u1, a_z, a_v, dk1)
    dev = _device(k1)
    hh = _as_h(h, cd, dev)
    bufs = [_flatten(t, cd) for t in (k1, v_out, u1, a_z, a_v, dk1)]
    if _on_cuda("alf_bwd_post", dev):
        zp, vp, dz, dv = alf_step.bwd_post_call(*bufs, hh, eta=eta)
    else:
        zp, vp, dz, dv = ref.bwd_post_ref(*bufs, hh, eta)
    return (_unflatten(zp, _Meta(k1)), _unflatten(vp, _Meta(v_out)),
            _unflatten(dz, _Meta(a_z)), _unflatten(dv, _Meta(a_v)))
