"""Public ops of the fused ALF state updates, over arbitrary pytrees.

One op call is ONE kernel launch for the whole tree: the leaves are packed
into one contiguous buffer in their common dtype (``torch.result_type``
across the leaves — a bf16 tree stays bf16, float64 stays float64), the
kernel runs once over it, and the outputs are split back with every leaf's
own dtype restored. A tree of one contiguous leaf in that dtype is passed
as a ``reshape(-1)`` view, without a copy.

Dispatch is by device: CUDA tensors launch the kernel (or raise — there is
no fallback), CPU tensors take the plain version of ``ref.py`` over the
same packed buffer. The step size ``h`` rides as a tensor of at least
float32 (float64 for float64 states) on the state's device and is never
read on the host. Each tree is flattened once per call; a bare tensor is
not flattened at all.

Per-row step size (``PerSample`` batching): ``h`` of shape (B,) gives
row b of the batch the step ``h[b]``. Every leaf then carries the batch
axis in front, and the tree packs row-major,
``cat([leaf.reshape(B, -1) for leaf], 1).reshape(-1)``, so the row length
D is one number and element e takes ``h[e // D]``; a single contiguous
(B, ...) leaf still packs without a copy. Still one launch per op call,
for the whole batch. The plain versions see the packed buffer as (B, D)
beside h as (B, 1), and the reverse rules reduce ``h_bar`` per row.

Grad-free path: when autograd is off (``lm.prefill``/``decode_step`` and
MALI's forward run under ``torch.no_grad()``) or no input needs a
gradient, ``alf_midpoint`` and ``alf_update`` call the launcher (on the
CPU, the plain version) directly on the packed buffers, with no
``autograd.Function`` around it: the same launch and the same bits, for a
fraction of the host's time.

Reverse rules: the ops a forward integration launches (``alf_midpoint``,
``alf_update``) are ``torch.autograd.Function``s over the packed flat
buffers and ``h``, so direct backprop (``Naive()``, ``SaveAt(steps|dense)``,
the unfused MALI replay under ``torch.func.vjp``) works through the launch.
The step is linear in the state, so each backward is one more kernel
launch (``midpoint_vjp`` / ``update_vjp``), the identity cotangents, and
the reduction ``h_bar`` (plain torch, only when ``h`` needs a gradient, as
under an adaptive controller). The packing around the Functions is plain
autograd, which casts each leaf's cotangent back to that leaf's dtype. The
backward-sweep ops (``alf_inverse``, ``alf_inverse_update``,
``alf_bwd_pre``, ``alf_bwd_post``) run only inside MALI's backward and are
forward-only, see :mod:`repro_torch.kernels.registry`.

Work: each launch (or plain version) sits inside ``kernels.declared``
with :func:`alf_work`, the closed form of ``chip_smoke.py``'s bounds:
each packed buffer read or written once, :data:`ALF_WORK`'s f32
operations an element; the packing around it is counted as the plain
torch it is.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch import tree_util as pytree
from repro_torch.kernels import Work, declared
from repro_torch.kernels import on_cuda as _on_cuda

from . import alf_step, ref

Pytree = Any

# Calls per op since the last reset_op_calls(), on any device. The two
# reverse rules count where the backward of alf_midpoint / alf_update runs
# its kernel (or, on the CPU, its plain version).
OP_CALLS: Dict[str, int] = {
    "alf_midpoint": 0, "alf_update": 0, "alf_bwd_pre": 0, "alf_bwd_post": 0,
    "alf_midpoint_vjp": 0, "alf_update_vjp": 0, "alf_inverse": 0,
    "alf_inverse_update": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


# name: (packed buffers read, buffers written, f32 operations an element)
ALF_WORK = {
    "alf_midpoint": (2, 1, 3),
    "alf_update": (3, 2, 5),
    "alf_bwd_pre": (4, 2, 5),
    "alf_bwd_post": (6, 4, 12),
    "alf_midpoint_vjp": (1, 1, 2),
    "alf_update_vjp": (2, 2, 4),
    "alf_inverse": (3, 2, 7),
    "alf_inverse_update": (3, 2, 5),
}


def alf_work(name: str, buf: torch.Tensor, h: torch.Tensor) -> Work:
    """One launch's work over packed buffers like ``buf``: every input
    read once and every output written once in the storage dtype, a
    per-row (B,) ``h`` read once too (a 0-d one is one scalar), and
    :data:`ALF_WORK`'s operations for each element."""
    n_in, n_out, ops = ALF_WORK[name]
    n = buf.numel()
    h_bytes = h.numel() * h.element_size() if h.dim() else 0
    return Work(ops * n, (n_in + n_out) * n * buf.element_size() + h_bytes)


class _Tree:
    """A tree flattened once: its leaves and its structure (None for a
    bare tensor), what ``pack`` reads and ``unpack`` restores."""

    __slots__ = ("leaves", "spec")

    def __init__(self, tree: Pytree):
        if isinstance(tree, torch.Tensor):
            self.leaves, self.spec = [tree], None
        else:
            self.leaves, self.spec = pytree.tree_flatten(tree)

    def pack(self, dtype: torch.dtype, rows: int = 0) -> torch.Tensor:
        """The leaves as one flat contiguous buffer of ``dtype``, leaf
        after leaf, or with ``rows`` = B > 0 row after row (row b holds
        row b of every leaf); a single leaf of that dtype as a view where
        it is contiguous."""
        leaves = self.leaves
        if rows:
            for l in leaves:
                if l.dim() == 0 or l.shape[0] != rows:
                    raise ValueError(
                        f"a per-row h of {rows} rows needs the batch axis "
                        f"in front of every leaf, got a leaf of shape "
                        f"{tuple(l.shape)}")
        if len(leaves) == 1 and leaves[0].dtype == dtype:
            return leaves[0].reshape(-1).contiguous()
        if rows:
            return torch.cat([l.reshape(rows, -1).to(dtype)
                              for l in leaves], 1).reshape(-1)
        return torch.cat([l.reshape(-1).to(dtype) for l in leaves])

    def unpack(self, flat: torch.Tensor, rows: int = 0) -> Pytree:
        """``flat`` (packed as :meth:`pack` with the same ``rows``) split
        back into leaves of this tree's shapes and dtypes."""
        leaves = self.leaves
        if self.spec is None:
            return flat.reshape(leaves[0].shape).to(leaves[0].dtype)
        if len(leaves) == 1:
            parts = [flat]
        elif rows:
            parts = torch.split(flat.view(rows, -1),
                                [l.numel() // rows for l in leaves], 1)
        else:
            parts = torch.split(flat, [l.numel() for l in leaves])
        return pytree.tree_unflatten(
            [p.reshape(l.shape).to(l.dtype) for p, l in zip(parts, leaves)],
            self.spec)


def _trees(*trees: Pytree):
    """The flattened trees and their common dtype (``torch.result_type``
    across the leaves: a bf16 tree stays bf16, float64 stays float64)."""
    ts = [_Tree(t) for t in trees]
    dt = ts[0].leaves[0].dtype
    for t in ts:
        for l in t.leaves:
            if l.dtype != dt:
                dt = torch.promote_types(dt, l.dtype)
    return ts, dt


def _flatten(tree: Pytree, dtype: torch.dtype, rows: int = 0
             ) -> torch.Tensor:
    return _Tree(tree).pack(dtype, rows)


def _as_h(h, cdtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The step size as a 0-d or (B,) tensor of at least f32 (f64 for f64
    states) on the state's device. A tensor is converted on the device
    (and stays differentiable); a Python number is uploaded once."""
    hd = torch.promote_types(cdtype, torch.float32)
    if isinstance(h, torch.Tensor) and h.dim() == 1:
        return h.to(device=device, dtype=hd).contiguous()
    if (isinstance(h, torch.Tensor) and h.dtype == hd and h.dim() == 0
            and h.device == device):
        return h
    return torch.as_tensor(h, dtype=hd, device=device).reshape(())


def _rows(h: torch.Tensor) -> int:
    """B for a per-row (B,) h, 0 for a scalar one."""
    return h.shape[0] if h.dim() else 0


def _plain(fn, h: torch.Tensor, *bufs: torch.Tensor, param: float):
    """A plain version of ``ref.py`` over packed buffers: as they are
    beside a scalar h, as (B, D) beside a (B,) h viewed as (B, 1)."""
    if not h.dim():
        return fn(*bufs, h, param)
    b = h.shape[0]
    out = fn(*(x.view(b, -1) for x in bufs), h.view(b, 1), param)
    if isinstance(out, tuple):
        return tuple(o.reshape(-1) for o in out)
    return out.reshape(-1)


def _grad_free(*bufs: torch.Tensor) -> bool:
    """True when no gradient can flow through the op: autograd is off, or
    no packed input (nor h) requires one."""
    return not (torch.is_grad_enabled()
                and any(b.requires_grad for b in bufs))


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under ``torch.func``'s wrappers. When a reverse
    rule runs from a ``torch.func.vjp`` pullback (the unfused MALI replay),
    its saved tensors arrive wrapped at the transform's level, and a
    wrapper has no data pointer to hand a kernel."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def _h_cotangent(h: torch.Tensor, coeff: float, a: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """h_bar = coeff * <a, g> over the packed buffers, reduced at h's
    dtype: over the whole buffer for a scalar h, row by row for a (B,)
    h."""
    prod = a.to(h.dtype) * g.to(h.dtype)
    if h.dim():
        return prod.view(h.shape[0], -1).sum(1) * coeff
    return torch.sum(prod) * coeff


def _midpoint(zf, vf, h, sign):
    with declared("alf_midpoint", alf_work, "alf_midpoint", zf, h):
        if _on_cuda("alf_midpoint", zf.device):
            return alf_step.midpoint_call(zf, vf, h, sign=sign)
        return _plain(ref.midpoint_ref, h, zf, vf, param=sign)


def _update(kf, vf, uf, h, eta):
    with declared("alf_update", alf_work, "alf_update", kf, h):
        if _on_cuda("alf_update", kf.device):
            return alf_step.update_call(kf, vf, uf, h, eta=eta)
        return _plain(ref.update_ref, h, kf, vf, uf, param=eta)


class _Midpoint(torch.autograd.Function):
    """k1 = z + sign*v*h/2 over packed buffers. Reverse rule:
    z_bar = g, v_bar = sign*g*h/2 (one midpoint_vjp launch),
    h_bar = (sign/2) * <v, g>."""

    @staticmethod
    def forward(zf, vf, h, sign):
        return _midpoint(zf, vf, h, sign)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, vf, h, sign = inputs
        ctx.sign = sign
        # v only feeds h_bar: keep it alive only when h needs a gradient
        ctx.save_for_backward(vf if ctx.needs_input_grad[2] else None, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vf, h = ctx.saved_tensors
        g, h = _unwrapped(g).contiguous(), _unwrapped(h)
        v_bar = h_bar = None
        if ctx.needs_input_grad[1]:
            OP_CALLS["alf_midpoint_vjp"] += 1
            with declared("alf_midpoint_vjp", alf_work,
                          "alf_midpoint_vjp", g, h):
                if _on_cuda("alf_midpoint_vjp", g.device):
                    v_bar = alf_step.midpoint_vjp_call(g, h, sign=ctx.sign)
                else:
                    v_bar = _plain(ref.midpoint_vjp_ref, h, g,
                                   param=ctx.sign)
        if ctx.needs_input_grad[2]:
            h_bar = _h_cotangent(h, 0.5 * ctx.sign, vf, g)
        return g, v_bar, h_bar, None


class _Update(torch.autograd.Function):
    """(z_out, v_out) of the forward tail over packed buffers. Reverse
    rule, with c = g_v + (h/2)*g_z: k1_bar = g_z, v_bar = (1-2*eta)*c,
    u1_bar = 2*eta*c (one update_vjp launch), h_bar = <v_out, g_z>/2."""

    @staticmethod
    def forward(kf, vf, uf, h, eta):
        return _update(kf, vf, uf, h, eta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eta = inputs[4]
        # v_out only feeds h_bar: keep it alive only when h needs a gradient
        ctx.save_for_backward(output[1] if ctx.needs_input_grad[3] else None,
                              inputs[3])

    @staticmethod
    @once_differentiable
    def backward(ctx, g_z, g_v):
        v_out, h = ctx.saved_tensors
        h = _unwrapped(h)
        g_z, g_v = _unwrapped(g_z).contiguous(), _unwrapped(g_v).contiguous()
        v_bar = u1_bar = h_bar = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            OP_CALLS["alf_update_vjp"] += 1
            with declared("alf_update_vjp", alf_work, "alf_update_vjp",
                          g_z, h):
                if _on_cuda("alf_update_vjp", g_z.device):
                    v_bar, u1_bar = alf_step.update_vjp_call(g_z, g_v, h,
                                                             eta=ctx.eta)
                else:
                    v_bar, u1_bar = _plain(ref.update_vjp_ref, h, g_z,
                                           g_v, param=ctx.eta)
        if ctx.needs_input_grad[3]:
            h_bar = _h_cotangent(h, 0.5, v_out, g_z)
        return g_z, v_bar, u1_bar, h_bar, None


def alf_midpoint(z: Pytree, v: Pytree, h, *, sign: float = 1.0) -> Pytree:
    """k1 = z + sign*v*h/2 over a pytree state, in one launch.
    Differentiable in z, v and h."""
    OP_CALLS["alf_midpoint"] += 1
    (zt, vt), cd = _trees(z, v)
    hh = _as_h(h, cd, zt.leaves[0].device)
    b = _rows(hh)
    zf, vf = zt.pack(cd, b), vt.pack(cd, b)
    if _grad_free(zf, vf, hh):
        return zt.unpack(_midpoint(zf, vf, hh, float(sign)), b)
    return zt.unpack(_Midpoint.apply(zf, vf, hh, float(sign)), b)


def alf_update(k1: Pytree, v: Pytree, u1: Pytree, h, *,
               eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """Forward tail (z_out, v_out) in one launch. Differentiable in k1, v,
    u1 and h."""
    OP_CALLS["alf_update"] += 1
    (kt, vt, ut), cd = _trees(k1, v, u1)
    hh = _as_h(h, cd, kt.leaves[0].device)
    b = _rows(hh)
    bufs = (kt.pack(cd, b), vt.pack(cd, b), ut.pack(cd, b), hh)
    if _grad_free(*bufs):
        zo, vo = _update(*bufs, float(eta))
    else:
        zo, vo = _Update.apply(*bufs, float(eta))
    return kt.unpack(zo, b), vt.unpack(vo, b)


def _forward_only(name: str, launcher, plain, trees, h, eta: float):
    """One call of a forward-only op (the backward-sweep kernels): pack
    the trees (row by row for a (B,) h), launch on CUDA or run the plain
    version on the CPU. Returns the flattened trees, the packed outputs
    and the rows they were packed with."""
    OP_CALLS[name] += 1
    ts, cd = _trees(*trees)
    dev = ts[0].leaves[0].device
    hh = _as_h(h, cd, dev)
    b = _rows(hh)
    bufs = [t.pack(cd, b) for t in ts]
    with declared(name, alf_work, name, bufs[0], hh):
        if _on_cuda(name, dev):
            out = launcher(*bufs, hh, eta=eta)
        else:
            out = _plain(plain, hh, *bufs, param=eta)
    return ts, out, b


def alf_inverse(z_out: Pytree, v_out: Pytree, u1: Pytree, h, *,
                eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """Full psi^-1 in one launch: (z_in, v_in) from the step output, given
    u1 = f(k1, s1); the midpoint k1 = z_out - v_out*h/2 is re-derived
    inside the kernel rather than read back."""
    ts, outs, b = _forward_only("alf_inverse", alf_step.inverse_call,
                                ref.inverse_ref, (z_out, v_out, u1), h, eta)
    return ts[0].unpack(outs[0], b), ts[1].unpack(outs[1], b)


def alf_inverse_update(k1: Pytree, v_out: Pytree, u1: Pytree, h, *,
                       eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """psi^-1's tail (z_in, v_in) given the recovered midpoint k1, in one
    launch."""
    ts, outs, b = _forward_only(
        "alf_inverse_update", alf_step.inverse_update_call,
        ref.inverse_update_ref, (k1, v_out, u1), h, eta)
    return ts[0].unpack(outs[0], b), ts[1].unpack(outs[1], b)


def alf_bwd_pre(z_i: Pytree, v_i: Pytree, a_z: Pytree, a_v: Pytree, h, *,
                eta: float = 1.0) -> Tuple[Pytree, Pytree]:
    """Fused head of one MALI backward step: the inverse's midpoint
    k1 = z_i - v_i*h/2 and the f-eval cotangent
    cot_u1 = 2*eta*(a_v + (h/2)*a_z), in one launch."""
    ts, outs, b = _forward_only("alf_bwd_pre", alf_step.bwd_pre_call,
                                ref.bwd_pre_ref, (z_i, v_i, a_z, a_v), h,
                                eta)
    return ts[0].unpack(outs[0], b), ts[2].unpack(outs[1], b)


def alf_bwd_post(k1: Pytree, v_out: Pytree, u1: Pytree, a_z: Pytree,
                 a_v: Pytree, dk1: Pytree, h, *, eta: float = 1.0
                 ) -> Tuple[Pytree, Pytree, Pytree, Pytree]:
    """Fused tail of one MALI backward step, given dk1 = vjp_f(cot_u1):
    (z_prev, v_prev, dz_prev, dv_prev), in one launch."""
    ts, outs, b = _forward_only("alf_bwd_post", alf_step.bwd_post_call,
                                ref.bwd_post_ref,
                                (k1, v_out, u1, a_z, a_v, dk1), h, eta)
    return (ts[0].unpack(outs[0], b), ts[1].unpack(outs[1], b),
            ts[3].unpack(outs[2], b), ts[4].unpack(outs[3], b))
