"""Plain PyTorch versions of the fused ALF state-update kernels.

These are the elementwise algebra of paper Algo 2 between the f
evaluations, and of MALI's fused backward step around the f linearization.
They are what the CPU tests run, and the yardstick ``chip_smoke.py`` holds
each CUDA kernel against on the card. The CUDA kernels in
``csrc/alf_step.cu`` repeat exactly this operation order (and are built
with ``--fmad=false``), so on f32/f64 they agree to the ulp.

Reverse rules of the forward step (direct backprop): with ``g_z``/``g_v``
the cotangents of one step's outputs,

    cot_vout = g_v + (h/2) * g_z
    v_bar    = (1 - 2*eta) * cot_vout     # update's v cotangent
    u1_bar   = 2*eta * cot_vout           # the cotangent handed to vjp(f)
    v_bar    = sign * (h/2) * g           # midpoint's v cotangent

MALI's fused backward: with ``a_z``/``a_v`` its adjoint state,

    cot_vout = a_v + (h/2) * a_z
    cot_u1   = 2*eta * cot_vout          # the cotangent handed to vjp(f)
    dz_prev  = a_z + dk1                 # dk1 = vjp_f(cot_u1)
    dv_prev  = (h/2) * dz_prev + (1 - 2*eta) * cot_vout

Compute dtype: ``_acc`` promotes the storage dtype to at least float32 —
bf16 leaves accumulate in f32 and are cast back at the write, float64
stays float64 end to end. ``h`` arrives as a 0-d tensor of that compute
dtype.
"""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """Storage dtype -> compute dtype (>= f32; f64 preserved)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def midpoint_ref(z, v, h, sign: float = 1.0):
    """k1 = z + sign * v * h/2 (sign=-1 gives the inverse's midpoint)."""
    return (_acc(z) + sign * _acc(v) * (h / 2)).to(z.dtype)


def update_ref(k1, v, u1, h, eta: float = 1.0):
    """Forward tail: v_out = v + 2*eta*(u1 - v); z_out = k1 + v_out*h/2."""
    k1f, vf, uf = _acc(k1), _acc(v), _acc(u1)
    v_out = vf + 2.0 * eta * (uf - vf)
    z_out = k1f + v_out * (h / 2)
    return z_out.to(k1.dtype), v_out.to(v.dtype)


def _v_in(vf, uf, eta: float):
    """psi^-1's velocity: v_in = 2*u1 - v_out (eta == 1) or
    (v_out - 2*eta*u1) / (1 - 2*eta)."""
    if eta == 1.0:
        return 2.0 * uf - vf
    return (vf - 2.0 * eta * uf) / (1.0 - 2.0 * eta)


def inverse_update_ref(k1, v_out, u1, h, eta: float = 1.0):
    """Inverse tail given the midpoint: v_in from (u1, v_out);
    z_in = k1 - v_in*h/2."""
    v_in = _v_in(_acc(v_out), _acc(u1), eta)
    z_in = _acc(k1) - v_in * (h / 2)
    return z_in.to(k1.dtype), v_in.to(v_out.dtype)


def inverse_ref(z_out, v_out, u1, h, eta: float = 1.0):
    """Full psi^-1 in one pass: (z_in, v_in) from the step output, with the
    midpoint k1 = z_out - v_out*h/2 re-derived inside (Algo 3)."""
    vf = _acc(v_out)
    k1 = _acc(z_out) - vf * (h / 2)
    v_in = _v_in(vf, _acc(u1), eta)
    z_in = k1 - v_in * (h / 2)
    return z_in.to(z_out.dtype), v_in.to(v_out.dtype)


def midpoint_vjp_ref(g, h, sign: float = 1.0):
    """v-cotangent of the midpoint: v_bar = sign * g * h/2 (z_bar = g is
    the identity and stays with the caller)."""
    return (sign * _acc(g) * (h / 2)).to(g.dtype)


def update_vjp_ref(g_z, g_v, h, eta: float = 1.0):
    """(v_bar, u1_bar) cotangents of the forward tail, both in g_v's dtype
    (k1_bar = g_z is the identity and stays with the caller)."""
    cot_vout = _acc(g_v) + _acc(g_z) * (h / 2)
    v_bar = (1.0 - 2.0 * eta) * cot_vout
    u1_bar = 2.0 * eta * cot_vout
    return v_bar.to(g_v.dtype), u1_bar.to(g_v.dtype)


def bwd_pre_ref(z, v, a_z, a_v, h, eta: float = 1.0):
    """Head of one MALI backward step: the inverse's midpoint
    k1 = z - v*h/2 and the f-eval cotangent cot_u1 = 2*eta*(a_v + (h/2)*a_z),
    which depends only on the adjoints."""
    k1 = _acc(z) - _acc(v) * (h / 2)
    cot_u1 = 2.0 * eta * (_acc(a_v) + _acc(a_z) * (h / 2))
    return k1.to(z.dtype), cot_u1.to(a_z.dtype)


def bwd_post_ref(k1, v_out, u1, a_z, a_v, dk1, h, eta: float = 1.0):
    """Tail of one MALI backward step: the psi^-1 reconstruction
    (z_prev, v_prev) and the propagated adjoints (dz_prev, dv_prev), given
    dk1 = vjp_f(cot_u1) from the shared f linearization."""
    azf, avf, dkf = _acc(a_z), _acc(a_v), _acc(dk1)
    v_prev = _v_in(_acc(v_out), _acc(u1), eta)
    z_prev = _acc(k1) - v_prev * (h / 2)
    cot_k1 = azf + dkf
    cot_vout = avf + azf * (h / 2)
    dv_prev = cot_k1 * (h / 2) + (1.0 - 2.0 * eta) * cot_vout
    return (z_prev.to(k1.dtype), v_prev.to(v_out.dtype),
            cot_k1.to(a_z.dtype), dv_prev.to(a_v.dtype))
