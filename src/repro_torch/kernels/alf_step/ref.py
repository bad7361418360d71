"""Plain PyTorch versions of the fused ALF state-update kernels.

These are the elementwise algebra of paper Algo 2 between the f
evaluations, and of MALI's fused backward step around the f linearization.
They are what the CPU tests run, and the yardstick ``chip_smoke.py`` holds
each CUDA kernel against on the card. The CUDA kernels in
``csrc/alf_step.cu`` repeat exactly this operation order (and are built
with ``--fmad=false``), so on f32/f64 they agree to the ulp.

Backward algebra: with ``a_z``/``a_v`` MALI's adjoint state,

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
    k1f, vf, uf = _acc(k1), _acc(v_out), _acc(u1)
    azf, avf, dkf = _acc(a_z), _acc(a_v), _acc(dk1)
    if eta == 1.0:
        v_prev = 2.0 * uf - vf
    else:
        v_prev = (vf - 2.0 * eta * uf) / (1.0 - 2.0 * eta)
    z_prev = k1f - v_prev * (h / 2)
    cot_k1 = azf + dkf
    cot_vout = avf + azf * (h / 2)
    dv_prev = cot_k1 * (h / 2) + (1.0 - 2.0 * eta) * cot_vout
    return (z_prev.to(k1.dtype), v_prev.to(v_out.dtype),
            cot_k1.to(a_z.dtype), dv_prev.to(a_v.dtype))
