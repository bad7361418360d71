"""Launcher of the fused RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

:func:`rmsnorm_call` takes a contiguous CUDA ``x`` of shape ``[rows, d]``
(float32 or bfloat16) and a contiguous ``scale`` of shape ``[d]`` (float32
or bfloat16) on the same card, allocates the output, launches ONE kernel
on PyTorch's current stream, raises if the launch failed, and adds one to
:data:`LAUNCHES`. The plain version is ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

NAME = "rmsnorm"

# Kernel launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P, _P,
             ctypes.c_float, _P, _P]

_FN = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn():
    if not _FN:
        from repro_torch.kernels import build
        f = build.load(NAME).rmsnorm
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
        _FN.append(f)
    return _FN[0]


def rmsnorm_call(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """out = x * rsqrt(mean(x^2, -1) + eps) * scale over the rows of a
    2-D x, in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"rmsnorm: x must be a contiguous [rows, d] tensor, "
                         f"got shape {tuple(x.shape)}")
    rows, d = x.shape
    if (scale.device != x.device or scale.shape != (d,)
            or not scale.is_contiguous()):
        raise ValueError(f"rmsnorm: scale must be a contiguous [{d}] tensor "
                         f"on {x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    for t in (x, scale):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"rmsnorm: dtype {t.dtype} is not one of "
                            f"{tuple(_DTYPE_CODE)}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(_DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype], rows, d,
               x.data_ptr(), scale.data_ptr(), float(eps), out.data_ptr(),
               stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm: kernel launch failed with CUDA error "
                           f"{rc} (rows={rows}, d={d})")
    LAUNCHES["rmsnorm"] += 1
    return out
