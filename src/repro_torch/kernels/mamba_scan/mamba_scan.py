"""Launcher of the selective-scan CUDA kernel (``csrc/mamba_scan.cu``).

:func:`selective_scan_call` takes CUDA tensors ``delta, u [Bt, S, DI]``
and ``B, C [Bt, S, ST]`` (each float32 or bfloat16, any strides: they go
to the kernel as they are, so no operand is copied), and contiguous
float32 ``A [DI, ST]`` and ``h0 [Bt, DI, ST]``, all on one card, with ST
in :data:`STATE_DIMS`. It allocates ``y [Bt, S, DI]`` and ``h [Bt, DI,
ST]`` (float32), launches ONE kernel on PyTorch's current stream, raises
if the launch failed, and adds one to :data:`LAUNCHES`. The plain version
is ``ref.selective_scan_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

NAME = "mamba_scan"

# Kernel launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {"selective_scan": 0}

# The state sizes the kernel is instantiated for (h lives in registers).
STATE_DIMS = (1, 2, 4, 8, 16, 32)
MAX_BATCH = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_I = ctypes.c_int
_L = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = ([_I] * 4 + [_P, _I, _L, _L, _L] * 2 + [_P]
             + [_P, _I, _L, _L, _L] * 2 + [_P] * 4)

_FN = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn():
    if not _FN:
        from repro_torch.kernels import build
        f = build.load(NAME).selective_scan_fwd
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
        _FN.append(f)
    return _FN[0]


def _operand(t: torch.Tensor):
    return (t.data_ptr(), _DTYPE_CODE[t.dtype], *t.stride())


def selective_scan_call(delta: torch.Tensor, u: torch.Tensor,
                        A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan from state h0 -> (y [Bt, S, DI] f32, h_final [Bt, DI, ST]
    f32)."""
    if delta.device.type != "cuda":
        raise ValueError(f"selective_scan: delta must be a CUDA tensor, got "
                         f"{delta.device}")
    if delta.dim() != 3 or A.dim() != 2:
        raise ValueError("selective_scan: delta must be [Bt, S, DI] and A "
                         "[DI, ST]")
    bt, s, di = delta.shape
    st = A.shape[1]
    want = {"u": (u, (bt, s, di)), "A": (A, (di, st)),
            "B": (B, (bt, s, st)), "C": (C, (bt, s, st)),
            "h0": (h0, (bt, di, st))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != delta.device:
            raise ValueError(f"selective_scan: {name} must be {shape} on "
                             f"{delta.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t in (("delta", delta), ("u", u), ("B", B), ("C", C)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"selective_scan: {name} dtype {t.dtype} is not "
                            f"one of {tuple(_DTYPE_CODE)}")
    for name, t in (("A", A), ("h0", h0)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be a contiguous "
                             f"float32 tensor")
    if st not in STATE_DIMS:
        raise ValueError(f"selective_scan: state size {st} is not one of "
                         f"{STATE_DIMS}")
    if bt > MAX_BATCH:
        raise ValueError(f"selective_scan: batch {bt} > {MAX_BATCH}")
    y = torch.empty((bt, s, di), dtype=torch.float32, device=delta.device)
    h = torch.empty((bt, di, st), dtype=torch.float32, device=delta.device)
    if bt == 0 or di == 0:
        return y, h
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    rc = _fn()(st, bt, s, di, *_operand(delta), *_operand(u), A.data_ptr(),
               *_operand(B), *_operand(C), h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan: kernel launch failed with CUDA "
                           f"error {rc} (delta {tuple(delta.shape)}, ST {st})")
    LAUNCHES["selective_scan"] += 1
    return y, h
