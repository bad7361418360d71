"""Launcher of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

:func:`flash_attention_call` takes CUDA tensors ``q [B, Sq, H, d]`` and
``k, v [B, Sk, K, d]`` of one dtype (float32 or bfloat16), ``H % K == 0``,
``d`` in {16, 32, 64, 128, 256}, each with its last (head) dimension
contiguous; the batch, sequence and head strides go to the kernel as they
are, so no operand is copied. It allocates the output ``[B, Sq, H, d]``,
launches ONE kernel on PyTorch's current stream, raises if the launch
failed, and adds one to :data:`LAUNCHES`. The plain version is
``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

NAME = "flash_attention"

# Kernel launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = ([_I] * 7 + [_P] * 4 + [ctypes.c_int64] * 12
             + [ctypes.c_float, _I, _I, ctypes.c_float, _P])

_FN = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn():
    if not _FN:
        from repro_torch.kernels import build
        f = build.load(NAME).flash_attention_fwd
        f.argtypes = _ARGTYPES
        f.restype = ctypes.c_int
        _FN.append(f)
    return _FN[0]


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Grouped attention of q [B, Sq, H, d] over k/v [B, Sk, K, d] ->
    [B, Sq, H, d] in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q must be a CUDA tensor, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D [B, S, H, d]")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one of "
                        f"{tuple(_DTYPE_CODE)}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must share one dtype "
                             "and device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash_attention: the head dim of q, k, v must "
                             "be contiguous")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(_DTYPE_CODE[q.dtype], d, b, h, h // kh, sq, sk, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
               float(d ** -0.5), int(bool(causal)), int(window),
               float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out
