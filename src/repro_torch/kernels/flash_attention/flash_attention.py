"""Launcher of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

:func:`flash_attention_call` takes CUDA tensors ``q [B, Sq, H, d]`` and
``k, v [B, Sk, K, d]`` of one dtype (float32 or bfloat16), ``H % K == 0``,
``d`` in {16, 32, 64, 128, 256}, each with its last (head) dimension
contiguous; the batch, sequence and head strides go to the kernel as they
are, so no operand is copied. bfloat16 runs the tensor-core kernel, whose
TMA loads need q, k and v at 16-byte aligned addresses with strides of
multiples of 8 elements (the launcher raises otherwise); float32 runs the
CUDA-core kernel. It allocates the output ``[B, Sq, H, d]``, launches ONE
kernel on PyTorch's current stream, raises if the launch failed, and adds
one to :data:`LAUNCHES`. The plain version is ``ref.attention_ref``.
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

# the C function's code for a TMA descriptor it could not build:
# _ENCODE_ERROR + the driver's CUresult
_ENCODE_ERROR = 10000

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


def _strides(t: torch.Tensor, d: int) -> list:
    """(batch, sequence, head) strides in elements; a dimension of size 1
    is never stepped, so it gets the head dim's extent d (a multiple of 8
    elements, as a TMA descriptor asks of every stride)."""
    return [st if n > 1 else d for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check_tma_alignment(t: torch.Tensor, name: str, d: int) -> None:
    """The bf16 kernel's TMA loads read t at a 16-byte aligned base with
    16-byte multiples as strides; raise rather than copy."""
    if t.data_ptr() % 16 or any((s * t.element_size()) % 16
                                for s in _strides(t, d)):
        raise ValueError(
            f"flash_attention: bfloat16 {name} must start at a 16-byte "
            f"aligned address with strides of multiples of 8 elements "
            f"(TMA), got address {t.data_ptr():#x} and strides "
            f"{tuple(t.stride())}")


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
    if q.dtype == torch.bfloat16:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            _check_tma_alignment(t, name, d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    strides = [s for t in (q, k, v, out) for s in _strides(t, d)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(_DTYPE_CODE[q.dtype], d, b, h, h // kh, sq, sk, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
               float(d ** -0.5), int(bool(causal)), int(window),
               float(softcap), stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {rc - _ENCODE_ERROR} (q "
                           f"{tuple(q.shape)} strides {tuple(q.stride())}, k "
                           f"{tuple(k.shape)} strides {tuple(k.stride())})")
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out
