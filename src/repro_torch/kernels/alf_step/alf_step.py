"""Launchers of the fused ALF CUDA kernels (``csrc/alf_step.cu``).

Each launcher takes flat contiguous CUDA buffers of one storage dtype
(float32, float64 or bfloat16) and the step size ``h`` as a CUDA tensor
of the compute dtype (float32, or float64 for float64 storage): 0-d, one
step size for the whole buffer, or (B,), one per row of a buffer packed
row-major as B rows of n / B elements (PerSample batching). It checks
them, allocates the outputs, launches ONE kernel on PyTorch's current
stream (a capturing stream too: the launch then goes into the CUDA
graph), raises if the launch failed, and adds one to its count in
:data:`LAUNCHES`; a per-row call also adds one to :data:`ROW_LAUNCHES`.
The kernel reads ``h`` through its pointer, so no launch syncs the host.

Kernel inventory (the plain PyTorch version of each is in ref.py):

  forward step      alf_midpoint, alf_update
  direct backprop   alf_midpoint_vjp, alf_update_vjp — the reverse rules
                    of the forward step's ops
  psi^-1            alf_inverse (full, re-derives k1),
                    alf_inverse_update (tail, given k1)
  MALI backward     alf_bwd_pre (inverse midpoint + f-cotangent),
                    alf_bwd_post (inverse tail + adjoint propagation)
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

NAME = "alf_step"

# Kernel launches per launcher since the last reset_launches().
LAUNCHES: Dict[str, int] = {
    "alf_midpoint": 0, "alf_update": 0, "alf_bwd_pre": 0, "alf_bwd_post": 0,
    "alf_midpoint_vjp": 0, "alf_update_vjp": 0, "alf_inverse": 0,
    "alf_inverse_update": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int64
_HEAD = [ctypes.c_int, _I]      # dtype code, element count
# (input pointers, h pointer, row length (0: scalar h), sign/eta, output
# pointers, stream) per symbol
_ARGTYPES = {
    "alf_midpoint": _HEAD + [_P, _P, _P, _I, _D, _P, _P],
    "alf_update": _HEAD + [_P, _P, _P, _P, _I, _D, _P, _P, _P],
    "alf_bwd_pre": _HEAD + [_P, _P, _P, _P, _P, _I, _D, _P, _P, _P],
    "alf_bwd_post": _HEAD + [_P] * 7 + [_I, _D] + [_P] * 5,
    "alf_midpoint_vjp": _HEAD + [_P, _P, _I, _D, _P, _P],
    "alf_update_vjp": _HEAD + [_P, _P, _P, _I, _D, _P, _P, _P],
    "alf_inverse": _HEAD + [_P, _P, _P, _P, _I, _D, _P, _P, _P],
    "alf_inverse_update": _HEAD + [_P, _P, _P, _P, _I, _D, _P, _P, _P],
}

_FNS: Dict[str, object] = {}


# The per-row calls among LAUNCHES (a (B,) h).
ROW_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        ROW_LAUNCHES[k] = 0


# The vector kernels, in the order of the C entry alf_vec_kernel_info's
# op codes.
VEC_KERNELS = ("alf_midpoint", "alf_update", "alf_midpoint_vjp",
               "alf_bwd_pre", "alf_bwd_post", "alf_update_vjp", "alf_inverse")


def vec_kernel_info(name: str, dtype: torch.dtype, lib=None
                    ) -> Dict[str, int]:
    """Registers a thread, local (spilled) bytes a thread and resident
    blocks of 256 threads per SM on the current device of the vector
    kernel ``name`` (its all-aligned scalar-h instantiation for storage
    ``dtype``), from ``cudaFuncGetAttributes`` and the occupancy API; of
    the library ``lib`` (a ``ctypes.CDLL``) if given, else the built
    one."""
    if lib is None:
        from repro_torch.kernels import build
        lib = build.load(NAME)
    info = lib.alf_vec_kernel_info
    info.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    info.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = info(_DTYPE_CODE[dtype], VEC_KERNELS.index(name),
              *[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError(f"alf_vec_kernel_info({name}): CUDA error {rc}")
    return dict(zip(("regs", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels import build
        lib = build.load(NAME)
        for sym, argtypes in _ARGTYPES.items():
            f = getattr(lib, sym)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[sym] = f
        fn = _FNS[name]
    return fn


# The compute dtype of h for each storage dtype.
_H_DTYPE = {torch.float32: torch.float32, torch.float64: torch.float64,
            torch.bfloat16: torch.float32}


def _check(name: str, h: torch.Tensor, *bufs: torch.Tensor):
    """Validate the buffers of one launch: one CUDA device, one supported
    dtype, one size, flat and contiguous, and h a 0-d or a contiguous
    (B,) tensor of the compute dtype on that device, B dividing n (the
    kernel reads every buffer over n elements and h at its dtype's
    width). Returns (dtype code, device index, n, row length), the row
    length 0 for a 0-d h."""
    b0 = bufs[0]
    if not b0.is_cuda:
        raise ValueError(f"{name}: buffers must be CUDA tensors, got "
                         f"{b0.device}")
    dt = b0.dtype
    code = _DTYPE_CODE.get(dt)
    if code is None:
        raise TypeError(f"{name}: storage dtype {dt} is not one of "
                        f"{tuple(_DTYPE_CODE)}")
    dev, n = b0.get_device(), b0.numel()
    for b in bufs:
        if (b.dtype != dt or b.get_device() != dev or b.dim() != 1
                or b.numel() != n or not b.is_contiguous()):
            raise ValueError(f"{name}: every buffer must be a flat "
                             "contiguous tensor of one dtype, size and "
                             "device")
    hd = _H_DTYPE[dt]
    rows = h.dim() == 1 and h.numel() > 0 and n % h.numel() == 0
    if (not (h.dim() == 0 or (rows and h.is_contiguous()))
            or h.dtype != hd or h.get_device() != dev):
        raise ValueError(f"{name}: h must be a 0-d or (B,) {hd} tensor "
                         f"on {b0.device} with B dividing {n}, got "
                         f"{h.dtype} {tuple(h.shape)} on {h.device}")
    return code, dev, n, n // h.numel() if rows else 0


def _launch(name: str, checked, *args) -> None:
    """One launch on the device's current stream (a raw handle: no Python
    stream object per call) over the n elements of ``checked``; ``args``
    are the input pointers (h last), the row length ``checked[3]``, sign
    or eta, and the output pointers."""
    code, dev, n, row = checked
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = _fn(name)(code, n, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
    if row:
        ROW_LAUNCHES[name] += 1


def midpoint_call(z: torch.Tensor, v: torch.Tensor, h: torch.Tensor, *,
                  sign: float = 1.0) -> torch.Tensor:
    """k1 = z + sign * v * h/2."""
    checked = _check("alf_midpoint", h, z, v)
    k1 = torch.empty_like(z)
    _launch("alf_midpoint", checked, z.data_ptr(), v.data_ptr(),
            h.data_ptr(), checked[3], float(sign), k1.data_ptr())
    return k1


def update_call(k1, v, u1, h, *, eta: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_out, v_out) of the forward tail."""
    checked = _check("alf_update", h, k1, v, u1)
    z_out, v_out = torch.empty_like(k1), torch.empty_like(v)
    _launch("alf_update", checked, k1.data_ptr(), v.data_ptr(),
            u1.data_ptr(), h.data_ptr(), checked[3], float(eta),
            z_out.data_ptr(), v_out.data_ptr())
    return z_out, v_out


def bwd_pre_call(z, v, a_z, a_v, h, *, eta: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k1, cot_u1) of the head of one MALI backward step."""
    checked = _check("alf_bwd_pre", h, z, v, a_z, a_v)
    k1, cot_u1 = torch.empty_like(z), torch.empty_like(a_z)
    _launch("alf_bwd_pre", checked, *_ptrs(z, v, a_z, a_v, h), checked[3],
            float(eta), *_ptrs(k1, cot_u1))
    return k1, cot_u1


def bwd_post_call(k1, v_out, u1, a_z, a_v, dk1, h, *, eta: float = 1.0
                  ) -> Tuple[torch.Tensor, ...]:
    """(z_prev, v_prev, dz_prev, dv_prev) of the tail of one MALI backward
    step."""
    checked = _check("alf_bwd_post", h, k1, v_out, u1, a_z, a_v, dk1)
    outs = [torch.empty_like(k1) for _ in range(4)]
    _launch("alf_bwd_post", checked,
            *_ptrs(k1, v_out, u1, a_z, a_v, dk1, h), checked[3],
            float(eta), *_ptrs(*outs))
    return tuple(outs)


def midpoint_vjp_call(g: torch.Tensor, h: torch.Tensor, *,
                      sign: float = 1.0) -> torch.Tensor:
    """v_bar = sign * g * h/2, the midpoint's v-cotangent."""
    checked = _check("alf_midpoint_vjp", h, g)
    v_bar = torch.empty_like(g)
    _launch("alf_midpoint_vjp", checked, *_ptrs(g, h), checked[3],
            float(sign), *_ptrs(v_bar))
    return v_bar


def update_vjp_call(g_z, g_v, h, *, eta: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v_bar, u1_bar) cotangents of the forward tail."""
    checked = _check("alf_update_vjp", h, g_z, g_v)
    v_bar, u1_bar = torch.empty_like(g_v), torch.empty_like(g_v)
    _launch("alf_update_vjp", checked, *_ptrs(g_z, g_v, h), checked[3],
            float(eta), *_ptrs(v_bar, u1_bar))
    return v_bar, u1_bar


def inverse_call(z_out, v_out, u1, h, *, eta: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_in, v_in) of the full psi^-1, re-deriving the midpoint."""
    checked = _check("alf_inverse", h, z_out, v_out, u1)
    z_in, v_in = torch.empty_like(z_out), torch.empty_like(v_out)
    _launch("alf_inverse", checked, *_ptrs(z_out, v_out, u1, h), checked[3],
            float(eta), *_ptrs(z_in, v_in))
    return z_in, v_in


def inverse_update_call(k1, v_out, u1, h, *, eta: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_in, v_in) of psi^-1's tail, given the midpoint k1."""
    checked = _check("alf_inverse_update", h, k1, v_out, u1)
    z_in, v_in = torch.empty_like(k1), torch.empty_like(v_out)
    _launch("alf_inverse_update", checked, *_ptrs(k1, v_out, u1, h),
            checked[3], float(eta), *_ptrs(z_in, v_in))
    return z_in, v_in
