"""Shared model components: norms, rotary embeddings, init, dtype policy.

The port of the JAX package's ``repro.models.common``. Initializers take
an explicit ``torch.Generator`` and device (the JAX package threads PRNG
keys); the two give different numbers from the same seed, so the tests
hand both packages the same numpy weights instead.

``rmsnorm`` goes through the fused RMSNorm op: on a CUDA tensor the
hand-written kernel (``kernels/rmsnorm``), on a CPU tensor its plain
version; ``backend="reference"`` runs the plain version on any device.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core.alf import check_backend
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

Pytree = Any


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ('bfloat16', 'float32') as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Initialization
#
# The layers' init functions (``*_inits``) return a tree of leaf
# initializers, one zero-argument callable per parameter, in the JAX
# package's layout; ``materialize`` calls them in tree order. This lets
# ``transformer.init_blocks`` draw a stacked period one leaf at a time, so
# init holds the weights plus one leaf's temporaries, never a period twice.
# ---------------------------------------------------------------------------

Init = Callable[[], torch.Tensor]


def materialize(inits: Pytree) -> Pytree:
    """Call every leaf initializer of a tree, in tree order."""
    return pytree.tree_map(lambda make: make(), inits)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               device, fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal on [-2, 2] with 1/sqrt(fan_in) scale (standard LM
    init), drawn in float32 and cast to ``dtype``. Scaled in place: at a
    Jamba expert leaf ([16, 4096, 14336]) an out-of-place product would
    hold another 3.8 GB of float32. On the meta device only the shape and
    dtype are made (:func:`embed_init`)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(fan_in ** -0.5).to(dtype)


def dense_inits(generator: torch.Generator, shape: Tuple[int, ...], dtype,
                device, fan_in: Optional[int] = None) -> Init:
    """The leaf initializer of :func:`dense_init`."""
    return lambda: dense_init(generator, shape, dtype, device, fan_in)


def full_inits(shape: Tuple[int, ...], value: float, dtype, device) -> Init:
    """The leaf initializer of a constant tensor."""
    return lambda: torch.full(shape, value, dtype=dtype, device=device)


def embed_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               device) -> torch.Tensor:
    """Normal, scale 0.02, drawn in float32 and cast to ``dtype``. Scaled
    in place, as :func:`dense_init`: init holds one float32 copy of the
    table beside the weights, not two. On the meta device only the shape
    and dtype are made: the draws' meta kernels (``randn``, and in some
    torch versions ``erfinv_``) import ``torch._dynamo`` and sympy,
    seconds a process, where the specs allocate nothing."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_inits(d: int, dtype, device) -> Pytree:
    return {"scale": full_inits((d,), 1.0, dtype, device)}


def rmsnorm(params: Pytree, x: torch.Tensor, eps: float = 1e-6,
            backend: str = "cuda") -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, f32 reduction, in x's dtype:
    one fused-kernel launch on the card (``backend="cuda"``) or the plain
    version (``backend="reference"``)."""
    check_backend(backend)
    if backend == "cuda":
        return rmsnorm_ops.rmsnorm(x, params["scale"], eps)
    return rmsnorm_ref(x, params["scale"], eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python number: a 0-d tensor made from it on the card
    # would be a host-to-device copy, which syncs the stream
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32,
                             device=device) / d_head
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, n_heads, d_head]; positions: [..., seq] (int). The
    rotation is computed in float32 and cast back to x's dtype."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)        # [d_head/2]
    angles = positions[..., :, None].float() * freqs          # [..., S, d/2]
    cos = torch.cos(angles)[..., :, None, :]                  # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": torch.relu}

__all__ = ["torch_dtype", "Init", "materialize", "dense_init",
           "dense_inits", "full_inits", "embed_init", "rmsnorm_inits",
           "rmsnorm", "softcap", "rope_frequencies", "apply_rope", "silu",
           "gelu", "ACTIVATIONS"]
