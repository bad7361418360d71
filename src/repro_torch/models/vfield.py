"""Concat-time MLP vector fields for continuous flows
(:mod:`repro_torch.cnf`).

The FFJORD field shape: ``f([z, t]) -> dz/dt`` through a tanh MLP, on a
single state of shape (..., dim); batch axes broadcast through the
matmuls. Only ops with forward-mode rules (matmul, tanh, cat), because
the CNF's trace estimators take JVPs of the field inside ``vmap`` and
MALI's backward takes a VJP of that.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device

Pytree = Any


def init_mlp_vfield(generator: torch.Generator, dim: int, hidden: int = 64,
                    depth: int = 2, scale: float = 0.5,
                    device=None) -> Dict[str, Any]:
    """Parameters of a concat-time tanh MLP field: (dim+1) -> hidden^depth
    -> dim, drawn from ``generator`` (which must live on ``device``,
    default the CUDA card). The output layer is zero so the flow starts
    at the identity map (logdet 0, the stable CNF init)."""
    dev = resolve_device(device)
    widths = [dim + 1] + [hidden] * depth + [dim]
    layers = []
    for i in range(len(widths) - 1):
        fan_in, fan_out = widths[i], widths[i + 1]
        if i == len(widths) - 2:
            w = torch.zeros((fan_in, fan_out), device=dev)
        else:
            w = (scale * torch.randn((fan_in, fan_out), generator=generator,
                                     device=dev) / fan_in ** 0.5)
        layers.append({"w": w, "b": torch.zeros((fan_out,), device=dev)})
    return {"layers": layers}


def mlp_vfield(params: Pytree, z: torch.Tensor, t) -> torch.Tensor:
    """f(params, z, t) -> dz/dt for z of shape (..., dim); time enters as
    an extra input column, broadcast over the batch axes."""
    t = torch.as_tensor(t, dtype=z.dtype, device=z.device)
    h = torch.cat([z, t.expand(z.shape[:-1] + (1,))], -1)
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    return h @ layers[-1]["w"] + layers[-1]["b"]
