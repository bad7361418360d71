"""Where the port computes by default: the CUDA card.

Every factory and converter of the package takes ``device=None``, which
means :func:`default_device`. There is no silent CPU fallback: with no GPU
present, asking for the default device raises, and a caller who wants the
CPU (the tests) passes ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch computes on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
