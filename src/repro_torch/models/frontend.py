"""Stub modality frontends for the [audio]/[vlm] archs.

The port of the JAX package's ``repro.models.frontend``. The transformer
backbone is what the configs specify; the modality frontend (EnCodec for
musicgen, InternViT for internvl2) is a stub: ``launch.specs.input_specs``
gives the precomputed frame/patch embeddings' shapes and dtypes, and these
helpers draw synthetic ones for smoke runs and examples.

They draw from an explicit ``torch.Generator`` on the device they compute
on (default: the CUDA card; ``device="cpu"`` with a CPU generator runs
them on the CPU). The JAX package draws from a PRNG key, so the two give
different numbers: they agree in shape, dtype, range and scale.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from .common import torch_dtype


def synthetic_frame_embeddings(generator: torch.Generator, cfg: ModelConfig,
                               batch: int, seq_len: int,
                               device=None) -> torch.Tensor:
    """Stand-in for EnCodec frame / ViT patch embeddings: [B, S, d_model],
    a standard normal draw times 0.02 in ``cfg.compute_dtype``."""
    x = torch.randn((batch, seq_len, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=resolve_device(device))
    return (x * 0.02).to(torch_dtype(cfg.compute_dtype))


def synthetic_labels(generator: torch.Generator, cfg: ModelConfig,
                     batch: int, seq_len: int, device=None) -> torch.Tensor:
    """Uniform int32 labels in [0, vocab_size): [B, S]."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, dtype=torch.int32,
                         device=resolve_device(device))


__all__ = ["synthetic_frame_embeddings", "synthetic_labels"]
