"""CNF training objectives: NLL in nats, bits/dim, kinetic regulariser.

bits/dim is the paper's Sec 4.4 image metric: for pixels quantized to
``n_bins`` levels and scaled to [0, 1], the dequantized continuous NLL
converts as ``bpd = nll_nats / (dim * ln 2) + log2(n_bins)``.
"""
from __future__ import annotations

import math

import torch

from .flow import CNFResult


def nll_nats(result: CNFResult) -> torch.Tensor:
    """Mean negative log likelihood in nats."""
    return -torch.mean(result.logp)


def bits_per_dim(result: CNFResult, dim: int,
                 n_bins: int = 256) -> torch.Tensor:
    """Mean NLL in bits per dimension for ``n_bins``-quantized data scaled
    to [0, 1] (paper Table 3 units)."""
    return nll_nats(result) / (dim * math.log(2.0)) + math.log2(n_bins)


def cnf_loss(result: CNFResult, kinetic_reg: float = 0.0) -> torch.Tensor:
    """Training objective: mean NLL + the RNODE kinetic-energy regulariser
    (Finlay et al. 2020; the paper's Sec 4.4 uses 0.05 at image scale)."""
    loss = nll_nats(result)
    if kinetic_reg:
        loss = loss + kinetic_reg * torch.mean(result.kinetic)
    return loss
