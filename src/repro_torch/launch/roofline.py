"""The roofline of a counted step on one NVIDIA card.

The port of the JAX package's ``repro.launch.roofline``, whose terms are
a TPU v5e's. Here the terms are one card's, from :data:`CARDS` (keyed by
the name ``nvidia-smi`` and ``torch.cuda.get_device_name`` give), the one
table that ``chip_smoke.py``'s kernel bounds read too:

    compute = bf16 FLOPs / the dense bf16 tensor-core rate
              + other FLOPs / the f32 rate (no TF32)
    memory  = bytes / the HBM rate

FLOPs and bytes are one rank's, counted by :mod:`repro_torch.launch.cost`
(every aten op a step dispatches, a kernel op by its declared work). The
bound of a step is the larger of the two terms; ``bottleneck`` names it.

Collectives: :class:`CollectiveStats` sums a rank's wire bytes by kind
and mesh axis with the ring algorithm's multipliers (all-reduce
2(n-1)/n, all-gather / reduce-scatter / all-to-all (n-1)/n, permute 1)
over the whole tensor each collective reduces or makes. Their seconds
are not reckoned: no run of the port over NVLink or NCCL has been
measured (ROADMAP queue 1 item 13), so ``t_collective_s`` is None with
that reason, and the bottleneck is compute or memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

COLLECTIVE_ITEM = "ROADMAP queue 1 item 13"
NO_COLLECTIVE_TERM = (
    "collective seconds not reckoned: no multi-card NCCL/NVLink run of the "
    f"port has been measured ({COLLECTIVE_ITEM})")


class CardRates(NamedTuple):
    """One card's peak rates: HBM bytes/s, f32 FLOP/s (outside the tensor
    cores), dense bf16 tensor-core FLOP/s."""
    hbm: float
    f32: float
    bf16: float


# NVIDIA data sheets (SXM unless named), matched in this order by
# substring of the card's name: the H100 variants before the bare name.
CARDS = (("H200", CardRates(4.8e12, 67e12, 989e12)),
         ("H100 NVL", CardRates(3.9e12, 60e12, 835e12)),
         ("H100 PCIe", CardRates(2.0e12, 51e12, 756e12)),
         ("H100", CardRates(3.35e12, 67e12, 989e12)))

H100 = dict(CARDS)["H100"]


def card_rates(name: str) -> CardRates:
    """The rates of the card named ``name`` (e.g. "NVIDIA H100 80GB
    HBM3"); ``KeyError`` for a card the table lacks."""
    for key, rates in CARDS:
        if key in name:
            return rates
    raise KeyError(f"no rates known for card {name!r}")


def compute_seconds(flops_by_class: Dict[str, float],
                    rates: CardRates = H100) -> float:
    """FLOPs by class (``"bf16"`` at the tensor-core rate, any other at
    the f32 rate) over the card's rates."""
    return sum(f / (rates.bf16 if cls == "bf16" else rates.f32)
               for cls, f in flops_by_class.items())


def _wire_multiplier(kind: str, group: int) -> float:
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (g - 1) / g
    return 1.0  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    """A rank's collectives: wire bytes in all, and calls and wire bytes
    by ``kind`` and by ``kind@axis``."""
    wire_bytes_per_chip: float = 0.0
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, axis: str, group: int, nbytes: float) -> None:
        """One collective of ``kind`` ("all-reduce", ...) over the mesh
        axis ``axis`` (a group of ``group`` ranks) on a tensor of
        ``nbytes`` (whole: the one reduced, or the gathered result)."""
        wire = nbytes * _wire_multiplier(kind, group)
        self.wire_bytes_per_chip += wire
        for key in (kind, f"{kind}@{axis}"):
            self.op_counts[key] = self.op_counts.get(key, 0) + 1
            self.op_bytes[key] = self.op_bytes.get(key, 0.0) + wire


@dataclasses.dataclass
class Roofline:
    """The roofline of one rank's step. ``flops`` and ``hbm_bytes`` are
    the rank's; ``flops_bf16`` is the part of ``flops`` on the tensor
    cores; ``model_flops`` is global (all ranks)."""
    flops: float
    hbm_bytes: float
    coll: CollectiveStats
    chips: int
    model_flops: float = 0.0
    flops_bf16: float = 0.0
    rates: CardRates = H100

    @property
    def t_compute(self) -> float:
        return compute_seconds({"bf16": self.flops_bf16,
                                "f32": self.flops - self.flops_bf16},
                               self.rates)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.rates.hbm

    @property
    def t_collective(self) -> Optional[float]:
        return None                  # NO_COLLECTIVE_TERM

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_flops_ratio(self) -> float:
        # model_flops is a GLOBAL number; flops is per-rank
        return (self.model_flops / (self.flops * self.chips)
                if self.flops else 0.0)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_wire_bytes_per_chip": self.coll.wire_bytes_per_chip,
            "collective_ops": self.coll.op_counts,
            "collective_bytes_by_op": self.coll.op_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_collective_reason": NO_COLLECTIVE_TERM,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "flops_bf16": self.flops_bf16,
        }


def analyze(counts, chips: int = 1, model_flops: float = 0.0,
            rates: CardRates = H100) -> Roofline:
    """The roofline of a step counted by :class:`repro_torch.launch.cost.
    OpCounter` (``counts``: its ``flops``, ``flops_bf16``, ``bytes`` and
    ``collectives``)."""
    return Roofline(flops=counts.flops, hbm_bytes=counts.bytes,
                    coll=counts.collectives, chips=chips,
                    model_flops=model_flops, flops_bf16=counts.flops_bf16,
                    rates=rates)


def model_flops_estimate(cfg, cell, n_params_active: float,
                         ode_evals: int) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (fwd-only),
    scaled by the number of ODE f-evals per block (paper technique makes
    each block ode_evals-x deeper in compute at equal params)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    per_token = (6.0 if cell.kind == "train" else 2.0) * n_params_active
    return per_token * tokens * ode_evals


__all__ = ["CARDS", "CardRates", "H100", "card_rates", "compute_seconds",
           "CollectiveStats", "Roofline", "analyze",
           "model_flops_estimate", "NO_COLLECTIVE_TERM", "COLLECTIVE_ITEM"]
