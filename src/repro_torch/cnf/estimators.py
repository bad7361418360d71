"""Trace-estimator axis of the CNF likelihood (paper Sec 4.4 / FFJORD).

The instantaneous change of variables needs ``tr(df/dz)`` along the flow:

* :class:`Exact` — the sum of the d basis-vector JVPs (``torch.func.jvp``
  vmapped over the identity): exact, for toy dimensions.
* :class:`Hutchinson` — the stochastic estimator ``eps^T (df/dz) eps``
  with Rademacher or Gaussian probes: one JVP per state, the image-scale
  setting.

The probe is drawn once per solve (:meth:`TraceEstimator.init_noise`, from
an explicit ``torch.Generator``) and rides in the solve's state as a
component with zero dynamics, so adaptive re-evaluations of a trial step
see the same noise and the estimate is a function of (params, x, probe).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch


class TraceEstimator:
    """Base of the trace-estimation axis. Subclasses are frozen
    dataclasses implementing:

    * ``init_noise(generator, x)`` — the per-solve probe shaped like
      ``x`` (``None`` for deterministic estimators);
    * ``value_and_trace(f, z, eps)`` — one dynamics evaluation and the
      trace estimate at a single state ``z`` of shape (d,);
    * ``trace_fevals(dim)`` — the f-eval equivalents the trace costs per
      dynamics evaluation.
    """

    name: str = "?"

    def init_noise(self, generator: Optional[torch.Generator],
                   x: torch.Tensor) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def value_and_trace(self, f: Callable[[torch.Tensor], torch.Tensor],
                        z: torch.Tensor, eps: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def trace_fevals(self, dim: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Exact(TraceEstimator):
    """Exact ``tr(df/dz)``: the d basis vectors pushed through one JVP
    each, vmapped (O(d) f-eval equivalents per state; the oracle the
    Hutchinson estimator is checked against)."""

    name = "exact"

    def init_noise(self, generator, x):
        return None  # deterministic: no probe in the solve's state

    def value_and_trace(self, f, z, eps):
        basis = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)

        def diag(e):
            return torch.sum(e * torch.func.jvp(f, (z,), (e,))[1])

        return f(z), torch.sum(torch.func.vmap(diag)(basis))

    def trace_fevals(self, dim: int) -> int:
        return dim


@dataclasses.dataclass(frozen=True)
class Hutchinson(TraceEstimator):
    """Stochastic trace ``eps^T (df/dz) eps``, unbiased for any probe of
    identity covariance: ``dist='rademacher'`` (default; the least
    variance among sign probes) or ``'gaussian'``. One JVP per state
    whatever d."""

    dist: str = "rademacher"

    name = "hutchinson"

    def __post_init__(self):
        if self.dist not in ("rademacher", "gaussian"):
            raise ValueError(
                f"Hutchinson(dist={self.dist!r}): pass 'rademacher' or "
                "'gaussian'")

    def init_noise(self, generator, x):
        if generator is None:
            raise ValueError(
                "Hutchinson trace estimation draws one probe per solve: "
                "pass generator= (a torch.Generator on the data's device) "
                "to log_prob/sample, or use estimator=Exact()")
        if self.dist == "gaussian":
            return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                               device=x.device)
        signs = torch.randint(0, 2, x.shape, generator=generator,
                              dtype=x.dtype, device=x.device)
        return 2.0 * signs - 1.0

    def value_and_trace(self, f, z, eps):
        fz, jv = torch.func.jvp(f, (z,), (eps,))
        return fz, torch.sum(eps * jv)

    def trace_fevals(self, dim: int) -> int:
        return 1


TRACE_ESTIMATORS = {
    "exact": Exact(),
    "hutchinson": Hutchinson(),
    "hutchinson_gaussian": Hutchinson(dist="gaussian"),
}


def get_estimator(est: Union[str, TraceEstimator]) -> TraceEstimator:
    """An estimator object, or the registry's entry for a key."""
    if isinstance(est, TraceEstimator):
        return est
    if est in TRACE_ESTIMATORS:
        return TRACE_ESTIMATORS[est]
    raise ValueError(f"unknown trace estimator {est!r}; available: "
                     f"{tuple(sorted(TRACE_ESTIMATORS))}")
