"""Load generation: Poisson arrivals over a stiffness-heterogeneous mix.

The serving story only becomes measurable under realistic traffic, which
for ODE inference has two defining features this module reproduces:

* **Poisson arrivals** — independent requesters, exponential inter-arrival
  gaps at a chosen offered rate;
* **heterogeneous service times** — per-request decay rates drawn
  log-uniformly across decades (the pattern from
  ``benchmarks/batched_throughput.py``): a stiff row needs ~10-100x the
  accepted steps of a tame one, which is exactly the straggler regime
  continuous batching exists for. The decay rate rides *inside the state
  pytree* (``d lam/dt = 0``), so one vector field serves every
  stiffness.

All randomness flows through a caller-supplied ``numpy.random.Generator``
— the same seed yields the identical request stream, so engines can be
compared on literally the same trace and tests are deterministic. The
draws are the JAX package's ``repro.serve.loadgen``, call for call, so
one seed gives both packages the same trace, bit for bit; ``z0`` stays
numpy (the engine uploads it).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .scheduler import Request, RequestConfig

__all__ = ["decay_dynamics", "poisson_arrivals",
           "mixed_stiffness_requests", "hot_trajectory_requests"]


def decay_dynamics(params, z, t):
    """Per-sample exponential decay with the rate in the state:
    ``dy/dt = -lam * y``, ``dlam/dt = 0``."""
    del params, t
    return {"y": -z["lam"] * z["y"], "lam": torch.zeros_like(z["lam"])}


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> np.ndarray:
    """``n`` arrival stamps of a Poisson process at ``rate`` arrivals per
    second, starting at t=0 (first stamp is one exponential gap in)."""
    if rate <= 0.0:
        raise ValueError(f"poisson_arrivals: rate must be > 0, got {rate}")
    if n < 0:
        raise ValueError(f"poisson_arrivals: n must be >= 0, got {n}")
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return np.cumsum(gaps)


def mixed_stiffness_requests(
        rng: np.random.Generator, n: int, *,
        rate: float = 50.0,
        d_state: int = 8,
        lam_decades: Tuple[float, float] = (0.0, 2.0),
        t1: float = 1.0,
        rtol: float = 1e-3,
        atol: float = 1e-4,
        max_steps: int = 512,
        arrivals: Optional[Sequence[float]] = None) -> List[Request]:
    """Build ``n`` chunk-lane requests with Poisson arrivals and decay
    rates log-uniform over ``lam_decades`` (default: two decades, 1-100).

    Each request's state is ``{"y": N(0,1)^d, "lam": 10^U(lo,hi)}`` —
    stiffness varies per request, span/tolerances are shared, so service
    time is the only heterogeneity and engine comparisons isolate the
    scheduling effect. Pass ``arrivals`` to pin stamps explicitly (e.g. to
    replay one trace through two engines after the generator has moved).
    """
    lo, hi = lam_decades
    if arrivals is None:
        arrivals = poisson_arrivals(rng, rate, n)
    elif len(arrivals) != n:
        raise ValueError(
            f"mixed_stiffness_requests: got {len(arrivals)} arrival "
            f"stamps for n={n} requests")
    config = RequestConfig(t0=0.0, t1=t1, rtol=rtol, atol=atol,
                           max_steps=max_steps)
    requests = []
    for i in range(n):
        lam = 10.0 ** rng.uniform(lo, hi)
        z0 = {"y": rng.standard_normal(d_state).astype(np.float32),
              "lam": np.full((d_state,), lam, dtype=np.float32)}
        requests.append(Request(z0=z0, config=config,
                                arrival=float(arrivals[i])))
    return requests


def hot_trajectory_requests(
        rng: np.random.Generator, *,
        n_repeats: int = 8,
        d_state: int = 8,
        lam: float = 5.0,
        t1: float = 1.0,
        rtol: float = 1e-3,
        atol: float = 1e-4,
        max_steps: int = 512,
        arrival: float = 0.0,
        n_eval_ts: int = 4) -> List[Request]:
    """One "hot" trajectory queried ``1 + n_repeats`` times: identical
    (config, z0) dense requests with differing ``eval_ts``. The first pays
    the dense solve and fills the interpolant cache; every repeat should
    hit and report **zero** incremental f-evals — the cache acceptance
    criterion, made into a workload."""
    config = RequestConfig(t0=0.0, t1=t1, rtol=rtol, atol=atol,
                           max_steps=max_steps, dense=True)
    z0 = {"y": rng.standard_normal(d_state).astype(np.float32),
          "lam": np.full((d_state,), float(lam), dtype=np.float32)}
    t_lo, t_hi = (0.0, t1) if t1 > 0 else (t1, 0.0)
    requests = []
    for _ in range(1 + n_repeats):
        eval_ts = np.sort(rng.uniform(t_lo, t_hi,
                                      n_eval_ts)).astype(np.float32)
        requests.append(Request(z0={k: v.copy() for k, v in z0.items()},
                                config=config, arrival=arrival,
                                eval_ts=eval_ts))
    return requests
