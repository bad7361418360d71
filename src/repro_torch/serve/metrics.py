"""Serving metrics: per-request records and the aggregate load report (the
JAX package's ``repro.serve.metrics``, with identical fields and formats).

Everything is measured on the engine's *virtual clock* (wall-calibrated:
it advances by measured dispatch time and jumps over idle gaps), so the
numbers compose consistently:

* **latency** — ``completion - arrival`` per request; p50/p99 over the
  run. Queue wait is included: a request that sat behind a straggler pays
  for it here, which is exactly the effect continuous batching removes.
* **solves_per_s** — completed requests / busy duration.
* **fevals_per_request** — mean dynamics evaluations per request (cache
  hits contribute 0, which is the point of the interpolant cache).
* **backfill_occupancy** — mean fraction of batch slots active at
  dispatch, sampled once per chunk round. The static fleet's occupancy
  decays as stragglers strand finished rows; continuous batching holds it
  near 1 under load.
* **cache_hit_rate** — interpolant-cache hits / lookups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

__all__ = ["RequestRecord", "ServeReport", "percentile", "summarize",
           "format_report"]


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One served request's accounting row.

    ``lane`` is how it was served: ``batch`` (chunked slots), ``dense``
    (per-request dense solve), ``eval`` (dense solve + interpolant
    queries) or ``event``. ``completed=False`` marks a budget-exhausted
    solve whose end state was returned anyway (truncated span).
    """
    rid: int
    arrival: float
    completion: float
    n_fevals: int
    n_accepted: int
    completed: bool
    lane: str = "batch"
    cache_hit: bool = False

    @property
    def latency(self) -> float:
        return self.completion - self.arrival


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default) over a small
    host-side list; q in [0, 100]. Returns nan for an empty input."""
    if not values:
        return math.nan
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile: q must be in [0, 100], got {q}")
    xs = sorted(values)
    pos = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Aggregate metrics for one serving run (one engine, one workload)."""
    engine: str
    n_requests: int
    n_completed: int
    n_rejected: int
    duration_s: float
    p50_latency_s: float
    p99_latency_s: float
    mean_latency_s: float
    solves_per_s: float
    fevals_per_request: float
    backfill_occupancy: float
    rounds: int
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    cache_hit_rate: float


def summarize(engine: str, records: List[RequestRecord], *, duration: float,
              occupancy: Sequence[float], rounds: int, cache=None,
              n_rejected: int = 0) -> ServeReport:
    """Fold a run's records into a :class:`ServeReport`."""
    lat = [r.latency for r in records]
    n_done = sum(1 for r in records if r.completed)
    mean_lat = sum(lat) / len(lat) if lat else math.nan
    mean_occ = (sum(occupancy) / len(occupancy)) if occupancy else 0.0
    fevals = [r.n_fevals for r in records]
    return ServeReport(
        engine=engine,
        n_requests=len(records),
        n_completed=n_done,
        n_rejected=n_rejected,
        duration_s=duration,
        p50_latency_s=percentile(lat, 50.0),
        p99_latency_s=percentile(lat, 99.0),
        mean_latency_s=mean_lat,
        solves_per_s=(n_done / duration) if duration > 0 else 0.0,
        fevals_per_request=(sum(fevals) / len(fevals)) if fevals
        else math.nan,
        backfill_occupancy=mean_occ,
        rounds=rounds,
        cache_hits=cache.hits if cache is not None else 0,
        cache_misses=cache.misses if cache is not None else 0,
        cache_evictions=cache.evictions if cache is not None else 0,
        cache_hit_rate=cache.hit_rate if cache is not None else 0.0,
    )


def format_report(report: ServeReport,
                  title: Optional[str] = None) -> str:
    """Human-readable multi-line rendering (the CLI prints this)."""
    head = title if title is not None else f"serve[{report.engine}]"
    lines = [
        f"== {head} ==",
        f"  requests     {report.n_requests} "
        f"({report.n_completed} completed, {report.n_rejected} rejected)",
        f"  duration     {report.duration_s:.3f} s over "
        f"{report.rounds} dispatch rounds",
        f"  latency      p50 {report.p50_latency_s * 1e3:.2f} ms | "
        f"p99 {report.p99_latency_s * 1e3:.2f} ms | "
        f"mean {report.mean_latency_s * 1e3:.2f} ms",
        f"  throughput   {report.solves_per_s:.1f} solves/s | "
        f"{report.fevals_per_request:.1f} f-evals/request",
        f"  occupancy    {report.backfill_occupancy * 100.0:.1f}% "
        f"of batch slots busy",
    ]
    lookups = report.cache_hits + report.cache_misses
    if lookups:
        lines.append(
            f"  cache        {report.cache_hits}/{lookups} hits "
            f"({report.cache_hit_rate * 100.0:.1f}%), "
            f"{report.cache_evictions} evictions")
    return "\n".join(lines)
