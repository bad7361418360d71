"""repro_torch.serve — continuous-batching ODE serving on top of ``solve()``,
the port of the JAX package's ``repro.serve``.

Request queue + admission control (:mod:`scheduler`), chunked re-dispatch
engines (:mod:`engine`; on the card the chunk lane runs the per-row ALF
kernels), the dense-interpolant cache (:mod:`cache`), Poisson load
generation (:mod:`loadgen`) and metrics (:mod:`metrics`).
"""
from .cache import CACHE_POLICIES, CachePolicy, InterpolantCache, LRU, NoCache
from .engine import (ENGINES, ContinuousBatchingEngine, EngineConfig,
                     SlotBatch, StaticFleetEngine, chunk_transition,
                     dispatch_chunk)
from .loadgen import (decay_dynamics, hot_trajectory_requests,
                      mixed_stiffness_requests, poisson_arrivals)
from .metrics import RequestRecord, ServeReport, format_report, percentile, \
    summarize
from .scheduler import (ADMISSION_POLICIES, SCHEDULING_POLICIES, AdmitAll,
                        AdmissionPolicy, BoundedQueue, FIFO, Request,
                        RequestConfig, Scheduler, SchedulingPolicy,
                        ShortestSpanFirst)

__all__ = [
    "ADMISSION_POLICIES", "AdmissionPolicy", "AdmitAll", "BoundedQueue",
    "CACHE_POLICIES", "CachePolicy", "ContinuousBatchingEngine",
    "ENGINES", "EngineConfig", "FIFO", "InterpolantCache", "LRU",
    "NoCache", "Request", "RequestConfig", "RequestRecord",
    "SCHEDULING_POLICIES", "Scheduler", "SchedulingPolicy", "ServeReport",
    "ShortestSpanFirst", "SlotBatch", "StaticFleetEngine",
    "chunk_transition", "decay_dynamics", "dispatch_chunk",
    "format_report", "hot_trajectory_requests", "mixed_stiffness_requests",
    "percentile", "poisson_arrivals", "summarize",
]
