"""Request types, admission control and the serving queue.

The serving loop decouples *arrival* from *dispatch*: a load generator (or
the CLI) stamps every :class:`Request` with an arrival time on the serving
clock, the :class:`Scheduler` releases requests into its queue as the clock
passes their stamps (applying an :class:`AdmissionPolicy` at release time),
and the engine (:mod:`repro_torch.serve.engine`) drains the queue in the
order chosen by a :class:`SchedulingPolicy` whenever batch slots free up.

Everything here is host-side Python over concrete values, the JAX
package's ``repro.serve.scheduler`` line for line. :class:`RequestConfig`
is part of the interpolant cache key, so equality and hashing are by
VALUE: a frozen dataclass of plain scalars gives exactly that.

Policies are small registered hierarchies (``ADMISSION_POLICIES``,
``SCHEDULING_POLICIES``); every registered policy implements its base's
whole interface (``tests/test_torch_serve.py`` checks it).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

Pytree = Any

_rid_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class RequestConfig:
    """Per-request solve configuration: span, tolerances, trial budget.

    Frozen dataclass of plain scalars => value-based ``__eq__``/``__hash__``
    for free, so a fresh-but-equal config maps to the same
    interpolant-cache bucket.

    ``dense=True`` requests dense output (``Solution.evaluate``-able) and
    routes the request through the engine's dense lane + interpolant cache
    instead of the chunked batch slots.
    """
    t0: float = 0.0
    t1: float = 1.0
    rtol: float = 1e-3
    atol: float = 1e-4
    max_steps: int = 512
    dense: bool = False

    def __post_init__(self):
        if float(self.t0) == float(self.t1):
            raise ValueError(
                f"RequestConfig: empty span t0 == t1 == {self.t0}; pass "
                "t1 > t0 (forward) or t1 < t0 (reverse time)")
        if self.rtol < 0.0 or self.atol < 0.0:
            raise ValueError(
                f"RequestConfig: tolerances must be non-negative, got "
                f"rtol={self.rtol}, atol={self.atol}")
        if self.rtol == 0.0 and self.atol == 0.0:
            raise ValueError("RequestConfig: rtol and atol cannot both be 0")
        if not isinstance(self.max_steps, int) or self.max_steps < 1:
            raise ValueError(
                f"RequestConfig: max_steps must be a positive integer, got "
                f"{self.max_steps!r}")
        # Normalize to plain floats so two configs built from np scalars /
        # Python floats with equal values hash identically.
        object.__setattr__(self, "t0", float(self.t0))
        object.__setattr__(self, "t1", float(self.t1))
        object.__setattr__(self, "rtol", float(self.rtol))
        object.__setattr__(self, "atol", float(self.atol))

    @property
    def span(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Request:
    """One serving request: its own initial state, span/tolerance config,
    arrival stamp, and optional dense/event extras.

    * plain request (default) — integrate ``z0`` over ``[t0, t1]``, return
      ``z(t1)``; served by the continuous-batching chunk lane;
    * ``config.dense=True`` and/or ``eval_ts`` — dense solve with
      interpolant caching; ``eval_ts`` additionally evaluates the cached
      trajectory at those times (repeat queries on a hot trajectory cost
      zero incremental f-evals);
    * ``event`` — a terminating :class:`repro_torch.core.Event`; served by a
      per-request event solve (the bisection/refine machinery needs the
      dense detection pass, which has no chunked-slot equivalent).
    """
    z0: Pytree
    config: RequestConfig = dataclasses.field(default_factory=RequestConfig)
    arrival: float = 0.0
    eval_ts: Optional[Any] = None
    event: Optional[Any] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    @property
    def wants_dense(self) -> bool:
        return self.config.dense or self.eval_ts is not None


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

class AdmissionPolicy:
    """Decides, at arrival time, whether a request enters the queue."""

    name: str = "?"

    def admit(self, queue_depth: int, request: Request) -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AdmitAll(AdmissionPolicy):
    """No admission control: every arrival is queued (benchmarks use this
    so offered load is identical across engines)."""

    name = "admit_all"

    def admit(self, queue_depth: int, request: Request) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class BoundedQueue(AdmissionPolicy):
    """Classic load shedding: reject arrivals once the queue holds
    ``max_depth`` waiting requests (the engine's in-flight slots do not
    count — a full fleet with an empty queue still admits)."""

    max_depth: int = 256

    name = "bounded"

    def __post_init__(self):
        if not isinstance(self.max_depth, int) or self.max_depth < 1:
            raise ValueError(
                f"BoundedQueue: max_depth must be a positive integer, got "
                f"{self.max_depth!r}")

    def admit(self, queue_depth: int, request: Request) -> bool:
        return queue_depth < self.max_depth


# ---------------------------------------------------------------------------
# Scheduling (queue ordering)
# ---------------------------------------------------------------------------

class SchedulingPolicy:
    """Orders the waiting queue when batch slots free up."""

    name: str = "?"

    def select(self, waiting: Sequence[Request], k: int) -> List[int]:
        """Indices (into ``waiting``) of up to ``k`` requests to dispatch
        next, in dispatch order."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FIFO(SchedulingPolicy):
    """Arrival order — the fairness baseline."""

    name = "fifo"

    def select(self, waiting: Sequence[Request], k: int) -> List[int]:
        return list(range(min(k, len(waiting))))


@dataclasses.dataclass(frozen=True)
class ShortestSpanFirst(SchedulingPolicy):
    """Shortest-job-first proxy: dispatch the smallest integration spans
    first (span length is the only service-time signal known before
    solving; ties fall back to arrival order). Trades worst-case fairness
    for p50 latency."""

    name = "shortest_span"

    def select(self, waiting: Sequence[Request], k: int) -> List[int]:
        order = sorted(range(len(waiting)),
                       key=lambda i: (abs(waiting[i].config.span), i))
        return order[:min(k, len(waiting))]


ADMISSION_POLICIES: Dict[str, AdmissionPolicy] = {
    "admit_all": AdmitAll(),
    "bounded": BoundedQueue(),
}

SCHEDULING_POLICIES: Dict[str, SchedulingPolicy] = {
    "fifo": FIFO(),
    "shortest_span": ShortestSpanFirst(),
}


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Arrival-stamped request queue with admission control.

    ``schedule()`` registers future arrivals; ``release(now)`` moves every
    request whose stamp has passed through the admission policy into the
    waiting queue; ``take(k)`` hands up to ``k`` waiting requests to the
    engine in policy order. All counters are plain ints (host-side).
    """

    def __init__(self,
                 admission: Optional[AdmissionPolicy] = None,
                 policy: Optional[SchedulingPolicy] = None):
        self.admission = admission if admission is not None else AdmitAll()
        self.policy = policy if policy is not None else FIFO()
        if not isinstance(self.admission, AdmissionPolicy):
            raise TypeError(
                f"admission must be an AdmissionPolicy, got "
                f"{self.admission!r}")
        if not isinstance(self.policy, SchedulingPolicy):
            raise TypeError(
                f"policy must be a SchedulingPolicy, got {self.policy!r}")
        self._pending: deque[Request] = deque()   # future, by arrival stamp
        self._waiting: List[Request] = []         # arrived + admitted
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.rejected: List[Request] = []

    # -- load side ---------------------------------------------------------

    def schedule(self, requests: Sequence[Request]) -> None:
        """Register a batch of future arrivals (sorted by stamp)."""
        self.n_submitted += len(requests)
        merged = sorted(itertools.chain(self._pending, requests),
                        key=lambda r: r.arrival)
        self._pending = deque(merged)

    # -- engine side -------------------------------------------------------

    def release(self, now: float) -> int:
        """Admit every pending request whose arrival stamp has passed.
        Returns how many were admitted this call."""
        n = 0
        while self._pending and self._pending[0].arrival <= now:
            req = self._pending.popleft()
            if self.admission.admit(len(self._waiting), req):
                self._waiting.append(req)
                self.n_admitted += 1
                n += 1
            else:
                self.n_rejected += 1
                self.rejected.append(req)
        return n

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival if self._pending else None

    @property
    def depth(self) -> int:
        return len(self._waiting)

    @property
    def drained(self) -> bool:
        return not self._pending and not self._waiting

    def take(self, k: int,
             pred: Optional[Callable[[Request], bool]] = None
             ) -> List[Request]:
        """Remove and return up to ``k`` waiting requests in policy order;
        ``pred`` filters candidates (the engine uses it to split the dense
        bypass lane from the chunk lane)."""
        if k <= 0 or not self._waiting:
            return []
        if pred is None:
            candidates = list(range(len(self._waiting)))
        else:
            candidates = [i for i, r in enumerate(self._waiting) if pred(r)]
        if not candidates:
            return []
        view = [self._waiting[i] for i in candidates]
        picked_local = self.policy.select(view, k)
        picked = [candidates[j] for j in picked_local]
        out = [self._waiting[i] for i in picked]
        for i in sorted(picked, reverse=True):
            del self._waiting[i]
        return out
