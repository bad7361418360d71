"""Continuous-batching ODE engine: chunked re-dispatch over masked slots.

The chunk lane is the tentpole: a fixed fleet of ``slots`` batch rows, each
carrying one in-flight request's *entire* adaptive-integration state —
solver state, current time, target time, warm step proposal, tolerances and
trial budget — through :func:`chunk_transition`, a masked loop of exactly
``chunk_steps`` accept/reject trials per dispatch round. The per-row loop
body is the per-row driver of :func:`repro_torch.core.integrate.
integrate_adaptive` (same accept predicate, same step-size controller, same
end clipping) with a per-row ``t1``, ``rtol``, ``atol`` and ``budget``, so
chunking at round boundaries is invisible to the numerics: a request's
trajectory is the one ``solve()`` produces, and the tests hold the engine
to it. Rows that reach their target (or exhaust their budget) retire
between rounds and their slots are immediately backfilled from the
scheduler queue — a stiff straggler keeps exactly one row busy instead of
holding a whole static batch hostage.

The controller (the engines' ``Controller``) is
:class:`~repro_torch.core.stepsize.ReproducibleController` (the float32
one's error norm, step-size power and initial root rounded once), so a
request takes the same trials on the CPU and on the card, alone and among
any batch-mates: its trajectory and counters are those of
``solve(..., controller=ReproducibleController(rtol, atol, max_steps))``.

This is the JAX package's ``repro.serve.engine`` made explicit. Where JAX
maps ``vmap`` over a per-row ``lax.scan`` and jits it once,
:func:`chunk_transition` runs the rows together: ``t``, ``h`` and the
counters are (B,) tensors, ``f`` is called per sample through
:func:`~repro_torch.core.interface.per_sample` (each row its own ``t``),
the per-request tolerances reach the error norm through
:class:`_RowTolerance`, and on the card every trial is one per-row
``alf_midpoint`` and one per-row ``alf_update`` launch. A round
reads nothing on the host inside the chunk and writes its result into the
slot buffers in place: the buffers are allocated once, on the first
insert, and no round reallocates them.

Host bookkeeping is once a round: ``_dispatch`` ends in one device sync
(``torch.cuda.synchronize``, JAX's ``block_until_ready``), behind which one
asynchronous device-to-host copy of the slot flags (``active``,
``reached``, ``n_trials``, ``n_accepted``, ``budget``) has landed; the
host mirrors of those flags serve ``_n_active``, ``_finished_rows`` and the
records. Retiring rows' end states are gathered on the device in one
``index_select`` per leaf and copied to the host asynchronously, read
behind the next sync; a round's backfilled initial states and per-row
fields go up in one asynchronous host-to-device copy and get one
``init_state``.

Two engines share the dispatch machinery:

* :class:`ContinuousBatchingEngine` — retire + backfill every round;
* :class:`StaticFleetEngine` — the baseline: form a batch from the queue,
  integrate it to completion with NO backfill, complete every member at
  batch end.

Dense/event requests bypass the slots: each runs a per-request
``solve(saveat=SaveAt(dense=True))`` / ``solve(event=...)`` (the scalar
ALF kernels on the card) whose dense interpolant lands in the
:class:`repro_torch.serve.cache.InterpolantCache`, so repeated
``evaluate(t)`` queries on a hot trajectory cost zero f-evals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree_util as pytree
from repro_torch.core.integrate import tree_where
from repro_torch.core.interface import SaveAt, per_sample
from repro_torch.core.solve import solve
from repro_torch.core.solvers import ALF, Solver
from repro_torch.core.stepsize import ReproducibleController
from repro_torch.device import resolve_device

from .cache import InterpolantCache
from .metrics import RequestRecord, ServeReport, summarize
from .scheduler import Request, Scheduler

_tm = pytree.tree_map

Pytree = Any

F32 = torch.float32
I32 = torch.int32


class SlotBatch(NamedTuple):
    """The fleet's whole in-flight state, batch axis first on every leaf,
    on the engine's device.

    One row == one request mid-integration; ``active=False`` rows are empty
    slots that ride through the masked loop as no-ops (their trials update
    nothing and count nothing). ``rtol``/``atol`` start at ones, so an
    empty row's error norm stays finite.
    """
    state: Pytree               # stacked solver state (B, ...)
    t: torch.Tensor             # (B,) f32 current time
    t1: torch.Tensor            # (B,) f32 target time
    h: torch.Tensor             # (B,) f32 signed warm-started step proposal
    rtol: torch.Tensor          # (B,) f32 per-request relative tolerance
    atol: torch.Tensor          # (B,) f32 per-request absolute tolerance
    budget: torch.Tensor        # (B,) int32 per-request trial budget
    active: torch.Tensor        # (B,) bool slot occupied
    reached: torch.Tensor       # (B,) bool hit t1
    n_trials: torch.Tensor      # (B,) int32 trials spent so far
    n_accepted: torch.Tensor    # (B,) int32 accepted steps so far


# The slot flags, in the order of the one device-to-host copy a round.
_FLAGS = ("active", "reached", "n_trials", "n_accepted", "budget")


class _RowTolerance:
    """Controller shim carrying the rows' (B,) ``rtol``/``atol`` into the
    controller's error norm — how per-request tolerances ride through
    ``Solver.trial_fn``, whose contract needs only ``adaptive`` and
    ``error_ratio``. Not a registered StepController: it exists only
    inside :func:`chunk_transition`."""

    adaptive = True

    def __init__(self, controller, rtol: torch.Tensor, atol: torch.Tensor):
        self.controller = controller
        self.rtol = rtol
        self.atol = atol

    def error_ratio(self, err, z0, z1, rows: bool = False) -> torch.Tensor:
        if err is None:
            raise ValueError(
                "the serve engine's per-row adaptive control needs a "
                "solver with an embedded error estimate")
        return self.controller.norm(err, z0, z1, self.rtol, self.atol, rows)


def _rows_f(f):
    """``f`` (written for one sample) over the fleet's rows: ``per_sample``
    on contiguous leaves, so a row's ``f`` comes from the same batched
    products whatever layout it arrives in (the per-row ALF ops hand back
    strided views of one packed buffer, and a product over strided rows
    may round otherwise than over contiguous ones)."""
    rows_f = per_sample(f)

    def f_rows(params, z, t):
        return rows_f(params, _tm(lambda x: x.contiguous(), z), t)

    return f_rows


def chunk_transition(params: Pytree, slots: SlotBatch, *, f, solver: Solver,
                     chunk_steps: int,
                     controller=ReproducibleController) -> SlotBatch:
    """One dispatch round: advance every row by exactly ``chunk_steps``
    adaptive trials of its own solve, with no early exit and no host read,
    and write the result into ``slots``' buffers in place (returned, so
    every leaf keeps its shape, dtype, device and storage).

    Per-row semantics match ``integrate_adaptive``'s masked body: done
    rows (empty slot / target reached / budget exhausted) ride along as
    no-ops, accepted steps warm-start the next proposal through the carry,
    and the final step clips to land exactly on ``t1``. ``f`` is written
    for one sample and called per row, on contiguous leaves. The error
    norm and the step-size policy are ``controller``'s (an
    ``AdaptiveController`` class), at each row's own tolerances. Runs
    under ``torch.no_grad()``.
    """
    with torch.no_grad():
        trial = solver.trial_fn(_rows_f(f), params,
                                _RowTolerance(controller, slots.rtol,
                                              slots.atol))
        idle = ~slots.active
        state, t, h = slots.state, slots.t, slots.h
        reached, n_tr, n_acc = slots.reached, slots.n_trials, slots.n_accepted
        for _ in range(chunk_steps):
            done = idle | reached | (n_tr >= slots.budget)
            remaining = slots.t1 - t
            is_last = torch.abs(h) >= torch.abs(remaining)
            h_eff = torch.where(is_last, remaining, h)
            state_next, ratio = trial(state, t, h_eff)
            accept = (ratio <= 1.0) & ~done
            n_tr = n_tr + (~done).to(I32)
            t = torch.where(accept, torch.where(is_last, slots.t1, t + h_eff),
                            t)
            state = tree_where(accept, state_next, state)
            h = torch.where(done, h, controller.next_step(
                h_eff, ratio, solver.order))
            reached = reached | (accept & is_last)
            n_acc = n_acc + accept.to(I32)
        _tm(lambda buf, x: buf.copy_(x), slots.state, state)
        for buf, x in ((slots.t, t), (slots.h, h), (slots.reached, reached),
                       (slots.n_trials, n_tr), (slots.n_accepted, n_acc)):
            buf.copy_(x)
    return slots


# The JAX package jits chunk_transition once per (f, solver, chunk_steps);
# here the dispatch is the plain call.
dispatch_chunk = chunk_transition


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration.

    ``slots`` is the fleet width B (concurrent in-flight requests),
    ``chunk_steps`` the trials per dispatch round — the backfill
    granularity: retired rows are only refilled *between* rounds, so small
    chunks react to arrivals faster at more dispatch overhead.
    """
    slots: int = 8
    chunk_steps: int = 32
    solver: Solver = dataclasses.field(default_factory=lambda: ALF(eta=0.9))

    def __post_init__(self):
        if not isinstance(self.slots, int) or self.slots < 1:
            raise ValueError(
                f"EngineConfig: slots must be a positive integer, got "
                f"{self.slots!r}")
        if not isinstance(self.chunk_steps, int) or self.chunk_steps < 1:
            raise ValueError(
                f"EngineConfig: chunk_steps must be a positive integer, "
                f"got {self.chunk_steps!r}")
        if not isinstance(self.solver, Solver):
            raise TypeError(
                f"EngineConfig: solver must be a Solver, got "
                f"{self.solver!r}")
        if not self.solver.has_error_estimate:
            raise ValueError(
                f"EngineConfig: solver {self.solver.name!r} has no "
                "embedded error estimate; per-request adaptive control "
                "needs one (use ALF or an embedded RK pair)")


class _EngineBase:
    """Shared machinery of both engines: slot insert/retire, the dense and
    event bypass lanes, the serving clock, and report assembly.

    The clock is *virtual*: it advances by the measured wall time of each
    dispatch (``timer`` defaults to ``time.perf_counter``) and jumps over
    idle gaps to the next arrival — so a load run never sleeps, latency is
    ``completion - arrival`` on one consistent axis, and tests inject a
    deterministic fake timer for wall-time-free assertions.

    The engine computes on ``device`` (default: the CUDA card; raises
    without one unless given ``device="cpu"``); ``params`` must already
    live there. ``host_syncs`` counts the device syncs the engine makes
    itself (one a round, one at the end of a run).
    """

    name = "?"

    # Backstop against scheduler/engine bugs, far above any real run.
    MAX_ROUNDS = 1_000_000

    # The step control of every lane, an AdaptiveController class: its
    # error norm and step-size policy at each row's tolerances in the
    # chunk lane, an instance a request in the others. The float32
    # AdaptiveController's pow, sqrt and sums round otherwise on the card
    # than on the CPU, and a stiff request's trials follow them.
    Controller = ReproducibleController

    def __init__(self, f, params, *, config: Optional[EngineConfig] = None,
                 scheduler: Optional[Scheduler] = None,
                 cache: Optional[InterpolantCache] = None,
                 vf_id: str = "vf",
                 timer: Callable[[], float] = time.perf_counter,
                 device=None):
        self.f = f
        self.params = params
        self.config = config if config is not None else EngineConfig()
        if not isinstance(self.config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got {self.config!r}")
        self.scheduler = scheduler if scheduler is not None else Scheduler()
        self.cache = cache if cache is not None else InterpolantCache()
        self.vf_id = vf_id
        self.timer = timer
        self.device = resolve_device(device)

        self.now = 0.0
        self.rounds = 0
        self.occupancy: List[float] = []
        self.records: List[RequestRecord] = []
        self.results: Dict[int, Pytree] = {}
        self.event_times: Dict[int, float] = {}
        self.host_syncs = 0

        b = self.config.slots
        self.slots: Optional[SlotBatch] = None
        self.inflight: List[Optional[Request]] = [None] * b
        # Host mirrors of the slot flags, _FLAGS order: set by inserts and
        # retirements, refreshed by each round's one device read.
        self._flags = np.zeros((len(_FLAGS), b), np.int64)
        self._z_layout = None       # (tree spec, leaf shapes) of the fleet
        # Retired rows whose end states are still being copied to the host.
        self._pending: List[tuple] = []

    # -- request intake ----------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> None:
        self.scheduler.schedule(list(requests))

    # -- host <-> device ---------------------------------------------------

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _sync(self) -> None:
        if self._on_card:
            torch.cuda.synchronize(self.device)
            self.host_syncs += 1

    def _upload(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """The arrays on the engine's device through ONE host-to-device
        copy: packed into one (pinned, on the card) byte buffer at 8-byte
        aligned offsets, copied asynchronously, viewed back per array."""
        offsets, total = [], 0
        for a in arrays:
            total = -(-total // 8) * 8
            offsets.append(total)
            total += a.nbytes
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=self._on_card)
        view = host.numpy()
        for a, off in zip(arrays, offsets):
            view[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)
        dev = host.to(self.device, non_blocking=True)
        return [dev[off:off + a.nbytes].view(torch.from_numpy(
            a[:0].reshape(-1)).dtype).view(a.shape)
            for a, off in zip(arrays, offsets)]

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the host: on the card an asynchronous copy into pinned
        memory, valid after the next :meth:`_sync`."""
        if not self._on_card:
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    def _collect(self) -> None:
        """Hand the retired rows' end states (copied behind the last sync)
        to ``results``, one numpy tree a request."""
        for rids, rows in self._pending:
            rows = _tm(lambda x: x.numpy(), rows)
            for i, rid in enumerate(rids):
                self.results[rid] = _tm(lambda a: a[i].copy(), rows)
        self._pending = []

    def _finish(self) -> ServeReport:
        if self._pending:
            self._sync()
            self._collect()
        return self.report()

    # -- slot plumbing -----------------------------------------------------

    def _alloc_slots(self, state_rows: Pytree) -> SlotBatch:
        b, dev = self.config.slots, self.device

        def zeros(dtype, shape=()):
            return torch.zeros((b,) + tuple(shape), dtype=dtype, device=dev)

        return SlotBatch(
            state=_tm(lambda leaf: zeros(leaf.dtype, leaf.shape[1:]),
                      state_rows),
            t=zeros(F32), t1=zeros(F32), h=zeros(F32),
            rtol=torch.ones((b,), dtype=F32, device=dev),
            atol=torch.ones((b,), dtype=F32, device=dev),
            budget=zeros(I32), active=zeros(torch.bool),
            reached=zeros(torch.bool), n_trials=zeros(I32),
            n_accepted=zeros(I32))

    def _check_layout(self, req: Request, spec, shapes) -> None:
        if self._z_layout is None:
            self._z_layout = (spec, shapes)
            return
        e_spec, e_shapes = self._z_layout
        if spec != e_spec or shapes != e_shapes:
            raise ValueError(
                f"request {req.rid}: z0 state structure/shapes do not "
                f"match this engine's fleet (engine: {e_spec.spec}/"
                f"{e_shapes}, request: {spec.spec}/{shapes}); one engine "
                "serves one vector field at one state shape — run another "
                "engine for other shapes")

    def _insert_many(self, idxs: Sequence[int],
                     reqs: Sequence[Request]) -> None:
        """Write requests into free slots ``idxs``: one upload of their
        stacked initial states and per-row fields, one ``init_state`` for
        all of them, in-place row writes into the slot buffers.

        ``init_state`` runs over the fleet's full width (the initial states
        padded with zero rows), so a row's ``v0 = f(z0)`` comes from the
        same batched products as its trials' ``f``: a product over k rows
        may round otherwise than one over B (a GEMV is not a GEMM)."""
        leaves = []
        for req in reqs:
            lv, spec = pytree.tree_flatten(req.z0)
            lv = [np.asarray(x) for x in lv]
            self._check_layout(req, spec, [x.shape for x in lv])
            leaves.append(lv)
        spec = self._z_layout[0]
        k, pad = len(reqs), self.config.slots - len(reqs)
        cfgs = [r.config for r in reqs]
        f32 = np.float32
        fields = [np.array([c.t1 for c in cfgs], f32),
                  self._initial_steps(cfgs),
                  np.array([c.rtol for c in cfgs], f32),
                  np.array([c.atol for c in cfgs], f32),
                  np.array([c.max_steps for c in cfgs], np.int32),
                  np.asarray(idxs, np.int64)]
        padded = [np.concatenate([np.stack(col),
                                  np.zeros((pad,) + col[0].shape,
                                           col[0].dtype)])
                  for col in zip(*leaves)]
        padded.append(np.concatenate([np.array([c.t0 for c in cfgs], f32),
                                      np.zeros(pad, f32)]))
        up = self._upload(padded + fields)
        n = len(padded)
        z0 = pytree.tree_unflatten(up[:n - 1], spec)
        t0 = up[n - 1]
        t1, h, rtol, atol, budget, idx = up[n:]
        solver = self.config.solver
        with torch.no_grad():
            state0 = solver.init_state(_rows_f(self.f), self.params, z0, t0)
        if self.slots is None:
            self.slots = self._alloc_slots(state0)
        s = self.slots
        _tm(lambda buf, rows: buf.index_copy_(0, idx, rows[:k]), s.state,
            state0)
        for buf, rows in ((s.t, t0[:k]), (s.t1, t1), (s.h, h),
                          (s.rtol, rtol), (s.atol, atol), (s.budget, budget)):
            buf.index_copy_(0, idx, rows)
        s.active.index_fill_(0, idx, True)
        s.reached.index_fill_(0, idx, False)
        s.n_trials.index_fill_(0, idx, 0)
        s.n_accepted.index_fill_(0, idx, 0)
        rows = np.asarray(idxs)
        self._flags[:, rows] = 0
        self._flags[0, rows] = 1
        self._flags[4, rows] = fields[4]
        for i, req in zip(idxs, reqs):
            self.inflight[i] = req

    def _initial_steps(self, cfgs) -> np.ndarray:
        """Each config's initial step proposal, ``initial_step(f32(span))``
        of its controller, computed on the host, one call for each
        tolerance pair."""
        groups: Dict[tuple, List[int]] = {}
        for i, c in enumerate(cfgs):
            groups.setdefault((c.rtol, c.atol, c.max_steps), []).append(i)
        h = np.empty(len(cfgs), np.float32)
        for (rtol, atol, max_steps), idx in groups.items():
            span = torch.tensor([cfgs[i].span for i in idx], dtype=F32)
            h[idx] = self.Controller(rtol, atol, max_steps).initial_step(
                span).numpy()
        return h

    def _insert(self, idx: int, req: Request) -> None:
        self._insert_many([idx], [req])

    def _n_active(self) -> int:
        return int(self._flags[0].sum())

    def _init_fevals(self) -> int:
        # Matches solve()'s accounting: ALF spends one dynamics evaluation
        # on v0 = f(z0, t0) at state init.
        return 1 if isinstance(self.config.solver, ALF) else 0

    def _retire_rows(self, rows: Sequence[int], completion: float) -> None:
        """Record + free the finished rows (reached t1 or budget out): one
        gather of their end states, copied to the host behind the next
        sync, and one in-place deactivation."""
        if not len(rows):
            return
        rows = [int(i) for i in rows]
        (idx,) = self._upload([np.asarray(rows, np.int64)])
        solver = self.config.solver
        ends = _tm(lambda buf: self._to_host(buf.index_select(0, idx)),
                   solver.output(self.slots.state))
        rids = []
        for i in rows:
            req = self.inflight[i]
            assert req is not None
            _, reached, n_tr, n_acc, _ = (int(v) for v in self._flags[:, i])
            self.records.append(RequestRecord(
                rid=req.rid, arrival=req.arrival, completion=completion,
                n_fevals=n_tr * solver.stages + self._init_fevals(),
                n_accepted=n_acc, completed=bool(reached), lane="batch"))
            rids.append(req.rid)
            self.inflight[i] = None
        self._pending.append((rids, ends))
        if not self._on_card:
            self._collect()
        self.slots.active.index_fill_(0, idx, False)
        self._flags[0, rows] = 0

    def _finished_rows(self) -> List[int]:
        active, reached, n_tr, _, budget = self._flags
        done = (active > 0) & ((reached > 0) | (n_tr >= budget))
        return [int(i) for i in np.nonzero(done)[0]]

    def _dispatch(self) -> None:
        """One measured chunk round: advance the fleet, read its flags
        behind the round's one sync, advance the clock."""
        self.occupancy.append(self._n_active() / self.config.slots)
        s = self.slots
        t_start = self.timer()
        dispatch_chunk(self.params, s, f=self.f, solver=self.config.solver,
                       chunk_steps=self.config.chunk_steps,
                       controller=self.Controller)
        flags = self._to_host(torch.stack(
            [getattr(s, k).to(I32) for k in _FLAGS]))
        self._sync()
        self.now += max(self.timer() - t_start, 0.0)
        self._flags = flags.numpy().astype(np.int64)
        self._collect()
        self.rounds += 1
        if self.rounds > self.MAX_ROUNDS:
            raise RuntimeError(
                f"serve engine exceeded {self.MAX_ROUNDS} dispatch rounds "
                "— a request is neither finishing nor exhausting its "
                "budget (file a bug with the request mix)")

    # -- dense / event bypass lane ----------------------------------------

    def _serve_bypass(self) -> None:
        """Serve every queued dense/event request immediately (they run as
        per-request solves and never occupy a batch slot)."""
        while True:
            reqs = self.scheduler.take(1, pred=lambda r: r.wants_dense
                                       or r.event is not None)
            if not reqs:
                return
            req = reqs[0]
            if req.event is not None:
                self._serve_event(req)
            else:
                self._serve_dense(req)

    def _controller(self, cfg) -> ReproducibleController:
        return self.Controller(cfg.rtol, cfg.atol, cfg.max_steps)

    def _z0(self, req: Request) -> Pytree:
        return _tm(lambda x: torch.as_tensor(np.asarray(x),
                                             device=self.device), req.z0)

    def _host(self, tree: Pytree) -> Pytree:
        return _tm(lambda x: x.detach().cpu().numpy(), tree)

    def _serve_dense(self, req: Request) -> None:
        cfg = req.config
        key = self.cache.key(self.vf_id, cfg, req.z0)
        t_start = self.timer()
        sol = self.cache.get(key)
        hit = sol is not None
        if not hit:
            with torch.no_grad():
                sol = solve(self.f, self.params, self._z0(req), cfg.t0,
                            cfg.t1, solver=self.config.solver,
                            controller=self._controller(cfg),
                            saveat=SaveAt(dense=True))
            self._sync()
            self.cache.put(key, sol)
        with torch.no_grad():
            if req.eval_ts is not None:
                out = sol.evaluate(torch.as_tensor(
                    np.asarray(req.eval_ts, np.float32), device=self.device))
            else:
                out = sol.ys
        out = self._host(out)
        self.now += max(self.timer() - t_start, 0.0)
        self.results[req.rid] = out
        # The whole point of the interpolant cache: a hit re-reads the
        # recorded cubic-Hermite coefficients — zero incremental f-evals.
        fevals = 0 if hit else int(sol.stats.n_fevals)
        completed = True if hit else bool(sol.stats.span_complete)
        self.records.append(RequestRecord(
            rid=req.rid, arrival=req.arrival, completion=self.now,
            n_fevals=fevals,
            n_accepted=0 if hit else int(sol.stats.n_accepted),
            completed=completed,
            lane="eval" if req.eval_ts is not None else "dense",
            cache_hit=hit))

    def _serve_event(self, req: Request) -> None:
        cfg = req.config
        t_start = self.timer()
        with torch.no_grad():
            sol = solve(self.f, self.params, self._z0(req), cfg.t0, cfg.t1,
                        solver=self.config.solver,
                        controller=self._controller(cfg), event=req.event)
        self._sync()
        self.now += max(self.timer() - t_start, 0.0)
        self.results[req.rid] = self._host(sol.ys)
        self.event_times[req.rid] = float(sol.stats.event_time)
        self.records.append(RequestRecord(
            rid=req.rid, arrival=req.arrival, completion=self.now,
            n_fevals=int(sol.stats.n_fevals),
            n_accepted=int(sol.stats.n_accepted),
            completed=True, lane="event"))

    # -- reporting ---------------------------------------------------------

    def report(self) -> ServeReport:
        return summarize(self.name, self.records, duration=self.now,
                         occupancy=self.occupancy, rounds=self.rounds,
                         cache=self.cache,
                         n_rejected=self.scheduler.n_rejected)

    def run(self) -> ServeReport:
        raise NotImplementedError


class ContinuousBatchingEngine(_EngineBase):
    """vLLM-style continuous batching: every dispatch round retires the
    rows that finished and backfills their slots from the queue, so fleet
    occupancy tracks offered load and a straggler costs one slot, not B."""

    name = "continuous"

    def _backfill(self) -> None:
        free = [int(i) for i in np.nonzero(self._flags[0] == 0)[0]]
        if not free:
            return
        reqs = self.scheduler.take(
            len(free),
            pred=lambda r: not r.wants_dense and r.event is None)
        if reqs:
            self._insert_many(free[:len(reqs)], reqs)

    def run(self) -> ServeReport:
        """Drain the scheduler: serve until no request is pending, waiting
        or in flight. Returns the run's :class:`ServeReport`."""
        while True:
            self.scheduler.release(self.now)
            self._serve_bypass()
            self._backfill()
            if self._n_active() == 0:
                if self.scheduler.drained:
                    return self._finish()
                nxt = self.scheduler.next_arrival()
                if nxt is not None:
                    # Idle: jump the virtual clock to the next arrival.
                    self.now = max(self.now, nxt)
                continue
            self._dispatch()
            self._retire_rows(self._finished_rows(), self.now)


class StaticFleetEngine(_EngineBase):
    """The baseline continuous batching is measured against: form one
    batch from the queue, integrate the whole batch to completion with no
    backfill, and hand every member its result when the *batch* finishes.
    Quick requests wait on the batch's stiffest straggler; arrivals during
    a batch wait for the next one."""

    name = "static"

    def _reset_slots(self) -> None:
        if self.slots is not None:
            for buf in pytree.tree_leaves(self.slots):
                buf.zero_()
            self.slots.rtol.fill_(1.0)
            self.slots.atol.fill_(1.0)
        self._flags[:] = 0
        self.inflight = [None] * self.config.slots

    def run(self) -> ServeReport:
        while True:
            self.scheduler.release(self.now)
            self._serve_bypass()
            if self.scheduler.depth == 0:
                if self.scheduler.drained:
                    return self._finish()
                nxt = self.scheduler.next_arrival()
                if nxt is not None:
                    self.now = max(self.now, nxt)
                continue
            reqs = self.scheduler.take(
                self.config.slots,
                pred=lambda r: not r.wants_dense and r.event is None)
            if not reqs:
                continue
            self._reset_slots()
            self._insert_many(range(len(reqs)), reqs)
            # No backfill: the batch runs until every member is done.
            while True:
                finished = set(self._finished_rows())
                unfinished = [i for i in range(self.config.slots)
                              if self.inflight[i] is not None
                              and i not in finished]
                if not unfinished:
                    break
                self._dispatch()
            # Everyone completes together, at batch end.
            self._retire_rows(self._finished_rows(), self.now)


ENGINES = {
    "continuous": ContinuousBatchingEngine,
    "static": StaticFleetEngine,
}
