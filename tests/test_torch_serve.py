"""The port's serving layer (``repro_torch.serve``, ``launch/serve.py --mode
ode``) on the CPU: the cases of tests/test_serve.py one for one, and the
same request traces through the JAX package's ``repro.serve``.

Everything time-dependent runs on an injected deterministic clock (a fake
timer advancing a fixed step per sample), so no assertion depends on wall
time. The engines run with ``device="cpu"``, where the ALF ops take their
plain versions. The two packages' request ids differ within one process
(each keeps its own counter), so the parity tests pair requests by
submission order.

Tolerances: end states, interpolants and event times within 1e-6
(absolute and relative, tests/test_serve.py's bar against ``solve()``);
the JAX package's XLA arithmetic and the port's round differently in the
last bits. Counters, lanes, completion stamps and every ``ServeReport``
field are held equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.serve as J
import repro_torch.core as TC
import repro_torch.serve as T_SERVE
from repro.launch import serve as jserve
from repro_torch.core.stepsize import error_ratio
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.launch import serve as tserve
from repro_torch.serve import (ADMISSION_POLICIES, CACHE_POLICIES,
                               SCHEDULING_POLICIES, AdmissionPolicy,
                               AdmitAll, BoundedQueue, CachePolicy,
                               ContinuousBatchingEngine, EngineConfig, FIFO,
                               InterpolantCache, LRU, NoCache, Request,
                               RequestConfig, Scheduler, SchedulingPolicy,
                               ShortestSpanFirst, StaticFleetEngine,
                               chunk_transition, decay_dynamics,
                               hot_trajectory_requests, percentile,
                               poisson_arrivals)

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
CPU = "cpu"


def make_timer(step: float = 1e-3):
    """Deterministic clock: advances `step` per sample."""
    state = {"t": 0.0}

    def timer() -> float:
        state["t"] += step
        return state["t"]

    return timer


def _z0(rng, d=4, lam=3.0):
    return {"y": rng.standard_normal(d).astype(np.float32),
            "lam": np.full((d,), lam, dtype=np.float32)}


def _tensors(z0):
    return {k: torch.as_tensor(v) for k, v in z0.items()}


def _solve_reference(req, **kw):
    cfg = req.config
    return TC.solve(decay_dynamics, None, _tensors(req.z0), cfg.t0, cfg.t1,
                    solver=TC.ALF(eta=0.9),
                    controller=TC.ReproducibleController(
                        cfg.rtol, cfg.atol, cfg.max_steps), **kw)


def small_config(solver=None):
    return EngineConfig(slots=3, chunk_steps=8,
                        solver=TC.ALF(eta=0.9) if solver is None else solver)


def _engine(cls=ContinuousBatchingEngine, **kw):
    kw.setdefault("config", small_config())
    kw.setdefault("timer", make_timer())
    return cls(decay_dynamics, None, device=CPU, **kw)


# ---------------------------------------------------------------------------
# RequestConfig
# ---------------------------------------------------------------------------

class TestRequestConfig:
    def test_validation(self):
        with pytest.raises(ValueError, match="empty span"):
            RequestConfig(t0=1.0, t1=1.0)
        with pytest.raises(ValueError, match="non-negative"):
            RequestConfig(rtol=-1e-3)
        with pytest.raises(ValueError, match="cannot both be 0"):
            RequestConfig(rtol=0.0, atol=0.0)
        with pytest.raises(ValueError, match="max_steps"):
            RequestConfig(max_steps=0)

    def test_value_hashing(self):
        # Fresh equal-valued configs are interchangeable as cache-key
        # components.
        a = RequestConfig(t1=np.float32(2.0), rtol=1e-4)
        b = RequestConfig(t1=2.0, rtol=1e-4)
        assert a == b and hash(a) == hash(b)
        assert a != RequestConfig(t1=2.0, rtol=1e-3)
        assert RequestConfig(t0=1.0, t1=0.0).span == -1.0


# ---------------------------------------------------------------------------
# Scheduler (deterministic clock — no wall time anywhere)
# ---------------------------------------------------------------------------

class TestScheduler:
    def _requests(self, arrivals):
        rng = np.random.default_rng(0)
        return [Request(z0=_z0(rng), arrival=t) for t in arrivals]

    def test_release_by_stamp(self):
        s = Scheduler()
        s.schedule(self._requests([0.0, 0.5, 1.0, 2.0]))
        assert s.next_arrival() == 0.0
        assert s.release(now=0.6) == 2
        assert s.depth == 2 and not s.drained
        assert s.next_arrival() == 1.0
        assert s.release(now=0.7) == 0          # nothing new has arrived
        assert s.release(now=5.0) == 2
        taken = s.take(10)
        assert [r.arrival for r in taken] == [0.0, 0.5, 1.0, 2.0]  # FIFO
        assert s.drained

    def test_bounded_queue_rejects(self):
        s = Scheduler(admission=BoundedQueue(max_depth=2))
        s.schedule(self._requests([0.0, 0.1, 0.2, 0.3]))
        s.release(now=1.0)
        assert s.depth == 2
        assert s.n_rejected == 2
        assert [r.arrival for r in s.rejected] == [0.2, 0.3]
        # draining the queue re-opens admission for later arrivals
        s.take(2)
        s.schedule(self._requests([1.5]))
        s.release(now=2.0)
        assert s.depth == 1 and s.n_rejected == 2
        assert AdmitAll().admit(10_000, None)

    def test_shortest_span_first(self):
        rng = np.random.default_rng(0)
        spans = [3.0, 1.0, 2.0]
        reqs = [Request(z0=_z0(rng), config=RequestConfig(t1=t1))
                for t1 in spans]
        s = Scheduler(policy=ShortestSpanFirst())
        s.schedule(reqs)
        s.release(now=0.0)
        out = s.take(2)
        assert [r.config.t1 for r in out] == [1.0, 2.0]
        assert [r.config.t1 for r in s.take(5)] == [3.0]
        # FIFO control on the same spans
        assert isinstance(FIFO().select([], 4), list)

    def test_take_pred_splits_lanes(self):
        rng = np.random.default_rng(0)
        dense = Request(z0=_z0(rng), config=RequestConfig(dense=True))
        plain = Request(z0=_z0(rng))
        s = Scheduler()
        s.schedule([dense, plain])
        s.release(now=0.0)
        out = s.take(5, pred=lambda r: r.wants_dense)
        assert out == [dense]
        assert s.take(5) == [plain]

    def test_registries(self):
        assert set(ADMISSION_POLICIES) == {"admit_all", "bounded"}
        assert set(SCHEDULING_POLICIES) == {"fifo", "shortest_span"}
        assert set(CACHE_POLICIES) == {"lru", "none"}


# ---------------------------------------------------------------------------
# Interpolant cache
# ---------------------------------------------------------------------------

class TestInterpolantCache:
    def test_key_is_content_hash(self):
        rng = np.random.default_rng(1)
        z0 = _z0(rng)
        cfg = RequestConfig(dense=True)
        k = InterpolantCache.key("vf", cfg, z0)
        assert k == InterpolantCache.key(
            "vf", RequestConfig(dense=True),
            {kk: vv.copy() for kk, vv in z0.items()})
        assert k != InterpolantCache.key("vf2", cfg, z0)
        assert k != InterpolantCache.key(
            "vf", RequestConfig(dense=True, rtol=1e-5), z0)
        other = {kk: vv.copy() for kk, vv in z0.items()}
        other["y"][0] += 1.0
        assert k != InterpolantCache.key("vf", cfg, other)
        # torch's pytree keeps a dict's insertion order: the key sorts it,
        # so the same state built in another order hits the same entry
        assert k == InterpolantCache.key(
            "vf", cfg, {"lam": z0["lam"].copy(), "y": z0["y"].copy()})
        assert k == InterpolantCache.key("vf", cfg, _tensors(z0))

    def test_hit_miss_counters(self):
        c = InterpolantCache(LRU(max_entries=4))
        assert c.get("a") is None
        c.put("a", "va")
        assert c.get("a") == "va"
        assert (c.hits, c.misses, c.hit_rate) == (1, 1, 0.5)
        assert "a" in c and len(c) == 1

    def test_lru_eviction(self):
        c = InterpolantCache(LRU(max_entries=2))
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1          # refresh "a": now "b" is oldest
        c.put("c", 3)
        assert c.evictions == 1
        assert c.get("b") is None       # "b" was evicted, not "a"
        assert c.get("a") == 1 and c.get("c") == 3

    def test_no_cache_policy(self):
        c = InterpolantCache(NoCache())
        c.put("a", 1)
        assert len(c) == 0 and c.get("a") is None
        with pytest.raises(ValueError, match="max_entries"):
            LRU(max_entries=0)


# ---------------------------------------------------------------------------
# Engine: backfilled chunked serving == stacked individual solves
# ---------------------------------------------------------------------------

def _mixed_requests(P=None):
    """tests/test_serve.py's mixed trace, drawn with package ``P``'s
    loadgen (the port's by default)."""
    P = T_SERVE if P is None else P
    rng = np.random.default_rng(7)
    reqs = P.mixed_stiffness_requests(rng, 7, rate=1_000.0, d_state=4,
                                      lam_decades=(0.0, 1.3),
                                      max_steps=256)
    # one reverse-time request rides the same fleet
    reqs.append(P.Request(z0=_z0(rng, lam=2.0),
                          config=P.RequestConfig(t0=1.0, t1=0.0,
                                                 max_steps=256),
                          arrival=0.002))
    return reqs


class TestEngineParity:
    def test_backfill_equals_stacked_solves(self):
        reqs = _mixed_requests()
        eng = _engine()
        eng.submit(reqs)
        report = eng.run()
        assert report.n_requests == len(reqs)
        assert report.n_completed == len(reqs)
        for req in reqs:
            ref = _solve_reference(req)
            got = eng.results[req.rid]["y"]
            np.testing.assert_allclose(got, ref.ys["y"].numpy(), **TOL)
        # f-eval accounting matches solve()'s Stats exactly
        ref0 = _solve_reference(reqs[0])
        rec0 = next(r for r in eng.records if r.rid == reqs[0].rid)
        assert rec0.n_fevals == int(ref0.stats.n_fevals)
        assert rec0.n_accepted == int(ref0.stats.n_accepted)

    def test_deterministic_under_fake_clock(self):
        def trace(seed_step):
            eng = _engine(timer=make_timer(seed_step))
            eng.submit(_mixed_requests())
            eng.run()
            return [(r.arrival, r.completion, r.n_fevals, r.completed)
                    for r in sorted(eng.records, key=lambda r: r.arrival)]

        assert trace(1e-3) == trace(1e-3)

    def test_budget_exhaustion_marks_incomplete(self):
        rng = np.random.default_rng(3)
        req = Request(z0=_z0(rng, lam=50.0),
                      config=RequestConfig(max_steps=3))
        eng = _engine()
        eng.submit([req])
        report = eng.run()
        rec = eng.records[0]
        assert not rec.completed and rec.n_fevals == 3 + 1  # trials + v0
        assert report.n_completed == 0
        assert req.rid in eng.results   # truncated end state still returned

    def test_static_fleet_completes_together(self):
        reqs = _mixed_requests()
        eng = _engine(StaticFleetEngine)
        eng.submit(reqs)
        report = eng.run()
        assert report.n_completed == len(reqs)
        for req in reqs:
            ref = _solve_reference(req)
            np.testing.assert_allclose(eng.results[req.rid]["y"],
                                       ref.ys["y"].numpy(), **TOL)
        # one-shot fleet semantics: batch members share a completion stamp
        stamps = {r.completion for r in eng.records}
        assert len(stamps) <= int(np.ceil(len(reqs)
                                          / eng.config.slots)) + 1

    def test_engine_config_validation(self):
        with pytest.raises(ValueError, match="slots"):
            EngineConfig(slots=0)
        with pytest.raises(ValueError, match="error estimate"):
            EngineConfig(solver=TC.Rk4())

    def test_mismatched_state_shape_rejected(self):
        rng = np.random.default_rng(0)
        eng = _engine()
        eng.submit([Request(z0=_z0(rng, d=4))])
        eng.scheduler.release(0.0)
        eng._backfill()
        with pytest.raises(ValueError, match="structure/shapes"):
            eng._insert(1, Request(z0=_z0(rng, d=8)))


# ---------------------------------------------------------------------------
# Dense lane + interpolant cache through the engine
# ---------------------------------------------------------------------------

class TestDenseLane:
    def test_hot_trajectory_hits_cost_zero_fevals(self):
        rng = np.random.default_rng(5)
        reqs = hot_trajectory_requests(rng, n_repeats=3, d_state=4,
                                       lam=4.0)
        cache = InterpolantCache(LRU(max_entries=8))
        eng = _engine(cache=cache, vf_id="decay")
        eng.submit(reqs)
        report = eng.run()
        assert (cache.hits, cache.misses) == (3, 1)
        assert report.cache_hit_rate == pytest.approx(0.75)
        hit_recs = [r for r in eng.records if r.cache_hit]
        assert len(hit_recs) == 3
        assert all(r.n_fevals == 0 for r in hit_recs)   # the acceptance bar
        miss = next(r for r in eng.records if not r.cache_hit)
        assert miss.n_fevals > 0

    def test_eval_matches_direct_dense_solve(self):
        rng = np.random.default_rng(6)
        req = hot_trajectory_requests(rng, n_repeats=0, d_state=4,
                                      lam=4.0)[0]
        eng = _engine()
        eng.submit([req])
        eng.run()
        ref = _solve_reference(req, saveat=TC.SaveAt(dense=True))
        want = ref.evaluate(torch.as_tensor(req.eval_ts))
        np.testing.assert_allclose(eng.results[req.rid]["y"],
                                   want["y"].numpy(), **TOL)


# ---------------------------------------------------------------------------
# Load generation + metrics
# ---------------------------------------------------------------------------

class TestLoadgenMetrics:
    def test_poisson_arrivals(self):
        rng = np.random.default_rng(0)
        ts = poisson_arrivals(rng, rate=100.0, n=500)
        assert len(ts) == 500 and np.all(np.diff(ts) > 0)
        assert np.mean(np.diff(ts)) == pytest.approx(0.01, rel=0.2)
        with pytest.raises(ValueError, match="rate"):
            poisson_arrivals(rng, rate=0.0, n=1)

    def test_percentile(self):
        xs = [1.0, 2.0, 3.0, 4.0]
        assert percentile(xs, 50.0) == pytest.approx(2.5)
        assert percentile(xs, 100.0) == 4.0
        assert np.isnan(percentile([], 50.0))
        with pytest.raises(ValueError):
            percentile(xs, 101.0)


# ---------------------------------------------------------------------------
# The serve layer's contracts (the JAX package checks them with its
# static analysis, which the port does not have: checked here directly)
# ---------------------------------------------------------------------------

def _missing_interface(cls, base):
    """The public methods and properties of ``base`` that ``cls`` does
    not override below ``base`` in its MRO."""
    abstract = [n for n, v in vars(base).items() if not n.startswith("_")
                and (callable(v) or isinstance(v, property))]
    below = cls.__mro__[:cls.__mro__.index(base)]
    return [n for n in abstract if not any(n in vars(k) for k in below)]


def _slot_specs(slots):
    import torch.utils._pytree as tpt
    return [(tuple(x.shape), x.dtype, x.device, x.data_ptr())
            for x in tpt.tree_leaves(slots)]


SPEC_CONFIGS = {
    "alf_1x1": (1, 1, TC.ALF()),
    "alf_eta09_3x8": (3, 8, TC.ALF(eta=0.9)),
    "alf_cuda_backend_4x4": (4, 4, TC.ALF(eta=0.9, backend="cuda")),
    "heun_euler_2x5": (2, 5, TC.HeunEuler()),
    "bosh3_5x3": (5, 3, TC.Bosh3()),
    "dopri5_3x2": (3, 2, TC.Dopri5()),
}


class TestServeContracts:
    def test_policies_implement_full_interface(self):
        for cls, base in [(AdmitAll, AdmissionPolicy),
                          (BoundedQueue, AdmissionPolicy),
                          (FIFO, SchedulingPolicy),
                          (ShortestSpanFirst, SchedulingPolicy),
                          (LRU, CachePolicy), (NoCache, CachePolicy)]:
            assert _missing_interface(cls, base) == []
        for registry, base in [(ADMISSION_POLICIES, AdmissionPolicy),
                               (SCHEDULING_POLICIES, SchedulingPolicy),
                               (CACHE_POLICIES, CachePolicy)]:
            for policy in registry.values():
                assert _missing_interface(type(policy), base) == []

        class Incomplete(AdmissionPolicy):
            name = "incomplete"

        assert _missing_interface(Incomplete, AdmissionPolicy) == ["admit"]

        class HalfCache(CachePolicy):
            def admit(self, key):
                return True

        assert _missing_interface(HalfCache, CachePolicy) == [
            "victim", "capacity"]

    @pytest.mark.parametrize("cfg", list(SPEC_CONFIGS), ids=str)
    def test_chunk_transition_keeps_slot_buffers(self, cfg):
        """Every round writes the fleet in place: each slot leaf keeps its
        shape, dtype, device and storage across rounds, inserts and
        retirements; the answers match solve()."""
        slots, chunk, solver = SPEC_CONFIGS[cfg]
        eng = _engine(config=EngineConfig(slots=slots, chunk_steps=chunk,
                                          solver=solver))
        reqs = _mixed_requests()[:5]
        eng.submit(reqs)
        seen = []
        dispatch = eng._dispatch

        def checked():
            before = _slot_specs(eng.slots)
            dispatch()
            seen.append(before)
            seen.append(_slot_specs(eng.slots))

        eng._dispatch = checked
        eng.run()
        assert len(seen) >= 4
        assert all(s == seen[0] for s in seen)
        out = chunk_transition(None, eng.slots, f=decay_dynamics,
                               solver=solver, chunk_steps=chunk)
        assert out is eng.slots and _slot_specs(out) == seen[0]
        for req in reqs:
            cfg_r = req.config
            ref = TC.solve(decay_dynamics, None, _tensors(req.z0), cfg_r.t0,
                           cfg_r.t1, solver=solver, gradient=TC.Naive(),
                           controller=TC.ReproducibleController(
                               cfg_r.rtol, cfg_r.atol, cfg_r.max_steps))
            np.testing.assert_allclose(eng.results[req.rid]["y"],
                                       ref.ys["y"].numpy(), **TOL)
            rec = next(r for r in eng.records if r.rid == req.rid)
            assert rec.n_fevals == int(ref.stats.n_fevals)
            assert rec.n_accepted == int(ref.stats.n_accepted)


def test_chunk_round_is_two_alf_ops_a_trial():
    """On the cuda backend every trial of a round is one per-row
    alf_midpoint and one per-row alf_update op call (here their plain
    versions), whatever the occupancy; the answers are the reference
    backend's, bit for bit (f sees contiguous rows on either)."""
    ref = _engine()
    ref.submit(_mixed_requests())
    ref.run()
    eng = _engine(config=small_config(TC.ALF(eta=0.9, backend="cuda")))
    eng.submit(_mixed_requests())
    alf_ops.reset_op_calls()
    eng.run()
    n = eng.rounds * eng.config.chunk_steps
    assert alf_ops.OP_CALLS["alf_midpoint"] == n
    assert alf_ops.OP_CALLS["alf_update"] == n
    assert [(r.n_fevals, r.n_accepted, r.completion) for r in eng.records] \
        == [(r.n_fevals, r.n_accepted, r.completion) for r in ref.records]
    for a, b in zip(ref.records, eng.records):
        for k in ref.results[a.rid]:
            assert np.array_equal(eng.results[b.rid][k],
                                  ref.results[a.rid][k])


def test_error_ratio_per_row_tolerances():
    """Under rows=True a (B,) rtol/atol gives row b the ratio of a scalar
    call with that row's pair; a (B,) tolerance of one value is bit-equal
    to the Python number."""
    g = np.random.default_rng(11)
    b = 5

    def tree():
        return {"a": torch.as_tensor(g.standard_normal((b, 3)),
                                     dtype=torch.float32),
                "b": torch.as_tensor(g.standard_normal((b, 2, 2)),
                                     dtype=torch.float32)}

    err, z0, z1 = tree(), tree(), tree()
    rtol = torch.as_tensor(10.0 ** g.uniform(-4, -1, b), dtype=torch.float32)
    atol = torch.as_tensor(10.0 ** g.uniform(-6, -2, b), dtype=torch.float32)
    rows = error_ratio(err, z0, z1, rtol, atol, rows=True)
    assert rows.shape == (b,)
    for i in range(b):
        one = error_ratio({k: v[i] for k, v in err.items()},
                          {k: v[i] for k, v in z0.items()},
                          {k: v[i] for k, v in z1.items()},
                          float(rtol[i]), float(atol[i]))
        np.testing.assert_allclose(float(rows[i]), float(one), rtol=1e-6)
    same = error_ratio(err, z0, z1, torch.full((b,), 1e-3),
                       torch.full((b,), 1e-4), rows=True)
    assert torch.equal(same, error_ratio(err, z0, z1, 1e-3, 1e-4,
                                         rows=True))


# ---------------------------------------------------------------------------
# Parity with the JAX package's repro.serve on the same traces
# ---------------------------------------------------------------------------

def _event_cond_t(z, t):
    return z["y"][0] - 0.5


def _event_cond_j(z, t):
    return z["y"][0] - 0.5


def _full_trace(P, event):
    """The mixed trace plus a budget-exhausted request, a dense request
    with eval_ts, a dense one without, and an event request."""
    reqs = _mixed_requests(P)
    rng = np.random.default_rng(8)
    reqs.append(P.Request(z0=_z0(rng, lam=50.0),
                          config=P.RequestConfig(max_steps=3),
                          arrival=0.0025))
    reqs += P.hot_trajectory_requests(rng, n_repeats=1, d_state=4, lam=4.0,
                                      arrival=0.0015)
    reqs.append(P.Request(z0=_z0(rng, lam=2.0),
                          config=P.RequestConfig(t1=0.5, dense=True),
                          arrival=0.003))
    reqs.append(P.Request(z0={"y": np.full((4,), 1.0, np.float32),
                              "lam": np.full((4,), 3.0, np.float32)},
                          config=P.RequestConfig(t1=2.0),
                          arrival=0.0035, event=event))
    return reqs


def _run_both(name):
    jreqs = _full_trace(J, JC.Event(_event_cond_j, direction=-1))
    treqs = _full_trace(T_SERVE, TC.Event(_event_cond_t, direction=-1))
    for a, b in zip(jreqs, treqs):
        assert a.arrival == b.arrival
        assert dataclasses.astuple(a.config) == dataclasses.astuple(b.config)
        for k in a.z0:
            assert np.array_equal(a.z0[k], b.z0[k])
    jeng = J.ENGINES[name](J.decay_dynamics, None,
                           config=J.EngineConfig(slots=3, chunk_steps=8,
                                                 solver=JC.ALF(eta=0.9)),
                           vf_id="decay", timer=make_timer())
    teng = T_SERVE.ENGINES[name](decay_dynamics, None, config=small_config(),
                                 vf_id="decay", timer=make_timer(),
                                 device=CPU)
    jeng.submit(jreqs)
    teng.submit(treqs)
    return jeng, jeng.run(), jreqs, teng, teng.run(), treqs


def _solve_gap(jreq, treq):
    """max |port solve() - JAX solve()| per state leaf on one request."""
    cfg = jreq.config
    js = JC.solve(J.decay_dynamics, None,
                  {k: jnp.asarray(v) for k, v in jreq.z0.items()}, cfg.t0,
                  cfg.t1, solver=JC.ALF(eta=0.9),
                  controller=JC.AdaptiveController(cfg.rtol, cfg.atol,
                                                   cfg.max_steps))
    ts = _solve_reference(treq)
    return {k: float(np.abs(ts.ys[k].numpy() - np.asarray(js.ys[k])).max())
            for k in treq.z0}


# The largest |port solve() - JAX solve()| a request of the parity trace
# may show (1.9e-6 measured on the CPU).
SOLVE_GAP = 2e-6


@pytest.mark.parametrize("name", ["continuous", "static"])
def test_engine_matches_jax(name):
    """The same trace through both packages' engines: every ServeReport
    field, every record's counters, lane and completion stamp equal; end
    states within 1e-6 beyond the two packages' own solve() difference on
    that request, which must stay within SOLVE_GAP.

    That difference is not the engine's: the two packages' float32
    arithmetic (XLA's fused ALF step and error norm against torch's)
    parts in the last bit from the first trial, so the step sizes part by
    ulps, and on this trace's stiff row (lam 15.6) and its reverse-time
    row the single solve()s differ by up to 1.9e-6 at atol 1e-4, under
    either of the port's controllers (tests/serve_load_trace.py measures
    the same on serve_load's trace); each package's engine equals its own
    solve() within 1e-6 (TestEngineParity here, tests/test_serve.py
    there)."""
    jeng, jrep, jreqs, teng, trep, treqs = _run_both(name)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    jrec = {r.rid: r for r in jeng.records}
    trec = {r.rid: r for r in teng.records}
    lanes = set()
    for a, b in zip(jreqs, treqs):
        ra, rb = jrec[a.rid], trec[b.rid]
        got = (rb.arrival, rb.completion, rb.n_fevals, rb.n_accepted,
               rb.completed, rb.lane, rb.cache_hit)
        assert got == (ra.arrival, ra.completion, ra.n_fevals,
                       ra.n_accepted, ra.completed, ra.lane, ra.cache_hit)
        lanes.add(rb.lane)
        want = jeng.results[a.rid]
        gap = _solve_gap(a, b) if rb.lane == "batch" else {}
        assert all(g <= SOLVE_GAP for g in gap.values()), gap
        for k in want:
            np.testing.assert_allclose(teng.results[b.rid][k],
                                       np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6 + gap.get(k, 0.0))
    assert lanes == {"batch", "eval", "dense", "event"}
    assert not all(r.completed for r in teng.records)
    (ja, jt), = jeng.event_times.items()
    (ta, tt), = teng.event_times.items()
    np.testing.assert_allclose(tt, jt, **TOL)
    assert abs(tt - np.log(2.0) / 3.0) < 1e-3
    assert (teng.cache.hits, teng.cache.misses) == (jeng.cache.hits,
                                                    jeng.cache.misses)


def test_dense_lane_matches_jax():
    """evaluate(eval_ts) on the hot trajectory, on a reverse-time dense
    span and through an LRU of one entry (evictions) against the JAX
    package's."""
    def trace(P):
        rng = np.random.default_rng(12)
        reqs = P.hot_trajectory_requests(rng, n_repeats=3, d_state=4,
                                         lam=4.0, t1=-1.0)
        reqs += P.hot_trajectory_requests(rng, n_repeats=1, d_state=4,
                                          lam=1.5)
        reqs += P.hot_trajectory_requests(rng, n_repeats=0, d_state=4,
                                          lam=4.0, t1=-1.0)
        return reqs

    jreqs, treqs = trace(J), trace(T_SERVE)
    jeng = J.ContinuousBatchingEngine(
        J.decay_dynamics, None, config=J.EngineConfig(slots=3, chunk_steps=8,
                                                      solver=JC.ALF(eta=0.9)),
        cache=J.InterpolantCache(J.LRU(max_entries=1)), timer=make_timer())
    teng = _engine(cache=InterpolantCache(LRU(max_entries=1)))
    jeng.submit(jreqs)
    teng.submit(treqs)
    jrep, trep = jeng.run(), teng.run()
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert (trep.cache_hits, trep.cache_misses, trep.cache_evictions) == (
        4, 3, 2)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_allclose(teng.results[b.rid]["y"],
                                   np.asarray(jeng.results[a.rid]["y"]),
                                   **TOL)


def test_event_lane_matches_jax():
    """One event request on -lam*y through each package's engine: the
    event time, the end state and the counters."""
    z0 = {"y": np.array([1.0, -0.3, 2.0], np.float32),
          "lam": np.full((3,), 8.0, np.float32)}
    cfg = dict(t1=1.0, rtol=1e-5, atol=1e-7, max_steps=512)
    jreq = J.Request(z0=z0, config=J.RequestConfig(**cfg),
                     event=JC.Event(_event_cond_j, direction=-1))
    treq = Request(z0=z0, config=RequestConfig(**cfg),
                   event=TC.Event(_event_cond_t, direction=-1))
    jeng = J.ContinuousBatchingEngine(J.decay_dynamics, None,
                                      timer=make_timer())
    teng = _engine(config=EngineConfig())
    jeng.submit([jreq])
    teng.submit([treq])
    jrep, trep = jeng.run(), teng.run()
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    np.testing.assert_allclose(teng.event_times[treq.rid],
                               jeng.event_times[jreq.rid], **TOL)
    assert abs(teng.event_times[treq.rid] - np.log(2.0) / 8.0) < 1e-4
    for k in z0:
        np.testing.assert_allclose(teng.results[treq.rid][k],
                                   np.asarray(jeng.results[jreq.rid][k]),
                                   **TOL)


def test_mlp_field_matches_jax():
    """The launcher's field: the same weights from the same rng, f within
    1e-6, and the same request stream after it."""
    jf, jp = jserve.mlp_field(np.random.default_rng(4), 16)
    tf, tp = tserve.mlp_field(np.random.default_rng(4), 16, device=CPU)
    for k in jp:
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
    g = np.random.default_rng(5)
    z = {"y": g.standard_normal(16).astype(np.float32),
         "scale": np.full((16,), 3.0, np.float32)}
    want = jf(jp, {k: jnp.asarray(v) for k, v in z.items()}, 0.0)
    got = tf(tp, _tensors(z), torch.zeros(()))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tserve.mlp_field(np.random.default_rng(4), 4)


def test_serve_ode_matches_jax(capsys):
    """serve_ode all-at-once on each package: the same field and stream,
    so the same rounds, completions, f-evals and occupancy (the latencies
    are wall clock)."""
    kw = dict(batch=4, d_state=4, n_requests=10, chunk_steps=8, seed=2,
              max_steps=256)
    jrep = jserve.serve_ode(**kw)
    trep = tserve.serve_ode(device=CPU, **kw)
    for field in ("n_requests", "n_completed", "n_rejected",
                  "fevals_per_request", "backfill_occupancy", "rounds"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert "device=cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# CLI smoke: launch/serve.py --mode ode through the engine
# ---------------------------------------------------------------------------

class TestServeCLI:
    def test_mode_default_batch_single_source(self):
        assert tserve.MODE_DEFAULT_BATCH == {"lm": 4, "ode": 64}

    def test_ode_mode_smoke(self, capsys):
        tserve.main([
            "--mode", "ode", "--batch", "2", "--requests", "5",
            "--d-state", "4", "--chunk-steps", "8", "--rate", "500",
            "--seed", "3", "--t1", "0.5", "--rtol", "1e-3", "--atol",
            "1e-4", "--max-steps", "128", "--device", "cpu"])
        out = capsys.readouterr().out
        # run header prints the resolved batch + forwarded CLI knobs
        assert "batch(slots)=2" in out
        assert "t1=0.5" in out and "seed=3" in out
        assert "engine=continuous" in out
        assert "serve[continuous]" in out      # the ServeReport
        assert "5 completed" in out

    def test_ode_mode_static_engine(self, capsys):
        tserve.main([
            "--mode", "ode", "--ode-engine", "static", "--batch",
            "2", "--requests", "4", "--d-state", "4", "--chunk-steps",
            "8", "--max-steps", "128", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "engine=static" in out and "serve[static]" in out

    def test_production_mesh_is_refused(self):
        with pytest.raises(ValueError, match="production-mesh"):
            tserve.main(["--mode", "ode", "--production-mesh",
                         "--device", "cpu"])


# ---------------------------------------------------------------------------
# ReproducibleController: the engine's controller arithmetic
# ---------------------------------------------------------------------------

def test_reproducible_controller_rounds_once():
    """Its power and error norm are float64 rounded once: the correctly
    rounded float32 power, and a per-row norm bit-equal to the norm of
    the row alone; the default controller's float32 arithmetic is left as
    it was."""
    from repro_torch.core.stepsize import next_step_size
    rc = TC.ReproducibleController(1e-3, 1e-4, 64)
    ac = TC.AdaptiveController(1e-3, 1e-4, 64)
    assert isinstance(rc, TC.AdaptiveController) and rc != ac
    assert dataclasses.astuple(rc) == dataclasses.astuple(ac)

    g = np.random.default_rng(13)
    ratio = (10.0 ** g.uniform(-6, 2, 4096)).astype(np.float32)
    h = g.uniform(-0.1, 0.1, 4096).astype(np.float32)
    assert torch.equal(
        ac.next_step(torch.as_tensor(h), torch.as_tensor(ratio), 2),
        next_step_size(torch.as_tensor(h), torch.as_tensor(ratio), 2))
    got = rc.next_step(torch.as_tensor(h), torch.as_tensor(ratio),
                       2).numpy()
    power = (ratio.astype(np.float64)
             ** float(np.float32(-1.0 / 3.0))).astype(np.float32)
    factor = np.clip(np.float32(0.9) * power, np.float32(0.2),
                     np.float32(10.0))
    assert np.array_equal(got, h * factor)

    b, d = 6, 1570
    err, z0, z1 = ({"a": torch.as_tensor(g.standard_normal((b, d)),
                                         dtype=torch.float32),
                    "b": torch.as_tensor(g.standard_normal((b, 3)),
                                         dtype=torch.float32)}
                   for _ in range(3))
    rows = rc.norm(err, z0, z1, 1e-3, 1e-4, rows=True)
    for i in range(b):
        one = rc.error_ratio(*({k: v[i] for k, v in t.items()}
                               for t in (err, z0, z1)))
        assert torch.equal(rows[i], one)
    # the initial step: the engine's per-row proposals, grouped by
    # tolerance pair, equal each request's own controller's
    cfgs = [RequestConfig(t0=float(a), t1=float(b), rtol=float(r),
                          atol=float(q))
            for a, b, r, q in zip(g.uniform(-1, 1, 64), g.uniform(1.5, 3, 64),
                                  10.0 ** g.uniform(-7, -1, 64),
                                  10.0 ** g.uniform(-9, -3, 64))]
    cfgs += [RequestConfig(t0=1.0, t1=-0.5, rtol=1e-3)] * 3
    want = _engine()._initial_steps(cfgs)
    for c, w in zip(cfgs, want):
        got = TC.ReproducibleController(c.rtol, c.atol, 8).initial_step(
            torch.tensor(np.float32(c.span)))
        assert float(got) == float(w)
    assert (want[-3:] < 0).all()
    # the default norm is the float32 one
    want = sum(torch.sum(((e / (1e-4 + 1e-3 * torch.maximum(a.abs(),
                                                            c.abs())))
                          ** 2)) for e, a, c in zip(
        err.values(), z0.values(), z1.values()))
    assert torch.equal(error_ratio(err, z0, z1, 1e-3, 1e-4),
                       torch.sqrt(want / (b * (d + 3))))


def test_reproducible_rows_equal_their_single_solves():
    """A PerSample batch of serve_load's stiffness mix under
    ReproducibleController: every row's counters and end state equal its
    own single solve()'s, bit for bit."""
    rng = np.random.default_rng(21)
    lam = (10.0 ** rng.uniform(np.log10(0.5), np.log10(200.0), 6)).astype(
        np.float32)
    y0 = rng.standard_normal((6, 16)).astype(np.float32)
    z0 = {"y": torch.as_tensor(y0),
          "lam": torch.as_tensor(np.repeat(lam[:, None], 16, 1))}
    ctrl = TC.ReproducibleController(1e-3, 1e-4, 2048)
    solver = TC.ALF(eta=0.9)
    sol = TC.solve(decay_dynamics, None, z0, 0.0, 1.0, solver=solver,
                   controller=ctrl, batching=TC.PerSample())
    per = sol.stats.per_sample
    for i in range(6):
        one = TC.solve(decay_dynamics, None, {k: v[i] for k, v in z0.items()},
                       0.0, 1.0, solver=solver, controller=ctrl)
        assert int(per.n_fevals[i]) == int(one.stats.n_fevals)
        assert int(per.n_accepted[i]) == int(one.stats.n_accepted)
        assert torch.equal(sol.ys["y"][i], one.ys["y"])
