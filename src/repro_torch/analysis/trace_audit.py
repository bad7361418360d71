"""Trace audit of the solve() configuration matrix, for the port.

The counterpart of the JAX package's ``repro.analysis.trace_audit``,
which sweeps with ``jax.eval_shape`` on no device. Eager PyTorch has no
abstract evaluation that runs an adaptive solve (the controller reads
the host once a trial), so the sweeps run on small real tensors (D 3,
B 4, T 5, the JAX audit's sizes) on ``device`` (the CUDA card unless
the caller passes ``"cpu"``):

* **Shape audit** — the same Solver x GradientMethod x StepController x
  Batching x direction matrix (the combos carry the JAX audit's names;
  ``alf-pallas`` is ``ALF(backend="cuda")``, the kernel ops), every
  ``Solution``'s output shapes and dtypes against golden specs
  (trajectory ``(T, D)`` / ``(B, T, D)`` float32, counters int32);
  ``torch.autograd.grad`` through all four gradient methods; the three
  known-invalid pairings asserted to raise their validation errors.
  :func:`shape_specs` gives every combo's specs.
* **Serve / train / CNF audits** — ``chunk_transition`` spec-preserving,
  ``train_step`` spec-preserving on (params, opt_state) with its
  metrics, ``CNF.log_prob`` across estimators x gradient methods with
  the gradient through params and ``t1``, and the CNF's invalid
  pairings.
* **Value-hash audit** — what the JAX retrace audit guards: fresh,
  equal-valued static config objects (solver, controller, gradient,
  ``SaveAt``, ``Event``, batching; the serve, train and CNF configs)
  compare and hash equal, so caches keyed on them hit. The JAX audit's
  trace count itself has no counterpart in eager PyTorch (nothing is
  traced); the report says so under ``"retrace"``.

Emits the dict that ``python -m repro_torch.analysis`` merges into
``analysis_report.json``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

D = 3          # state dim
B = 4          # batch size
T = 5          # observation-grid length
F32 = torch.float32

NO_RETRACE = ("no counterpart: eager PyTorch traces nothing, so the JAX "
              "audit's trace count has none; the value-hash audit checks "
              "what it guards (fresh equal-valued statics compare and hash "
              "equal)")

Spec = Tuple[Tuple[int, ...], str]


def _dynamics():
    def f(params, z, t):
        return torch.tanh(z @ params["w"]) + t * params["b"]
    return f


def _params(dev, requires_grad: bool = False):
    gen = torch.Generator().manual_seed(0)
    p = {"w": 0.3 * torch.randn((D, D), generator=gen),
         "b": 0.1 * torch.randn((D,), generator=gen)}
    return {k: v.to(dev).requires_grad_(requires_grad) for k, v in p.items()}


def _z0(batched: bool, dev):
    gen = torch.Generator().manual_seed(1)
    return torch.randn((B, D) if batched else (D,), generator=gen).to(dev)


def _method_solver_pairs():
    from repro_torch.core import (ACA, ALF, MALI, Backsolve, Bosh3, Dopri5,
                                  HeunEuler, Naive)
    return [
        ("mali/alf", MALI(), ALF()),
        ("mali/alf-eta0.9", MALI(), ALF(eta=0.9)),
        ("mali/alf-pallas", MALI(), ALF(backend="cuda")),
        ("naive/alf", Naive(), ALF()),
        ("naive/heun_euler", Naive(), HeunEuler()),
        ("aca/heun_euler", ACA(), HeunEuler()),
        ("aca/bosh3", ACA(), Bosh3()),
        ("aca/dopri5", ACA(), Dopri5()),
        ("backsolve/dopri5", Backsolve(), Dopri5()),
        ("backsolve/alf", Backsolve(), ALF()),
    ]


def _controllers():
    from repro_torch.core import AdaptiveController, ConstantSteps
    return [("const4", ConstantSteps(4)),
            ("adaptive", AdaptiveController(1e-2, 1e-3, 16))]


def _spec(t: torch.Tensor) -> Spec:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _expect(combo: str, actual: torch.Tensor, shape, dtype) -> List[str]:
    errs = []
    if tuple(actual.shape) != tuple(shape):
        errs.append(f"{combo}: shape {tuple(actual.shape)} != golden "
                    f"{tuple(shape)}")
    if actual.dtype != dtype:
        errs.append(f"{combo}: dtype {actual.dtype} != golden {dtype}")
    return errs


def _grid(t0, t1, dev):
    return torch.linspace(t0, t1, T, dtype=F32, device=dev)


def _shape_cases():
    """(name, gradient, solver, controller, t0, t1, batching) of every
    forward combo, in the JAX audit's order."""
    from repro_torch.core import Lockstep, PerSample
    out = []
    for pname, gradient, solver in _method_solver_pairs():
        for cname, controller in _controllers():
            for dname, (t0, t1) in (("fwd", (0.0, 1.0)),
                                    ("rev", (1.0, 0.0))):
                for bname, batching in (("unbatched", None),
                                        ("lockstep", Lockstep())):
                    out.append((f"{pname}/{cname}/{dname}/{bname}",
                                gradient, solver, controller, t0, t1,
                                batching))
                if controller.adaptive:
                    # PerSample requires adaptive control
                    out.append((f"{pname}/{cname}/{dname}/per_sample",
                                gradient, solver, controller, t0, t1,
                                PerSample()))
    return out


def _grad_cases():
    from repro_torch.core import (ACA, ALF, MALI, AdaptiveController,
                                  Backsolve, ConstantSteps, Dopri5,
                                  HeunEuler, Naive)
    return [
        ("grad/mali/alf", MALI(), ALF(), ConstantSteps(4)),
        ("grad/mali/alf-pallas", MALI(), ALF(backend="cuda"),
         ConstantSteps(4)),
        ("grad/naive/alf", Naive(), ALF(), AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/naive/alf-pallas", Naive(), ALF(backend="cuda"),
         AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/aca/heun_euler", ACA(), HeunEuler(),
         AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/backsolve/dopri5", Backsolve(), Dopri5(), ConstantSteps(4)),
    ]


def run_shape_audit(device=None):
    """-> (n_combos, [failure strings], {combo: {output: (shape, dtype)}})."""
    from repro_torch.core import (ACA, ALF, MALI, Dopri5, Naive, Rk4, SaveAt,
                                  solve)
    dev = resolve_device(device)
    f = _dynamics()
    failures: List[str] = []
    specs: Dict[str, Dict[str, Spec]] = {}
    combos = 0

    for name, gradient, solver, controller, t0, t1, batching in \
            _shape_cases():
        combos += 1
        batched = batching is not None
        try:
            sol = solve(f, _params(dev), _z0(batched, dev), t0, t1,
                        solver=solver, controller=controller,
                        gradient=gradient,
                        saveat=SaveAt(ts=_grid(t0, t1, dev)),
                        batching=batching)
        except Exception as e:  # noqa: BLE001 — report, don't abort sweep
            failures.append(f"{name}: solve raised {type(e).__name__}: {e}")
            continue
        ys_shape = (B, T, D) if batched else (T, D)
        failures.extend(_expect(name + ".ys", sol.ys, ys_shape, F32))
        failures.extend(_expect(name + ".ts", sol.ts, (T,), F32))
        specs[name] = {"ys": _spec(sol.ys), "ts": _spec(sol.ts)}
        for counter in ("n_accepted", "n_rejected", "n_fevals"):
            a = getattr(sol.stats, counter)
            specs[name][counter] = _spec(a)
            if a.dtype != torch.int32:
                failures.append(f"{name}.stats.{counter}: dtype "
                                f"{a.dtype} != int32")

    # gradient shapes: reverse mode through every gradient method
    for name, gradient, solver, controller in _grad_cases():
        for dname, (t0, t1) in (("fwd", (0.0, 1.0)), ("rev", (1.0, 0.0))):
            combos += 1
            cname = f"{name}/{dname}"
            params = _params(dev, requires_grad=True)
            try:
                sol = solve(f, params, _z0(False, dev), t0, t1,
                            solver=solver, controller=controller,
                            gradient=gradient,
                            saveat=SaveAt(ts=_grid(t0, t1, dev)))
                grads = torch.autograd.grad(torch.sum(sol.ys),
                                            list(params.values()))
            except Exception as e:  # noqa: BLE001
                failures.append(f"{cname}: grad raised "
                                f"{type(e).__name__}: {e}")
                continue
            specs[cname] = {}
            for (key, p), g in zip(params.items(), grads):
                failures.extend(_expect(f"{cname}.grad[{key}]", g,
                                        p.shape, p.dtype))
                specs[cname][f"grad[{key}]"] = _spec(g)

    # invalid pairings must be REJECTED at validation
    invalid = [
        ("invalid/mali/dopri5", MALI(), Dopri5(), "ALF solver only"),
        ("invalid/aca/alf", ACA(), ALF(), "Runge-Kutta"),
        ("invalid/naive-adaptive/rk4", Naive(), Rk4(), "error estimate"),
    ]
    for name, gradient, solver, needle in invalid:
        combos += 1
        try:
            solve(f, _params(dev), _z0(False, dev), 0.0, 1.0, solver=solver,
                  gradient=gradient)
            failures.append(f"{name}: expected ValueError, solved fine")
        except ValueError as e:
            if needle not in str(e):
                failures.append(f"{name}: error lacks {needle!r}: {e}")
        except Exception as e:  # noqa: BLE001
            failures.append(f"{name}: expected ValueError, got "
                            f"{type(e).__name__}: {e}")
    return combos, failures, specs


def shape_specs(device=None) -> Dict[str, Dict[str, Spec]]:
    """Every shape-audit combo's output specs, ``{combo: {output:
    (shape, dtype name)}}``."""
    return run_shape_audit(device)[2]


# --------------------------------------------------------------------------
# Value-hash audit (the JAX retrace audit's counterpart)
# --------------------------------------------------------------------------

def _event_cond(z, t):
    # module-level on purpose: Event equality compares cond_fn by
    # identity, so a stable function object is what makes fresh Events
    # equal
    return torch.sum(z) - 10.0


def retrace_cases():
    """Each case: (name, fresh() -> static kwargs dict). fresh() builds
    new, equal-valued instances of every static object each call."""
    from repro_torch.core import (ACA, ALF, MALI, AdaptiveController,
                                  Backsolve, ConstantSteps, Dopri5, Event,
                                  Lockstep, SaveAt)

    def mali_grid():
        return dict(solver=ALF(eta=0.9), controller=ConstantSteps(4),
                    gradient=MALI(),
                    saveat=SaveAt(ts=np.linspace(0.0, 1.0, T)),
                    batching=None, event=None)

    def aca_batched():
        return dict(solver=Dopri5(),
                    controller=AdaptiveController(1e-2, 1e-3, 16),
                    gradient=ACA(), saveat=SaveAt(),
                    batching=Lockstep(), event=None)

    def backsolve_event():
        return dict(solver=Dopri5(),
                    controller=AdaptiveController(1e-2, 1e-3, 16),
                    gradient=Backsolve(), saveat=SaveAt(),
                    batching=None, event=Event(_event_cond, direction=+1))

    return [("mali/alf/const/ts-grid", mali_grid),
            ("aca/dopri5/adaptive/lockstep", aca_batched),
            ("backsolve/dopri5/event", backsolve_event)]


def value_hash_failures(name: str, fresh) -> List[str]:
    """The static objects of ``fresh()`` that two fresh builds do not
    compare or hash equal (empty: the contract holds)."""
    a, b = fresh(), fresh()
    if not isinstance(a, dict):
        a, b = {"": a}, {"": b}
    out = []
    for key in a:
        x, y = a[key], b[key]
        try:
            same = x == y and hash(x) == hash(y)
        except TypeError as e:
            same = False
            key = f"{key} ({e})"
        if not same:
            out.append(f"{name}{'.' + key if key else ''}: fresh "
                       "equal-valued instances compare/hash unequal — a "
                       "cache keyed on it misses every step")
    return out


# --------------------------------------------------------------------------
# Serve audit: the chunked re-dispatch entry point
# --------------------------------------------------------------------------

def _serve_dynamics(params, z, t):
    del params, t
    return -z


def _serve_slots(b: int, dev):
    from repro_torch.serve.engine import SlotBatch
    vec = torch.ones((b, D), dtype=F32, device=dev)
    row = torch.ones((b,), dtype=F32, device=dev)
    return SlotBatch(
        state=(vec.clone(), vec.clone()), t=row * 0, t1=row.clone(),
        h=row * 0.1, rtol=row.clone(), atol=row.clone(),
        budget=torch.full((b,), 64, dtype=torch.int32, device=dev),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        reached=torch.zeros((b,), dtype=torch.bool, device=dev),
        n_trials=torch.zeros((b,), dtype=torch.int32, device=dev),
        n_accepted=torch.zeros((b,), dtype=torch.int32, device=dev))


def _leaves_with_paths(tree):
    import torch.utils._pytree as _pt
    from repro_torch.distributed.sharding import _path_names
    return [("/".join(_path_names(p)), l)
            for p, l in _pt.tree_flatten_with_path(tree)[0]]


def run_serve_audit(device=None):
    """``chunk_transition`` must be spec-preserving (the engine writes a
    round into the same buffers), and the frozen request/engine configs
    value-hashed. Returns (n_combos, [failures], {case: ok})."""
    from repro_torch.core import ALF
    from repro_torch.serve import EngineConfig, RequestConfig
    from repro_torch.serve.engine import chunk_transition
    dev = resolve_device(device)
    failures: List[str] = []
    combos = 0
    for b, chunk_steps in ((1, 1), (4, 8), (8, 32)):
        combos += 1
        name = f"serve:chunk_transition/b{b}/c{chunk_steps}"
        slots = _serve_slots(b, dev)
        want = [(p, torch.empty(l.shape, dtype=l.dtype))
                for p, l in _leaves_with_paths(slots)]
        try:
            out = chunk_transition({}, slots, f=_serve_dynamics,
                                   solver=ALF(eta=0.9),
                                   chunk_steps=chunk_steps)
        except Exception as e:  # noqa: BLE001
            failures.append(f"{name}: raised {type(e).__name__}: {e}")
            continue
        got = _leaves_with_paths(out)
        for (pi, li), (po, lo) in zip(want, got):
            if pi != po or tuple(li.shape) != tuple(lo.shape) or \
                    li.dtype != lo.dtype:
                failures.append(f"{name}/{pi}: {tuple(lo.shape)}/{lo.dtype}"
                                f" != input {tuple(li.shape)}/{li.dtype} — "
                                "dispatch is no longer shape-preserving")
    cases = {}
    for name, fresh in (
            ("serve:RequestConfig",
             lambda: RequestConfig(t1=2.0, rtol=1e-4, atol=1e-5,
                                   max_steps=64, dense=True)),
            ("serve:EngineConfig",
             lambda: EngineConfig(slots=4, chunk_steps=8,
                                  solver=ALF(eta=0.9)))):
        combos += 1
        bad = value_hash_failures(name, fresh)
        failures.extend(bad)
        cases[name] = not bad
    return combos, failures, cases


# --------------------------------------------------------------------------
# Train audit: the training step
# --------------------------------------------------------------------------

def run_train_audit(device=None):
    """``train_step`` must be spec-preserving on (params, opt_state), so
    the checkpoint restore template matches the live state, and its
    metrics carry the loss, lr, grad norm and int32 ODE counters; the
    frozen configs value-hash. Returns (n_combos, [failures],
    {case: ok})."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.ode_block import OdeSettings
    from repro_torch.models import init_lm
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train import TrainerConfig
    from repro_torch.train.loop import train_step
    dev = resolve_device(device)
    failures: List[str] = []
    combos = 0
    bt, st = 2, 8

    def fresh_cfg():
        return smoke_config("qwen3-1.7b",
                            OdeSettings(mode="per_block", method="mali",
                                        solver="alf", n_steps=2))

    def fresh_opt():
        return OptimizerConfig(total_steps=10, warmup_steps=2)

    cfg, opt_cfg = fresh_cfg(), fresh_opt()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lm(gen, cfg, dev)
    opt = init_opt_state(opt_cfg, params)
    p_spec = [(p, torch.empty(l.shape, dtype=l.dtype))
              for p, l in _leaves_with_paths(params)]
    o_spec = [(p, torch.empty(l.shape, dtype=l.dtype))
              for p, l in _leaves_with_paths(opt)]
    batch = {k: torch.randint(0, cfg.vocab_size, (bt, st), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    combos += 1
    name = "train:step/mali-smoke"
    try:
        p2, o2, _, metrics = train_step(params, opt, None, batch, cfg=cfg,
                                        opt_cfg=opt_cfg)
    except Exception as e:  # noqa: BLE001
        failures.append(f"{name}: raised {type(e).__name__}: {e}")
    else:
        for tag, got, want in (("params", p2, p_spec), ("opt", o2, o_spec)):
            got = _leaves_with_paths(got)
            if len(got) != len(want):
                failures.append(f"{name}.{tag}: {len(got)} leaves != "
                                f"{len(want)}")
            for (pi, li), (po, lo) in zip(want, got):
                if pi != po or tuple(li.shape) != tuple(lo.shape) or \
                        li.dtype != lo.dtype:
                    failures.append(
                        f"{name}.{tag}/{pi}: {tuple(lo.shape)}/{lo.dtype} "
                        f"!= input {tuple(li.shape)}/{li.dtype} — the step "
                        "is no longer spec-preserving")
        for key in ("loss", "lr", "grad_norm", "ode_accepted",
                    "ode_rejected", "ode_fevals"):
            if key not in metrics:
                failures.append(f"{name}: metrics lacks {key!r}")
        for key in ("ode_accepted", "ode_rejected", "ode_fevals"):
            if key in metrics and metrics[key].dtype != torch.int32:
                failures.append(f"{name}: metrics[{key!r}] dtype "
                                f"{metrics[key].dtype} != int32")
    cases = {}
    for cname, fresh in (("train:ModelConfig", fresh_cfg),
                         ("train:OptimizerConfig", fresh_opt),
                         ("train:TrainerConfig",
                          lambda: TrainerConfig(steps=10))):
        combos += 1
        bad = value_hash_failures(cname, fresh)
        failures.extend(bad)
        cases[cname] = not bad
    return combos, failures, cases


# --------------------------------------------------------------------------
# CNF audit: augmented solves + gradients through the bound
# --------------------------------------------------------------------------

def _cnf_vfield(params, z, t):
    # module-level on purpose: CNF is a frozen dataclass whose equality
    # compares ``vfield`` by identity
    return torch.tanh(z @ params["w"]) + t * params["b"]


def run_cnf_audit(device=None):
    """``CNF.log_prob`` must give (B,) f32 logp/logdet/kinetic for every
    trace estimator x gradient method, and reverse mode must go through
    both the params and ``t1`` (``diff_bounds=True``); the pairings it
    cannot serve must raise ``ValueError``; fresh equal flows value-hash.
    Returns (n_combos, [failures], {case: ok})."""
    from repro_torch.cnf import CNF, Exact, Hutchinson
    from repro_torch.core import (ALF, MALI, ConstantSteps, Naive, SaveAt,
                                  solve)
    from repro_torch.core.interface import Sharded
    dev = resolve_device(device)
    failures: List[str] = []
    combos = 0
    estimators = [("exact", Exact(), False),
                  ("hutchinson", Hutchinson(), True),
                  ("hutchinson_gaussian", Hutchinson(dist="gaussian"), True)]
    methods = [("mali", MALI(), ALF()), ("naive", Naive(), ALF())]
    x = _z0(True, dev)
    for est_name, est, needs_gen in estimators:
        flow = CNF(_cnf_vfield, dim=D, estimator=est)
        for m_name, gradient, solver in methods:
            name = f"cnf:logprob/{m_name}/{est_name}"
            params = _params(dev, requires_grad=True)
            t1 = torch.tensor(1.0, dtype=F32, device=dev, requires_grad=True)
            gen = (torch.Generator(device=dev).manual_seed(0) if needs_gen
                   else None)
            combos += 1
            try:
                res = flow.log_prob(params, x, gen, solver=solver,
                                    controller=ConstantSteps(4),
                                    gradient=gradient, t1=t1,
                                    diff_bounds=True)
            except Exception as e:  # noqa: BLE001
                failures.append(f"{name}: raised {type(e).__name__}: {e}")
                continue
            for field in ("logp", "logdet", "kinetic"):
                failures.extend(_expect(f"{name}.{field}",
                                        getattr(res, field), (B,), F32))
            combos += 1
            gname = f"cnf:grad/{m_name}/{est_name}"
            try:
                grads = torch.autograd.grad(-torch.mean(res.logp),
                                            [*params.values(), t1])
            except Exception as e:  # noqa: BLE001
                failures.append(f"{gname}: grad raised "
                                f"{type(e).__name__}: {e}")
                continue
            failures.extend(_expect(f"{gname}.d_t1", grads[-1], (), F32))
            for (key, p), g in zip(params.items(), grads):
                failures.extend(_expect(f"{gname}.d_params[{key}]", g,
                                        p.shape, p.dtype))
    f = _dynamics()
    invalid = [
        ("cnf:invalid/diff_bounds+steps",
         lambda: solve(f, _params(dev), _z0(False, dev), 0.0, 1.0,
                       controller=ConstantSteps(4),
                       saveat=SaveAt(steps=True), diff_bounds=True)),
        ("cnf:invalid/diff_bounds+sharded",
         lambda: solve(f, _params(dev), _z0(True, dev), 0.0, 1.0,
                       controller=ConstantSteps(4), batching=Sharded(),
                       diff_bounds=True)),
        ("cnf:invalid/hutchinson-no-key",
         lambda: Hutchinson().init_noise(None, torch.zeros((D,), dtype=F32,
                                                           device=dev))),
    ]
    for name, thunk in invalid:
        combos += 1
        try:
            thunk()
        except ValueError:
            pass
        except Exception as e:  # noqa: BLE001 — wrong error class
            failures.append(f"{name}: raised {type(e).__name__} "
                            f"({e}), want ValueError")
        else:
            failures.append(f"{name}: validation silently passed "
                            "(want ValueError)")
    combos += 1
    name = "cnf:logprob/mali-hutchinson"
    bad = value_hash_failures(name, lambda: dict(
        flow=CNF(_cnf_vfield, dim=D, estimator=Hutchinson()), solver=ALF(),
        controller=ConstantSteps(4), gradient=MALI()))
    failures.extend(bad)
    return combos, failures, {name: not bad}


def run_retrace_audit() -> Dict[str, bool]:
    """The solve statics' value-hash contract, case by case."""
    return {name: not value_hash_failures(name, fresh)
            for name, fresh in retrace_cases()}


def run_trace_audit(device=None) -> dict:
    t0 = time.time()
    combos, failures, _ = run_shape_audit(device)
    value_hash = run_retrace_audit()
    bad_hash = [m for name, fresh in retrace_cases()
                for m in value_hash_failures(name, fresh)]
    for audit in (run_serve_audit, run_train_audit, run_cnf_audit):
        n, fails, cases = audit(device)
        combos += n
        failures += fails
        value_hash.update(cases)
    return {
        "combos": combos,
        "shape_failures": failures,
        "retrace_counts": value_hash,
        "retrace_failures": bad_hash,
        "retrace": NO_RETRACE,
        "elapsed_s": round(time.time() - t0, 2),
        "ok": not failures and not bad_hash,
    }
