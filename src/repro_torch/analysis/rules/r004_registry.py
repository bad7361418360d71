"""R004 — registry completeness.

Every registered ``Solver`` / ``GradientMethod`` / ``Batching`` subclass
must (a) implement the full abstract interface of its base (every base
method whose body is ``raise NotImplementedError``), and (b) appear in at
least one test — by class name or by its registry key. A solver that can
be selected by string but is exercised nowhere is exactly how the matrix
rots as it grows (the ROADMAP's solver-zoo direction multiplies it).

The port's copy of the JAX package's rule. It introspects the port's
*live* registries (it imports ``repro_torch.core``, ``serve``, ``train``
and ``cnf``) rather than re-deriving them from the AST — the point is to
audit what a user can actually reach through ``solve()`` — and reads the
port's own tests (``tests/test_torch_*.py``).
"""
from __future__ import annotations

import inspect
import re
from pathlib import Path
from typing import Dict, List, Set

from .common import Violation

RULE = "R004"


def _abstract_members(base: type) -> List[str]:
    """Names of `base` methods/properties whose body raises
    NotImplementedError (the repo's convention for 'abstract')."""
    out = []
    for name, member in vars(base).items():
        fn = member.fget if isinstance(member, property) else member
        if not callable(fn):
            continue
        try:
            src = inspect.getsource(fn)
        except (OSError, TypeError):
            continue
        if "raise NotImplementedError" in src:
            out.append(name)
    return out


def _overrides(cls: type, base: type, name: str) -> bool:
    for klass in cls.__mro__:
        if klass is base:
            return False
        if name in vars(klass):
            return True
    return False


def _load_registries():
    from repro_torch.core import (ACA, MALI, SOLVERS, Backsolve, Batching,
                            GradientMethod, Naive, Solver)

    solvers: Dict[type, Set[str]] = {}
    for key, inst in SOLVERS.items():
        solvers.setdefault(type(inst), set()).add(key)
    # METHODS in core/api.py is the legacy string tuple; the live
    # GradientMethod classes are the four paper rows.
    methods: Dict[type, Set[str]] = {
        MALI: {"mali"}, Naive: {"naive"}, ACA: {"aca"},
        Backsolve: {"adjoint", "backsolve"},
    }
    batchings = {sub: {sub.__name__} for sub in Batching.__subclasses__()}
    # Serve-layer policy registries: every admission / scheduling /
    # cache-eviction policy reachable by string must carry the full
    # interface and show up in tests, same contract as the solver zoo.
    from repro_torch.serve import (ADMISSION_POLICIES, CACHE_POLICIES,
                             SCHEDULING_POLICIES, AdmissionPolicy,
                             CachePolicy, SchedulingPolicy)

    def by_class(reg) -> Dict[type, Set[str]]:
        out: Dict[type, Set[str]] = {}
        for key, inst in reg.items():
            out.setdefault(type(inst), set()).add(key)
        return out

    # Train-layer registries: loop drivers and telemetry sinks are
    # string-reachable through TrainerConfig, so they carry the same
    # completeness contract.
    from repro_torch.train import EMITTERS, TRAIN_LOOPS, MetricsEmitter, TrainLoop

    emitters = {cls: {key} for key, cls in EMITTERS.items()}

    # CNF trace estimators: string-reachable through
    # cnf.get_estimator, so same completeness contract.
    from repro_torch.cnf import TRACE_ESTIMATORS, TraceEstimator

    return [(Solver, solvers), (GradientMethod, methods),
            (Batching, batchings),
            (AdmissionPolicy, by_class(ADMISSION_POLICIES)),
            (SchedulingPolicy, by_class(SCHEDULING_POLICIES)),
            (CachePolicy, by_class(CACHE_POLICIES)),
            (TrainLoop, by_class(TRAIN_LOOPS)),
            (MetricsEmitter, emitters),
            (TraceEstimator, by_class(TRACE_ESTIMATORS))]


def check_registries(tests_dir) -> List[Violation]:
    out: List[Violation] = []
    tests_dir = Path(tests_dir)
    corpus = "\n".join(
        p.read_text() for p in sorted(tests_dir.glob("test_torch_*.py")))

    for base, registry in _load_registries():
        required = _abstract_members(base)
        for cls, keys in sorted(registry.items(), key=lambda kv:
                                kv[0].__name__):
            path = inspect.getsourcefile(cls) or "<unknown>"
            try:
                line = inspect.getsourcelines(cls)[1]
            except (OSError, TypeError):
                line = 1
            for name in required:
                if not _overrides(cls, base, name):
                    out.append(Violation(
                        RULE, path, line,
                        f"registered {base.__name__} subclass "
                        f"`{cls.__name__}` does not implement abstract "
                        f"member `{name}`"))
            mentions = {cls.__name__} | keys
            if not any(re.search(rf"\b{re.escape(m)}\b", corpus)
                       for m in mentions):
                out.append(Violation(
                    RULE, path, line,
                    f"registered {base.__name__} `{cls.__name__}` "
                    f"(keys: {', '.join(sorted(keys))}) appears in no "
                    f"test under tests/test_torch_*.py — add at least a smoke "
                    f"solve"))
    return out


def missing_interface(cls: type, base: type) -> List[str]:
    """Test hook: abstract members of `base` that `cls` fails to override."""
    return [name for name in _abstract_members(base)
            if not _overrides(cls, base, name)]
