"""repro_torch.analysis: odelint static checks + the trace audit, for
the port.

The counterpart of the JAX package's ``repro.analysis``, for the
invariants that mean something in eager PyTorch on the card:

* :mod:`repro_torch.analysis.lint` — **odelint**, an AST linter (stdlib
  ``ast``, no third-party deps) with the port's rules R001 (host reads),
  R003 (the CUDA launchers' contracts), R004 (registries) and R005
  (signed replay buffers) over ``core/``, ``kernels/`` and ``cnf/``;
* :mod:`repro_torch.analysis.trace_audit` — a sweep of the Solver x
  GradientMethod x StepController x Batching x direction matrix on small
  CPU tensors (shapes, dtypes, counters, backward through every
  gradient method, the invalid pairings), the serve, train and CNF
  audits, and the value-hash contract of the static config objects.

Entry point: ``PYTHONPATH=src python -m repro_torch.analysis
[--json analysis_report.json]`` — exits non-zero on any violation. See
``src/repro_torch/analysis/README.md`` for the rule catalogue.
"""
from .lint import Violation, lint_source, run_lint

__all__ = ["Violation", "lint_source", "run_lint"]
