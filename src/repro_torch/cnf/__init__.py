"""repro_torch.cnf — FFJORD-class continuous normalizing flows on
``solve()``: trace estimators, the flow's densities and samples, losses.
The JAX package's ``repro.cnf`` on PyTorch."""
from .estimators import (TRACE_ESTIMATORS, Exact, Hutchinson, TraceEstimator,
                         get_estimator)
from .flow import CNF, CNFResult
from .losses import bits_per_dim, cnf_loss, nll_nats

__all__ = ["CNF", "CNFResult", "TraceEstimator", "Exact", "Hutchinson",
           "TRACE_ESTIMATORS", "get_estimator", "nll_nats", "bits_per_dim",
           "cnf_loss"]
