"""odelint rule modules of the port. Each AST rule exposes ``check(tree,
src, path, ctx)`` returning a list of
:class:`~repro_torch.analysis.rules.common.Violation`. R002 (the JAX
package's ``custom_vjp`` hygiene) has no counterpart: see the README."""
from . import (r001_host_read, r003_launchers, r004_registry,
               r005_signed_buffer)
from .common import Violation

# Rule id -> module. R004 is repo-level (runtime registry introspection)
# and the R003 check of the CUDA sources reads ``csrc/*.cu``; lint.py
# dispatches both itself.
AST_RULES = {
    "R001": r001_host_read,
    "R003": r003_launchers,
    "R005": r005_signed_buffer,
}

__all__ = ["AST_RULES", "Violation", "r003_launchers", "r004_registry"]
