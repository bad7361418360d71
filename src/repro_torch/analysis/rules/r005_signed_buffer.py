"""R005 — signed-buffer discipline in replay paths.

The gradient methods replay a recorded, *signed* ``(t_i, h_i)`` step
buffer: reverse-time solves record negative steps, and the backward
sweeps reconstruct states by stepping ``-h_i`` from the endpoint. An
``abs(h)`` (or ``torch.abs``, ``.abs()``) inside a backward/replay function
is an unsigned-step assumption — it reproduces forward-time results and
silently corrupts every reverse-time gradient (time is an axis: both
directions are first-class).

The rule flags any `abs` call (``abs``, ``torch.abs``, ``np.abs``, a
tensor's ``.abs()``) inside functions matching the replay naming
convention (``*_bwd``, ``reverse_*``, ``*_replay*``). Forward drivers may
use ``abs`` freely for error control and span bookkeeping — those
comparisons are direction-agnostic by design. The port's copy of the JAX
package's rule.
"""
from __future__ import annotations

import ast
import re
from typing import List

from .common import Violation, dotted_name, iter_functions, own_nodes

RULE = "R005"

_REPLAY_NAME = re.compile(r"(_bwd$)|(^reverse_)|(_replay)")
_ABS_CALLS = {"abs", "torch.abs", "torch.absolute", "np.abs", "numpy.abs",
              "math.fabs"}


def check(tree: ast.AST, src: str, path: str, ctx) -> List[Violation]:
    out: List[Violation] = []
    for fdef, chain in iter_functions(tree):
        names = [f.name for f in chain] + [fdef.name]
        if not any(_REPLAY_NAME.search(n) for n in names):
            continue
        for node in own_nodes(fdef):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d not in _ABS_CALLS and isinstance(
                        node.func, ast.Attribute) and node.func.attr in (
                        "abs", "abs_", "absolute"):
                    d = f".{node.func.attr}()"
                if d in _ABS_CALLS or (d or "").startswith(".abs"):
                    out.append(Violation(
                        RULE, path, node.lineno,
                        f"`{d}` inside replay path `{fdef.name}` — the "
                        f"(t_i, h_i) record is signed; stripping the sign "
                        f"breaks reverse-time replay (keep the step's "
                        f"direction, compare magnitudes on the forward "
                        f"side only)"))
    return out
