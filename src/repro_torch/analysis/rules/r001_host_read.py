"""R001 — no host read of a device value in ``core/`` and ``kernels/``.

The torch analogue of the JAX package's R001 (no Python ``if``/``while``
on traced values). In eager PyTorch a branch on a tensor does not fail:
it reads the tensor on the host, which on the card waits for every
kernel queued before it (a sync). The fixed-step solves, the LM steps
and the serve round run without one (``chip_smoke.py`` checks it with
``torch.cuda.set_sync_debug_mode``), and a read that creeps into the
solver core costs a sync per step. Flagged:

* ``.item()`` and ``.tolist()`` calls (on any value but a numpy one:
  they exist to read a tensor on the host, parameters included);
* ``bool(t)`` / ``int(t)`` / ``float(t)`` of a device value;
* ``if`` / ``while`` whose test is a device value.

Device values are those of the taint model in
:mod:`repro_torch.analysis.rules.common` (made by ``torch.`` calls in
the function, or derived from them); metadata (``.shape``, ``.dim()``,
``.device``, ...) is a host value. An intended read carries
``# odelint: disable=R001 -- <reason>`` on its line.
"""
from __future__ import annotations

import ast
from typing import List

from .common import (Violation, dotted_name, expr_tainted, function_taint,
                     iter_functions, own_nodes)

RULE = "R001"

_CASTS = {"bool", "int", "float"}


def _host(node: ast.AST, hosts) -> bool:
    """Is this a numpy value (``np.``/``numpy.`` calls, ``.numpy()``, or
    a name assigned from one)? Its ``.tolist()`` reads nothing."""
    if isinstance(node, ast.Name):
        return node.id in hosts
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted_name(sub.func) or ""
            if d.startswith(("np.", "numpy.")) or (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "numpy"):
                return True
    return False


def _host_names(fdef) -> set:
    hosts: set = set()
    for node in own_nodes(fdef):
        if isinstance(node, ast.Assign) and _host(node.value, hosts):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    hosts.add(t.id)
    return hosts


def check(tree: ast.AST, src: str, path: str, ctx) -> List[Violation]:
    out: List[Violation] = []
    for fdef, chain in iter_functions(tree):
        env = set()
        for encl in chain:
            env |= function_taint(encl, env)
        tainted = function_taint(fdef, env)
        hosts = _host_names(fdef)
        for node in own_nodes(fdef):
            if isinstance(node, (ast.If, ast.While)) and \
                    expr_tainted(node.test, tainted):
                kw = "if" if isinstance(node, ast.If) else "while"
                out.append(Violation(
                    RULE, path, node.lineno,
                    f"Python `{kw}` on a device value in `{fdef.name}` "
                    f"reads it on the host (a sync on the card) — use "
                    f"torch.where, or branch on metadata"))
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in (
                        "item", "tolist") and not node.args \
                        and not _host(f.value, hosts):
                    out.append(Violation(
                        RULE, path, node.lineno,
                        f"`.{f.attr}()` in `{fdef.name}` reads a tensor "
                        f"on the host (a sync on the card)"))
                elif dotted_name(f) in _CASTS and len(node.args) == 1 \
                        and expr_tainted(node.args[0], tainted):
                    out.append(Violation(
                        RULE, path, node.lineno,
                        f"`{dotted_name(f)}(...)` of a device value in "
                        f"`{fdef.name}` reads it on the host (a sync on "
                        f"the card)"))
    return out
