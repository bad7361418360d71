"""R003 — the CUDA launchers' contracts.

The JAX package's R003 holds its Pallas calls to theirs (an explicit
grid, static block shapes, a divisibility guard on every grid division,
explicit casts at ref writes, a reverse rule or a registered reason for
every public op). Restated for the port's hand-written kernels:

* **R003a** the grid covers n: in a kernel source (``csrc/*.cu``) every
  division on a line that launches a kernel (``<<<...>>>``) or sets up
  its grid (the definition of a name the launch configuration reads,
  one level) is a ceiling division ``(X + Y - 1) / Y``. A
  floor division leaves the tail of the output unwritten.
* **R003b** a launcher (a function of ``kernels/<pkg>/<pkg>.py`` that
  calls the kernel's C entry point, ``_fn(...)(...)``, itself or through
  a helper of its module) checks its tensors' dtype and device before
  the launch: a ``raise`` under a test that reads ``dtype`` (or the
  dtype table) and one under a test that reads the device
  (``is_cuda``, ``device``, ``get_device``).
* **R003c** every launcher counts its launches (``LAUNCHES[...] += 1``
  after the call, itself or in that helper).
* **R003e** every public op of ``kernels/*/ops.py`` (a public function
  that counts its calls in ``OP_CALLS``) is differentiable through an
  ``autograd.Function`` of its module whose ``backward`` launches a
  kernel (calls a launcher, ``*_call``), or is listed in
  ``kernels/registry.py::NO_REVERSE_RULE`` with a reason of 20
  characters or more: forward-only ops are forward-only on purpose, and
  ``check_direct_backprop`` quotes the reason.
"""
from __future__ import annotations

import ast
import re
from typing import List, Set

from .common import Violation, dotted_name, iter_functions

RULE = "R003"


# -- R003a: the .cu sources ------------------------------------------------

_CEIL_RE = re.compile(r"\(([^()]*)\)\s*/\s*([\w:]+(?:<[\w:, ]*>)?(?:::\w+)?)")


def _strip_comments(line: str) -> str:
    return line.split("//", 1)[0]


def _uncovered_divisions(expr: str) -> int:
    """How many ``/`` in ``expr`` are not ceiling divisions
    ``(X + Y - 1) / Y``."""
    ok = 0
    for m in _CEIL_RE.finditer(expr):
        num, div = m.group(1), re.escape(m.group(2))
        if re.search(rf"\+\s*{div}\s*-\s*1\s*$", num):
            ok += 1
    return expr.count("/") - ok


_CU_SUPPRESS_RE = re.compile(
    r"//\s*odelint:\s*disable=([A-Z0-9, ]+?)\s*(?:--\s*(\S.*))?$")


def _defining(lines: List[str], name: str) -> List[int]:
    """The lines that assign ``name`` or construct it (``dim3 name(``)."""
    pat = re.compile(rf"\b{re.escape(name)}\s*=(?!=)|\bdim3\s+"
                     rf"{re.escape(name)}\s*\(")
    return [i for i, l in enumerate(lines) if pat.search(l)]


def check_cuda_source(src: str, path: str) -> List[Violation]:
    """R003a over one kernel source; a line carrying ``// odelint:
    disable=R003 -- <reason>`` is exempt (without a reason: R000)."""
    out: List[Violation] = []
    raw = src.splitlines()
    lines = [_strip_comments(l) for l in raw]
    ids = re.compile(r"[A-Za-z_]\w*")
    # the launches, and the definitions of the names their grids read
    # (one level: a per-block count, such as threads / lanes, may floor)
    first = set()
    for line in lines:
        for cfg in re.findall(r"<<<([^>]*)>>>", line):
            first.update(ids.findall(cfg.split(",")[0]))
    checked = {i for i, l in enumerate(lines) if "<<<" in l}
    for name in first:
        checked.update(_defining(lines, name))
    for i in sorted(checked):
        if _uncovered_divisions(lines[i]) <= 0:
            continue
        m = _CU_SUPPRESS_RE.search(raw[i])
        if m and m.group(2) and "R003" in m.group(1):
            continue
        if m and not m.group(2):
            out.append(Violation(
                "R000", path, i + 1,
                "odelint suppression without a justification — write "
                "'// odelint: disable=R003 -- <reason>'"))
        out.append(Violation(
            RULE, path, i + 1,
            "grid computed with a floor division — when the divisor "
            "does not divide n the tail is never written; use "
            "(n + b - 1) / b"))
    return out


# -- R003b/c: the launchers ------------------------------------------------

def _is_launch(node: ast.AST) -> bool:
    """``_fn(...)(...)``: a call of the ctypes entry a call returns."""
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Call)


def _reads(test: ast.AST, words) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr in words:
            return True
        if isinstance(sub, ast.Name) and sub.id in words:
            return True
    return False


_DTYPE_WORDS = {"dtype", "_DTYPE_CODE"}
_DEVICE_WORDS = {"is_cuda", "device", "get_device"}


def _facts(fdef) -> dict:
    """What one function does itself: launch, raise under a dtype or a
    device test, count a launch; and the module functions it calls."""
    facts = {"launch": False, "dtype": False, "device": False,
             "count": False, "calls": set()}
    for node in ast.walk(fdef):
        if _is_launch(node):
            facts["launch"] = True
        elif isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d:
                facts["calls"].add(d)
        if isinstance(node, ast.If) and any(
                isinstance(s, ast.Raise) for b in node.body
                for s in ast.walk(b)):
            facts["dtype"] |= _reads(node.test, _DTYPE_WORDS)
            facts["device"] |= _reads(node.test, _DEVICE_WORDS)
        if isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Subscript) and \
                dotted_name(node.target.value) == "LAUNCHES":
            facts["count"] = True
    return facts


def _check_launchers(tree, path: str) -> List[Violation]:
    out: List[Violation] = []
    defs = {f.name: f for f, chain in iter_functions(tree) if not chain}
    facts = {name: _facts(f) for name, f in defs.items()}

    def reach(name: str, seen=()) -> dict:
        got = dict(facts[name])
        for callee in got["calls"]:
            if callee in facts and callee not in seen and callee != name:
                sub = reach(callee, seen + (name,))
                for k in ("launch", "dtype", "device", "count"):
                    got[k] = got[k] or sub[k]
        return got

    for name, f in defs.items():
        if name.startswith("_"):
            continue
        r = reach(name)
        if not r["launch"]:
            continue
        for key, what in (("dtype", "a dtype check (raise on a dtype the "
                                    "kernel does not take)"),
                          ("device", "a device check (raise on a tensor "
                                     "off the card)"),
                          ("count", "a launch count (LAUNCHES[...] += 1)")):
            if not r[key]:
                out.append(Violation(
                    RULE, path, f.lineno,
                    f"launcher `{name}` launches a kernel without {what}"))
    return out


# -- R003e: the ops' reverse rules ----------------------------------------

def _counts_op_calls(fdef) -> bool:
    for node in ast.walk(fdef):
        if isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Subscript) and \
                dotted_name(node.target.value) == "OP_CALLS":
            return True
    return False


def _kernel_functions(tree) -> Set[str]:
    """The ``autograd.Function`` subclasses of the module whose backward
    calls a launcher (``*_call``)."""
    out: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {dotted_name(b) or "" for b in node.bases}
        if not any(b.endswith("autograd.Function") or b == "Function"
                   for b in bases):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name == "backward":
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Call) and (
                            dotted_name(sub.func) or "").endswith("_call"):
                        out.add(node.name)
    return out


def _applies(fdef, classes: Set[str]) -> bool:
    for sub in ast.walk(fdef):
        if isinstance(sub, ast.Call):
            d = dotted_name(sub.func) or ""
            if d.endswith(".apply") and d[:-len(".apply")] in classes:
                return True
    return False


def _check_ops(tree, path: str, ctx) -> List[Violation]:
    out: List[Violation] = []
    pkg = ctx.get("kernel_package")
    allow = ctx.get("no_reverse_rule", {})
    classes = _kernel_functions(tree)
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or \
                node.name.startswith("_") or not _counts_op_calls(node):
            continue
        if _applies(node, classes):
            continue
        key = f"{pkg}.{node.name}"
        reason = allow.get(key)
        if reason is None:
            out.append(Violation(
                RULE, path, node.lineno,
                f"kernel op `{node.name}` has no autograd.Function with a "
                f"kernel backward and is not in NO_REVERSE_RULE — register "
                f"`{key}` with a reason (repro_torch/kernels/registry.py) "
                f"or give it a reverse rule"))
        elif not isinstance(reason, str) or len(reason.strip()) < 20:
            out.append(Violation(
                RULE, path, node.lineno,
                f"NO_REVERSE_RULE entry `{key}` has a placeholder reason — "
                f"explain WHY forward-only is sound"))
    return out


def check(tree: ast.AST, src: str, path: str, ctx) -> List[Violation]:
    out: List[Violation] = []
    if ctx.get("launcher_module"):
        out.extend(_check_launchers(tree, path))
    if ctx.get("kernel_package") and path.endswith("ops.py"):
        out.extend(_check_ops(tree, path, ctx))
    return out
