"""Shared odelint machinery: violations, suppressions, and the local
taint analysis every value-sensitive rule builds on.

The port's copy of the JAX package's ``repro.analysis.rules.common``
(which it does not import), with the taint model restated for torch. A
value is a *device value* ("tainted") when it is made by a ``torch.`` /
``F.`` call inside the current function (other than the metadata and
dtype helpers of :data:`LAUNDER_CALLS`), or
derived from one; function parameters are assumed untainted, as in the
JAX package (a parameter-level branch is visible in the signature).
Laundering escapes taint:

* ``isinstance``/``len``/``type``/... calls, and ``int``/``float``/
  ``bool`` (their *result* is a host value: R001 flags the call itself
  when its argument is a device value),
* anything rooted at ``np.``/``numpy.``/``math.``,
* the return code of a kernel's C entry point, called through the
  ctypes function a call returns (``_fn()(...)``),
* tensor *metadata* (``.shape``, ``.ndim``, ``.dtype``, ``.device``,
  ``.numel()``, ``.dim()``, ``.size()``, ...): host values, no sync;
  and the results of ``.item()`` / ``.tolist()`` (host reads: R001 flags
  the read itself).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Set


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# --------------------------------------------------------------------------
# Suppressions: "# odelint: disable=R001 -- <why>". The justification text
# after " -- " is mandatory; a bare disable does NOT suppress and is itself
# reported (R000) so the escape hatch stays auditable.
# --------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*odelint:\s*disable=([A-Z0-9, ]+?)\s*(?:--\s*(\S.*))?$")


def parse_suppressions(src: str, path: str):
    """-> ({lineno: {rule ids}}, [R000 violations for reason-less disables])."""
    table: Dict[int, Set[str]] = {}
    bad: List[Violation] = []
    for i, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not m.group(2):
            bad.append(Violation(
                "R000", path, i,
                "odelint suppression without a justification — write "
                "'# odelint: disable=RXXX -- <reason>'"))
            continue
        table.setdefault(i, set()).update(rules)
    return table, bad


def apply_suppressions(violations: Iterable[Violation],
                       table: Dict[int, Set[str]]) -> List[Violation]:
    out = []
    for v in violations:
        suppressed = table.get(v.line, set())
        if v.rule in suppressed or "ALL" in suppressed:
            continue
        out.append(v)
    return out


# --------------------------------------------------------------------------
# Name helpers
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.linalg.norm' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def target_names(target: ast.AST) -> List[str]:
    """All plain names bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for elt in target.elts:
            out.extend(target_names(elt))
        return out
    if isinstance(target, ast.Starred):
        return target_names(target.value)
    return []


# --------------------------------------------------------------------------
# Taint analysis
# --------------------------------------------------------------------------

TAINT_CALL_PREFIXES = ("torch.", "F.", "torch.nn.functional.")
LAUNDER_PREFIXES = ("np.", "numpy.", "math.", "os.", "dataclasses.",
                    "torch.cuda.", "torch._C.", "torch.backends.")
LAUNDER_CALLS = {
    "int", "float", "bool", "str", "len", "isinstance", "issubclass",
    "type", "repr", "hash", "id", "callable", "getattr", "hasattr",
    # torch helpers that return host values (dtypes, devices, flags)
    "torch.is_tensor", "torch.is_grad_enabled", "torch.promote_types",
    "torch.result_type", "torch.device", "torch.dtype", "torch.Size",
    "torch.finfo", "torch.iinfo", "torch.get_default_dtype",
    "torch.is_floating_point", "torch.is_complex",
    "torch.are_deterministic_algorithms_enabled",
}
METADATA_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "is_cuda", "is_meta",
    "requires_grad", "itemsize", "nbytes", "layout", "grad_fn",
    "numel", "dim", "element_size", "data_ptr", "is_contiguous",
    "stride", "storage_offset", "get_device", "is_floating_point",
}
# host reads: their results are host values (R001 flags the reads)
HOST_READS = {"item", "tolist"}


def expr_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """Is this expression a device value (a tensor's data)?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in METADATA_ATTRS:
            return False                      # static metadata read
        return expr_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        d = dotted_name(node.func)
        if d is not None:
            if d in LAUNDER_CALLS or d.startswith(LAUNDER_PREFIXES):
                return False
            if d.startswith(TAINT_CALL_PREFIXES):
                return True
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in METADATA_ATTRS
                or node.func.attr in HOST_READS):
            return False                      # t.numel(), t.item(): host
        if isinstance(node.func, ast.Call):
            return False      # f(...)(...): a ctypes entry's return code
        if isinstance(node.func, ast.Attribute):
            # method call: x.float(...) is a device value iff x is
            if expr_tainted(node.func.value, tainted):
                return True
        return any(expr_tainted(a, tainted) for a in node.args) or any(
            expr_tainted(kw.value, tainted) for kw in node.keywords)
    if isinstance(node, ast.Lambda):
        return False
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False                          # `x is None`: structural, static
    if isinstance(node, (ast.Constant, ast.FunctionDef,
                         ast.AsyncFunctionDef)):
        return False
    return any(expr_tainted(c, tainted) for c in ast.iter_child_nodes(node))


def _collect_bindings(stmts, tainted: Set[str]) -> None:
    """One forward pass propagating taint through assignments/for-targets
    of a statement list (descends into control flow, not nested defs)."""
    for node in stmts:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Assign):
            if expr_tainted(node.value, tainted):
                for t in node.targets:
                    tainted.update(target_names(t))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if expr_tainted(node.value, tainted):
                tainted.update(target_names(node.target))
        elif isinstance(node, ast.AugAssign):
            if expr_tainted(node.value, tainted):
                tainted.update(target_names(node.target))
        elif isinstance(node, ast.For):
            if expr_tainted(node.iter, tainted):
                tainted.update(target_names(node.target))
        # walrus targets inside any expression of this statement
        for sub in ast.walk(node):
            if isinstance(sub, ast.NamedExpr):
                if expr_tainted(sub.value, tainted):
                    tainted.update(target_names(sub.target))
        for field in ("body", "orelse", "finalbody"):
            _collect_bindings(getattr(node, field, []) or [], tainted)
        for handler in getattr(node, "handlers", []) or []:
            _collect_bindings(handler.body, tainted)


def function_taint(fdef, inherited: Optional[Set[str]] = None) -> Set[str]:
    """Tainted local names of one function. Two passes so loop-carried
    taint (``x`` tainted late, used early in the loop) converges."""
    tainted: Set[str] = set(inherited or ())
    for _ in range(2):
        _collect_bindings(fdef.body, tainted)
    return tainted


def iter_functions(tree: ast.AST):
    """Yield (fdef, enclosing_chain) for every def, outermost first."""
    def visit(node, chain):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, chain
                yield from visit(child, chain + (child,))
            else:
                yield from visit(child, chain)
    yield from visit(tree, ())


def own_nodes(fdef):
    """Walk a function body WITHOUT descending into nested defs/lambdas."""
    stack = list(fdef.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
