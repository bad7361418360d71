"""odelint driver of the port: file discovery, rule dispatch,
suppressions.

Rule scoping (which invariant lives where, under ``src/repro_torch``):

* R001 (host reads)           -> core/, kernels/
* R003 (launcher contracts)   -> kernels/ (the launchers, the ops, and
                                 the CUDA sources ``kernels/*/csrc/*.cu``)
* R004 (registry complete)    -> repo-level (runtime introspection)
* R005 (signed buffers)       -> core/, cnf/

``lint_source`` is the in-memory entry point the fixture tests use;
``run_lint`` walks the real tree. Suppress a finding with
``# odelint: disable=RXXX -- <reason>`` on the offending line (``//`` in
a CUDA source; the reason is mandatory — see rules/common.py).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .rules import AST_RULES, r003_launchers, r004_registry
from .rules.common import (Violation, apply_suppressions,
                           parse_suppressions)

PACKAGE = "repro_torch"

# rule id -> source subtrees (relative to src/repro_torch) it applies to
RULE_SCOPE = {
    "R001": ("core", "kernels"),
    "R003": ("kernels",),
    "R005": ("core", "cnf"),
}


def _load_allowlist(repo_src: Path) -> Dict[str, str]:
    """Parse NO_REVERSE_RULE out of kernels/registry.py via AST (no
    import needed, keeps lint_source usable without the package)."""
    reg = repo_src / PACKAGE / "kernels" / "registry.py"
    if not reg.exists():
        return {}
    tree = ast.parse(reg.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NO_REVERSE_RULE"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(
                        v, (ast.Constant, ast.JoinedStr)):
                    out[k.value] = (v.value if isinstance(v, ast.Constant)
                                    else ast.unparse(v))
            return out
    return {}


def lint_source(src: str, path: str = "<snippet>",
                rules: Optional[Sequence[str]] = None,
                ctx: Optional[dict] = None) -> List[Violation]:
    """Lint one source string with the given AST rules (default: all)."""
    ctx = dict(ctx or {})
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Violation("R000", path, e.lineno or 1,
                          f"syntax error: {e.msg}")]
    table, found = parse_suppressions(src, path)
    for rid in rules if rules is not None else sorted(AST_RULES):
        found.extend(AST_RULES[rid].check(tree, src, path, ctx))
    return apply_suppressions(sorted(found, key=lambda v: (v.path, v.line)),
                              table)


def _applicable_rules(rel: Path) -> List[str]:
    top = rel.parts[0] if rel.parts else ""
    return [rid for rid, scopes in RULE_SCOPE.items() if top in scopes]


def run_lint(repo_root, rules: Optional[Sequence[str]] = None,
             include_registry_checks: bool = True) -> List[Violation]:
    """Lint the port. ``repo_root`` is the directory holding src/ and
    tests/."""
    repo_root = Path(repo_root)
    src_root = repo_root / "src"
    pkg_root = src_root / PACKAGE
    allowlist = _load_allowlist(src_root)

    out: List[Violation] = []
    for py in sorted(pkg_root.rglob("*.py")):
        rel = py.relative_to(pkg_root)
        applicable = _applicable_rules(rel)
        if rules is not None:
            applicable = [r for r in applicable if r in rules]
        if not applicable:
            continue
        ctx = {"no_reverse_rule": allowlist}
        if rel.parts[0] == "kernels" and len(rel.parts) == 3:
            if py.name == "ops.py":
                ctx["kernel_package"] = rel.parts[1]
            elif py.stem == rel.parts[1]:
                ctx["launcher_module"] = True
        out.extend(lint_source(py.read_text(), str(py.relative_to(repo_root)),
                               applicable, ctx))

    if rules is None or "R003" in rules:
        for cu in sorted((pkg_root / "kernels").glob("*/csrc/*.cu")):
            out.extend(r003_launchers.check_cuda_source(
                cu.read_text(), str(cu.relative_to(repo_root))))

    if include_registry_checks and (rules is None or "R004" in rules):
        out.extend(r004_registry.check_registries(repo_root / "tests"))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
