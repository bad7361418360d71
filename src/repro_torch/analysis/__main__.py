"""Entry point: ``PYTHONPATH=src python -m repro_torch.analysis``.

Runs odelint (R001, R003–R005) and the trace audit, prints a summary,
optionally writes ``analysis_report.json``, and exits non-zero on any
violation or audit failure. The audit runs on the CPU unless given
``--device`` (``--device cuda`` runs it on the card).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .lint import run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--repo", default=".",
                    help="repo root (directory holding src/ and tests/)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset, e.g. R001,R003")
    ap.add_argument("--skip-audit", action="store_true",
                    help="lint only (skip the trace audit)")
    ap.add_argument("--device", default=None,
                    help="the audit's device (default: the CUDA card; "
                         "'cpu' without one)")
    args = ap.parse_args(argv)

    repo = Path(args.repo)
    rules = args.rules.split(",") if args.rules else None

    violations = run_lint(repo, rules=rules)
    for v in violations:
        print(v)
    print(f"odelint: {len(violations)} violation(s)")

    audit = None
    if not args.skip_audit:
        from .trace_audit import run_trace_audit
        audit = run_trace_audit(args.device)
        for msg in audit["shape_failures"] + audit["retrace_failures"]:
            print("trace-audit:", msg)
        print(f"trace audit: {audit['combos']} matrix combos, "
              f"{len(audit['shape_failures'])} shape failure(s), "
              f"value-hash cases {audit['retrace_counts']} "
              f"({audit['elapsed_s']}s)")

    ok = not violations and (audit is None or audit["ok"])
    if args.json:
        report = {
            "ok": ok,
            "lint": {
                "count": len(violations),
                "violations": [v.as_dict() for v in violations],
            },
            "trace_audit": audit,
        }
        Path(args.json).write_text(json.dumps(report, indent=2) + "\n")
        print(f"report written to {args.json}")
    print("analysis:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
