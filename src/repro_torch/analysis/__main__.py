"""`python -m repro_torch.analysis` — the port's lint + op-audit gate.

    python -m repro_torch.analysis --device cpu   # report only, exit 0
    python -m repro_torch.analysis --strict       # exit 1 on an unwaived
                                                  #  violation, an
                                                  #  unjustified or unknown
                                                  #  waiver, or a failed
                                                  #  audit section
    python -m repro_torch.analysis --skip-audit   # lint only (fast)
    python -m repro_torch.analysis --json out.json

The audit runs on the card unless `--device cpu` asks for the CPU, where
its `kernels` section reports itself skipped. The report goes to
`build/analysis/report.json` under the repository root by default
(`build/` is not committed); the reference's `BENCH_analysis.json` is
never written.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.lint import SRC_ROOT, lint_paths

DEFAULT_JSON = SRC_ROOT.parent / "build" / "analysis" / "report.json"
REFERENCE_REPORT = "BENCH_analysis.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-analysis",
        description="the port's analysis gate (AST lint + op-level audit)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on unwaived violations, "
                         "unjustified or unknown waivers, or a failed "
                         "audit section")
    ap.add_argument("--skip-audit", action="store_true",
                    help="run only the AST lint (no op audit)")
    ap.add_argument("--device", default=None,
                    help="the audit's device (default: the CUDA device)")
    ap.add_argument("--json", default=str(DEFAULT_JSON),
                    help="report path (default: %(default)s)")
    ap.add_argument("--src", default=None,
                    help="the src/ directory holding repro_torch "
                         "(default: this checkout's)")
    args = ap.parse_args(argv)
    out = Path(args.json)
    if out.name == REFERENCE_REPORT:
        ap.error(f"{REFERENCE_REPORT} is the reference's report; pass "
                 f"another --json path")

    lint = lint_paths(Path(args.src) if args.src else None,
                      AnalysisConfig())
    report = {"lint": lint.to_json()}
    print(f"lint: {lint.files_checked} files, "
          f"{len(lint.unwaived)} unwaived violation(s), "
          f"{len(lint.waived)} audited waiver(s)")
    for v in lint.unwaived:
        print(f"  {v.path}:{v.line}:{v.col} [{v.rule}] {v.message}")
    for v in lint.unjustified():
        print(f"  {v.path}:{v.line} [{v.rule}] waiver has NO justification")
    for u in lint.unknown_waivers:
        print(f"  {u['path']}:{u['line']} waiver names unknown rule "
              f"{u['rule']!r}")

    audit_ok = True
    if not args.skip_audit:
        from repro_torch.analysis import op_audit
        audit = op_audit.audit_all(device=args.device)
        report["audit"] = audit
        audit_ok = bool(audit["ok"])
        for section in op_audit.SECTIONS:
            print(f"audit: {section:12s} "
                  f"{op_audit.section_status(audit[section])}")

    strict_ok = lint.strict_ok() and not lint.unknown_waivers and audit_ok
    report["strict_ok"] = strict_ok
    from repro_torch.obs.metrics import run_metadata
    report["_meta"] = run_metadata()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str) + "\n")
    print(f"report -> {out}  (strict {'PASS' if strict_ok else 'FAIL'})")
    return 0 if (strict_ok or not args.strict) else 1


if __name__ == "__main__":
    sys.exit(main())
