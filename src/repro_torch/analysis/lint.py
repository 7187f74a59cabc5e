"""Lint engine (`repro/analysis/lint.py`): run every registered rule over
a file set, apply per-line waivers, and produce a `LintReport`.

Waiver syntax (audited, not silencing): a violation is *waived* — kept
in the report, excluded from the strict gate — when the offending line,
or the line directly above it, carries

    # analysis: allow[<rule-name>] -- justification

The justification is mandatory under `--strict`. The reference's lint
reads `src/repro_torch` too and counts a waiver naming a rule it does not
know as an unknown waiver, so a waiver in the port names only a rule both
lints have; a rule only the port has is kept free of hits instead.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.rules import RULES, RuleContext, Violation

_WAIVER_RE = re.compile(
    r"#\s*analysis:\s*allow\[([a-z0-9-]+)\]\s*(?:--\s*)?(.*?)\s*$")

# src/repro_torch/analysis/lint.py -> src/
SRC_ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "repro_torch"


def parse_waivers(source: str) -> Dict[Tuple[int, str], str]:
    """Map (covered_line, rule) -> justification. A waiver comment
    covers its own line; a comment-only line also covers the next."""
    waivers: Dict[Tuple[int, str], str] = {}
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _WAIVER_RE.search(line)
        if not m:
            continue
        rule_name, why = m.group(1), m.group(2).strip()
        waivers[(i, rule_name)] = why
        if line.lstrip().startswith("#"):       # standalone comment line
            waivers[(i + 1, rule_name)] = why
    return waivers


@dataclass
class LintReport:
    violations: List[Violation] = field(default_factory=list)
    files_checked: int = 0
    unknown_waivers: List[dict] = field(default_factory=list)

    @property
    def unwaived(self) -> List[Violation]:
        return [v for v in self.violations if not v.waived]

    @property
    def waived(self) -> List[Violation]:
        return [v for v in self.violations if v.waived]

    def unjustified(self) -> List[Violation]:
        return [v for v in self.waived if not (v.justification or "").strip()]

    def strict_ok(self) -> bool:
        """The gate: zero unwaived violations AND every waiver carries a
        non-empty justification."""
        return not self.unwaived and not self.unjustified()

    def to_json(self) -> dict:
        by_rule: Dict[str, dict] = {
            name: {"violations": [], "waivers": []} for name in RULES}
        for v in self.violations:
            key = "waivers" if v.waived else "violations"
            by_rule.setdefault(
                v.rule, {"violations": [], "waivers": []})[key].append(
                v.to_json())
        return {
            "files_checked": self.files_checked,
            "strict_ok": self.strict_ok(),
            "n_violations": len(self.unwaived),
            "n_waived": len(self.waived),
            "rules": by_rule,
            "unknown_waivers": self.unknown_waivers,
        }


def lint_source(source: str, relpath: str,
                config: Optional[AnalysisConfig] = None,
                rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint one module given as text (the unit tests' entry point).
    `relpath` is the path relative to src/ (posix separators), e.g.
    "repro_torch/pipeline/builder.py", and is what scoping keys on."""
    config = config or AnalysisConfig()
    tree = ast.parse(source, filename=relpath)
    ctx = RuleContext.build(relpath, tree, config)
    waivers = parse_waivers(source)
    out: List[Violation] = []
    for name, fn in RULES.items():
        if rules is not None and name not in rules:
            continue
        for v in fn(tree, ctx) or ():
            why = waivers.get((v.line, v.rule))
            if why is not None:
                v.waived = True
                v.justification = why
            out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def iter_py_files(root: Path) -> Iterable[Path]:
    yield from sorted(root.rglob("*.py"))


def lint_paths(src_root: Optional[Path] = None,
               config: Optional[AnalysisConfig] = None,
               package: str = PACKAGE) -> LintReport:
    """Lint every .py of `src_root/package` (by default the port under
    this checkout's src/), with paths relative to `src_root`."""
    src_root = Path(src_root) if src_root is not None else SRC_ROOT
    config = config or AnalysisConfig()
    report = LintReport()
    known = set(RULES)
    for path in iter_py_files(src_root / package):
        relpath = path.relative_to(src_root).as_posix()
        source = path.read_text()
        report.files_checked += 1
        report.violations.extend(lint_source(source, relpath, config))
        for (line, rule_name), _ in parse_waivers(source).items():
            if rule_name not in known:
                report.unknown_waivers.append(
                    {"path": relpath, "line": line, "rule": rule_name})
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return report
