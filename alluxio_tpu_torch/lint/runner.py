"""Lint orchestration: build the model once, run every analyzer, apply
suppressions + baseline, report.

Exit codes: 0 clean, 1 new findings (or invalid suppressions), 2 budget
exceeded / bad invocation. The analysis budget is 30 s unless
``--budget-s`` says otherwise (the JAX package's ``make lint`` passes
the same 30 s on its command line).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

from alluxio_tpu_torch.lint import (
    conf_analyzer, exceptions_analyzer, locks_analyzer, metrics_analyzer,
    native_analyzer, phases_analyzer,
)
from alluxio_tpu_torch.lint.collect import RepoFacts, collect
from alluxio_tpu_torch.lint.findings import (
    Baseline, Finding, suppression_for,
)
from alluxio_tpu_torch.lint.model import (
    RepoModel, build_model, changed_paths,
)

ANALYZERS: Dict[str, Callable[[RepoModel, RepoFacts], List[Finding]]] = {
    "conf-keys": conf_analyzer.analyze,
    "metric-names": metrics_analyzer.analyze,
    "phase-names": phases_analyzer.analyze,
    "lock-discipline": locks_analyzer.analyze,
    "exceptions": exceptions_analyzer.analyze,
    "native-abi": native_analyzer.analyze,
}

DEFAULT_BASELINE = "alluxio_tpu_torch/lint/baseline.json"
DEFAULT_BUDGET_S = 30.0


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)   # everything
    new: List[Finding] = field(default_factory=list)        # fails build
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    bad_suppressions: List[Finding] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.new and not self.bad_suppressions

    def summary(self) -> str:
        by_rule: Dict[str, int] = {}
        for f in self.new:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        parts = [f"{r}={n}" for r, n in sorted(by_rule.items())]
        return (f"lint: {len(self.new)} new finding(s) "
                f"[{', '.join(parts) or 'none'}], "
                f"{len(self.suppressed)} suppressed, "
                f"{len(self.baselined)} baselined, "
                f"{len(self.stale_baseline)} stale baseline entr(ies) "
                f"in {self.elapsed_s:.1f}s")


def run_lint(root: str,
             analyzers: Optional[Sequence[str]] = None,
             only_paths: Optional[Set[str]] = None,
             extra_py: Sequence[str] = (),
             baseline_path: Optional[str] = None,
             report_only: Optional[Set[str]] = None) -> LintReport:
    """``only_paths`` restricts the SCAN (self-contained fixture runs —
    registry-level rules skip); ``report_only`` scans the whole tree so
    cross-file resolution stays correct but reports findings only in the
    given files (the ``--changed`` fast gate)."""
    t0 = time.monotonic()
    model = build_model(root, only_paths=only_paths,
                        extra_py=tuple(extra_py))
    facts = collect(model)

    report = LintReport()
    names = list(analyzers) if analyzers else list(ANALYZERS)
    for name in names:
        fn = ANALYZERS.get(name)
        if fn is None:
            raise ValueError(f"unknown analyzer '{name}'; "
                             f"have: {sorted(ANALYZERS)}")
        report.findings.extend(fn(model, facts))
    if report_only is not None:
        report.findings = [f for f in report.findings
                           if f.path in report_only]

    baseline = Baseline(path="")
    if baseline_path:
        baseline = Baseline.load(baseline_path)

    supp_by_path = {pf.path: pf.suppressions for pf in model.py_files}
    for f in report.findings:
        s = suppression_for(supp_by_path.get(f.path, {}), f.rule, f.line)
        if s is not None:
            if not s.justification:
                report.bad_suppressions.append(Finding(
                    rule="lint-bad-suppression", path=f.path, line=s.line,
                    anchor=f.anchor,
                    message=f"suppression of [{f.rule}] has no "
                            f"justification (use `# lint: allow["
                            f"{f.rule}] -- <why>`)"))
            else:
                report.suppressed.append(f)
            continue
        if baseline.covers(f):
            report.baselined.append(f)
            continue
        report.new.append(f)

    if baseline.entries and not model.is_partial and report_only is None:
        report.stale_baseline = baseline.stale(report.findings)
    report.elapsed_s = time.monotonic() - t0
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m alluxio_tpu_torch.lint",
        description="atpu-lint: conf-key / metric-name / lock / "
                    "exception discipline")
    p.add_argument("paths", nargs="*",
                   help="restrict to these repo-relative files "
                        "(per-file rules only)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detect from package)")
    p.add_argument("--changed", action="store_true",
                   help="lint only files changed vs HEAD (fast mode; "
                        "registry-level rules are skipped)")
    p.add_argument("--rule", dest="rules", action="append",
                   help="run only this analyzer (repeatable): "
                        f"{sorted(ANALYZERS)}")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report everything)")
    p.add_argument("--write-baseline", action="store_true",
                   help="freeze every current new finding into the "
                        "baseline (requires --justification)")
    p.add_argument("--justification", default="",
                   help="justification recorded with --write-baseline")
    p.add_argument("--budget-s", type=float, default=DEFAULT_BUDGET_S,
                   help="fail (exit 2) when analysis exceeds this many "
                        "seconds — keeps the gate cheap (0 = no limit)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    # Path-restricted modes always scan the FULL tree — cross-file name
    # resolution (metric emit universe, span registry) is meaningless on
    # a slice — and filter the REPORT to the requested files instead.
    report_only: Optional[Set[str]] = None
    if args.changed:
        report_only = changed_paths(root)
        if not report_only:
            print("lint: no files changed vs HEAD")
            return 0
    if args.paths:
        report_only = (report_only or set()) | set(args.paths)

    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    extra = tuple(pth for pth in (args.paths or ())
                  if not pth.startswith("alluxio_tpu_torch/"))
    try:
        report = run_lint(root, analyzers=args.rules,
                          extra_py=extra, baseline_path=baseline_path,
                          report_only=report_only)
    except ValueError as e:
        # bad invocation (unknown --rule, malformed baseline), NOT a
        # finding: exit 2 so CI never reads it as new lint debt
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if not args.justification.strip():
            print("--write-baseline requires --justification "
                  "(baselines without a written reason are rejected)",
                  file=sys.stderr)
            return 2
        Baseline.write(baseline_path or os.path.join(root, DEFAULT_BASELINE),
                       report.new, args.justification.strip())
        print(f"froze {len(report.new)} finding(s) into the baseline")
        return 0

    for f in report.bad_suppressions:
        print(f.render())
    for f in sorted(report.new, key=lambda f: (f.path, f.line)):
        print(f.render())
    if not args.quiet:
        for ident in report.stale_baseline:
            print(f"lint: stale baseline entry (no longer found): {ident}")
        print(report.summary())

    if args.budget_s and report.elapsed_s > args.budget_s:
        print(f"lint: BUDGET EXCEEDED: {report.elapsed_s:.1f}s > "
              f"{args.budget_s:.0f}s — analyzers must stay cheap enough "
              f"to gate every test run", file=sys.stderr)
        return 2
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
