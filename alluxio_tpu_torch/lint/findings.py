"""Finding/suppression/baseline plumbing shared by every analyzer.

A finding's identity (``ident``) deliberately excludes the line number:
baselines must survive unrelated edits above the finding, so the anchor
is the stable symbol the finding is about (a conf-key name, a metric
name, a ``function#callee`` pair) plus the file path.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: inline suppression:  # lint: allow[rule-a,rule-b] -- justification
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*allow\[([a-z0-9,\s-]+)\]\s*(?:--\s*(.*))?$")


@dataclass(frozen=True)
class Finding:
    rule: str       # analyzer rule id, e.g. "conf-unknown-key"
    path: str       # repo-relative path
    line: int       # 1-based line of the offending site (display only)
    anchor: str     # stable symbol for baseline identity
    message: str

    @property
    def ident(self) -> str:
        return f"{self.rule}:{self.path}:{self.anchor}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Suppression:
    rules: Tuple[str, ...]
    justification: str
    line: int

    def covers(self, rule: str) -> bool:
        return rule in self.rules or "*" in self.rules


def parse_suppressions(text: str) -> Dict[int, Suppression]:
    """Line-number -> suppression for one source file.

    A suppression on line N covers findings anchored at N or N+1, so
    both trailing-comment and line-above styles work.  A suppression
    with no justification is itself invalid — the caller turns those
    into ``lint-bad-suppression`` findings.
    """
    out: Dict[int, Suppression] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = (m.group(2) or "").strip()
        out[i] = Suppression(rules=rules, justification=just, line=i)
    return out


def suppression_for(suppressions: Dict[int, Suppression],
                    rule: str, line: int) -> Optional[Suppression]:
    for ln in (line, line - 1):
        s = suppressions.get(ln)
        if s is not None and s.covers(rule):
            return s
    return None


@dataclass
class Baseline:
    """Checked-in set of frozen findings, each with a written reason.

    Format (``alluxio_tpu_torch/lint/baseline.json``)::

        {"entries": [{"id": "<rule>:<path>:<anchor>",
                      "justification": "why this is frozen, not fixed"}]}
    """

    entries: Dict[str, str] = field(default_factory=dict)  # ident -> why
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except FileNotFoundError:
            return cls(path=path)
        entries: Dict[str, str] = {}
        bad: List[str] = []
        for e in raw.get("entries", []):
            ident = e.get("id", "")
            just = (e.get("justification") or "").strip()
            if not ident or not just:
                bad.append(ident or "<missing id>")
                continue
            entries[ident] = just
        if bad:
            raise ValueError(
                f"{path}: baseline entries without a justification are "
                f"not allowed: {bad}")
        return cls(entries=entries, path=path)

    def covers(self, finding: Finding) -> bool:
        return finding.ident in self.entries

    def stale(self, findings: List[Finding]) -> List[str]:
        """Baseline idents no current finding matches (candidates for
        pruning — the debt was paid)."""
        live = {f.ident for f in findings}
        return sorted(i for i in self.entries if i not in live)

    @staticmethod
    def write(path: str, findings: List[Finding],
              justification: str) -> None:
        entries = [{"id": f.ident, "justification": justification}
                   for f in sorted(findings, key=lambda f: f.ident)]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"entries": entries}, f, indent=1, sort_keys=True)
            f.write("\n")
