"""Analyzer 2: metric/span-name discipline.

Emitters (``.counter/.meter/.timer/.register_gauge`` call sites) define
the registry; consumers (health rules, remediation, benches, fsadmin,
snapshot keys) must hit it — modulo the derived forms the metrics
system itself mints:

- timer/meter snapshot suffixes (``.p50/.p95/.p99/.mean/.count/.rate1m``)
  plus history-rollup fields (``.min/.max/.last/.sum``)
- ``Cluster.X`` aggregates derived from per-instance ``Worker./Client./
  Master.X`` reports (metrics/history.py synthesizes these)

Rules:

- ``metric-typo``          consumed name misses the registry by edit
                           distance <= 2 of a registered name — the
                           "permanently blind health rule" bug class
- ``metric-unknown``       consumed name with no registered counterpart
- ``metric-invalid-name``  emitted name that violates the
                           ``Instance.CamelCase`` convention or would
                           collide after Prometheus sanitization

Span names (``atpu.*`` strings) share a namespace with conf keys, so
span resolution rides the conf analyzer. The JAX package's doc rules
(``metric-undocumented`` and doc-side consumers) and its doc writer are
left out: the port's lint reads no docs.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from alluxio_tpu_torch.lint.collect import (
    METRIC_INSTANCES, RepoFacts, StrSite,
)
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.model import RepoModel

RULES = ("metric-typo", "metric-unknown", "metric-invalid-name")

#: suffixes the registry derives from timers/meters/history rollups
_DERIVED_SUFFIXES = (".p50", ".p95", ".p99", ".mean", ".count", ".rate1m",
                     ".min", ".max", ".last", ".sum")
#: Cluster.X aggregates are synthesized from these instance reports
_CLUSTER_SOURCES = ("Worker.", "Client.", "Master.", "JobMaster.",
                    "JobWorker.")

_VALID_EMIT_RE = re.compile(
    r"^(?:%s)(?:\.[A-Za-z0-9_]+|\.\*)+$" % "|".join(METRIC_INSTANCES))


def _norm_glob(name: str) -> str:
    """Canonical glob: f-string parts and <placeholders> become '*'."""
    s = re.sub(r"<[^>]*>", "*", name)
    s = re.sub(r"\{[^}]*\}", "*", s)
    s = re.sub(r"\*+", "*", s)
    return s


def _prefix(glob: str) -> str:
    return glob.split("*")[0]


def _globs_compatible(consumed: str, emitted: str) -> bool:
    """Loose intersection test on glob pairs: compare the literal
    prefixes before the first wildcard.  Dynamic tails never false-
    positive; a typo in the literal prefix still flags."""
    if "*" not in consumed and "*" not in emitted:
        return consumed == emitted
    pc, pe = _prefix(consumed), _prefix(emitted)
    return pc.startswith(pe) or pe.startswith(pc)


def _edit_distance(a: str, b: str, cap: int = 3) -> int:
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
            best = min(best, cur[-1])
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]


class MetricRegistry:
    """Resolution over the emitted-name universe."""

    def __init__(self, emits: Sequence[StrSite]) -> None:
        self.exact: Set[str] = {s.value for s in emits if not s.pattern}
        self.globs: Set[str] = {_norm_glob(s.value) for s in emits}

    def _direct(self, glob: str) -> bool:
        if glob in self.exact:
            return True
        return any(_globs_compatible(glob, e) for e in self.globs)

    def _candidates(self, name: str) -> Iterable[str]:
        glob = _norm_glob(name)
        yield glob
        for suf in _DERIVED_SUFFIXES:
            if glob.endswith(suf):
                yield glob[: -len(suf)]
        if glob.startswith("Cluster."):
            rest = glob[len("Cluster."):]
            stems = [rest] + [rest[: -len(suf)]
                              for suf in _DERIVED_SUFFIXES
                              if rest.endswith(suf)]
            for src in _CLUSTER_SOURCES:
                for stem in stems:
                    yield src + stem

    def resolves(self, name: str) -> bool:
        return any(self._direct(c) for c in self._candidates(name))

    def nearest(self, name: str) -> Optional[Tuple[str, int]]:
        glob = _norm_glob(name)
        best: Optional[Tuple[str, int]] = None
        universe = set(self.exact) | {_prefix(g).rstrip(".")
                                      for g in self.globs if "*" in g}
        for cand in self._candidates(name):
            base = _prefix(cand).rstrip(".") if "*" in cand else cand
            for known in universe:
                d = _edit_distance(base, known)
                if d > 0 and (best is None or d < best[1]):
                    best = (known, d)
        del glob
        return best


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    del model
    findings: List[Finding] = []
    registry = MetricRegistry(facts.metric_emits)

    # 1) emitted names follow the exposition-safe convention
    seen_invalid: Set[str] = set()
    for site in facts.metric_emits:
        probe = _norm_glob(site.value)
        if not _VALID_EMIT_RE.match(probe.replace("*", "x")) or \
                "__" in probe or probe.endswith("."):
            if site.value not in seen_invalid:
                seen_invalid.add(site.value)
                findings.append(Finding(
                    rule="metric-invalid-name", path=site.path,
                    line=site.line, anchor=site.value,
                    message=f"emitted metric name '{site.value}' violates "
                            f"the Instance.Name convention (letters, "
                            f"digits, '_' per dotted segment)"))

    # 2) consumed names resolve; near-misses are called out as typos
    flagged: Set[Tuple[str, str]] = set()
    for site in facts.metric_consumes:
        if site.value in facts.heartbeat_names:
            continue  # heartbeat thread names are their own registry
        if registry.resolves(site.value):
            continue
        key = (site.path, site.value)
        if key in flagged:
            continue
        flagged.add(key)
        near = registry.nearest(site.value)
        if near is not None and near[1] <= 2:
            findings.append(Finding(
                rule="metric-typo", path=site.path, line=site.line,
                anchor=site.value,
                message=f"'{site.value}' is emitted nowhere — did you "
                        f"mean '{near[0]}'? (edit distance {near[1]})"))
        else:
            findings.append(Finding(
                rule="metric-unknown", path=site.path, line=site.line,
                anchor=site.value,
                message=f"'{site.value}' matches no emitted metric name "
                        f"or family"))
    return findings
