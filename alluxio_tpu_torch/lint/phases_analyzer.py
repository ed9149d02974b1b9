"""Analyzer 5: read-path phase-name discipline.

The typed phase events inside spans (``Span.phase(name, ms)``) feed the
critical-path analyzer, which groups and ranks by name string — an
emit-site typo doesn't crash anything, it silently mints a parallel
phase that never aggregates with its siblings and never shows up where
the operator greps for it. The ``PHASES`` tuple in ``utils/tracing.py``
is the registry; every emit site must use a member of it.

Rules:

- ``phase-typo``          emitted name misses the catalog by edit
                          distance <= 2 of a cataloged phase
- ``phase-unknown``       emitted name with no cataloged counterpart
- ``phase-unused``        cataloged phase no emit site uses (dead
                          vocabulary misleads whoever reads the tuple)

The JAX package's ``phase-undocumented`` rule is left out: the port's
lint reads no docs.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from alluxio_tpu_torch.lint.collect import RepoFacts
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.metrics_analyzer import _edit_distance
from alluxio_tpu_torch.lint.model import RepoModel

RULES = ("phase-typo", "phase-unknown", "phase-unused")


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    findings: List[Finding] = []
    catalog = facts.phase_catalog
    if not catalog:
        # partial scan without utils/tracing.py: no registry to check
        # against — emits cannot be classified, so stay silent
        return findings

    # 1) every emit site names a cataloged phase
    flagged: Set[Tuple[str, str]] = set()
    for site in facts.phase_emits:
        if site.pattern or site.value in catalog:
            continue
        key = (site.path, site.value)
        if key in flagged:
            continue
        flagged.add(key)
        best = None
        for known in catalog:
            d = _edit_distance(site.value, known)
            if d > 0 and (best is None or d < best[1]):
                best = (known, d)
        if best is not None and best[1] <= 2:
            findings.append(Finding(
                rule="phase-typo", path=site.path, line=site.line,
                anchor=site.value,
                message=f"phase '{site.value}' is not in "
                        f"tracing.PHASES — did you mean '{best[0]}'? "
                        f"(edit distance {best[1]}); a misspelled "
                        f"phase silently never aggregates"))
        else:
            findings.append(Finding(
                rule="phase-unknown", path=site.path, line=site.line,
                anchor=site.value,
                message=f"phase '{site.value}' is not in "
                        f"tracing.PHASES — add it to the catalog or "
                        f"use an existing phase"))

    # registry-level checks need the whole emit universe
    if model.is_partial:
        return findings

    emitted = facts.phase_names()
    for name, (path, line) in sorted(catalog.items()):
        if name not in emitted:
            findings.append(Finding(
                rule="phase-unused", path=path, line=line, anchor=name,
                message=f"cataloged phase '{name}' has no emit site — "
                        f"drop it from PHASES or wire the emit"))

    return findings
