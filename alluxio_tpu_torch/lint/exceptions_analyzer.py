"""Analyzer 4: exception discipline.

Two checks:

- ``except-swallow``: an ``except Exception`` (or bare ``except:``)
  handler on a server dispatch / heartbeat / control-loop path whose
  body neither logs nor re-raises.  A swallowed exception on those paths
  is how a worker keeps "heartbeating" while dead, or an RPC fails with
  no trace.  Counting a metric is not enough — nobody can debug a
  counter.  Suppress with
  ``# lint: allow[except-swallow] -- <why silence is correct>``.

- ``wire-error-unregistered``: a class derived from ``AlluxioTpuError``
  defined outside ``utils/exceptions.py`` without a
  ``register_wire_error(...)`` call in its module.  ``from_wire`` resolves
  types by name from the map built in that module; an unregistered
  subclass silently degrades to its base class across the wire, so a
  client ``except SpecificError`` stops matching.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from alluxio_tpu_torch.lint.collect import RepoFacts
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.model import PyFile, RepoModel, function_index

RULES = ("except-swallow", "wire-error-unregistered")

_EXCEPTIONS_PATH = "alluxio_tpu_torch/utils/exceptions.py"

#: paths where a silent except Exception is a correctness bug, not taste
SCOPE_PREFIXES = ("alluxio_tpu_torch/rpc/", "alluxio_tpu_torch/master/",
                  "alluxio_tpu_torch/worker/",
                  "alluxio_tpu_torch/heartbeat/", "alluxio_tpu_torch/qos/")

_LOGGERISH_RECEIVERS = {"LOG", "log", "logger", "logging", "_log",
                        "warnings", "traceback", "faulthandler"}
_LOGGERISH_METHODS = {"debug", "info", "warning", "warn", "error",
                      "exception", "critical", "log"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names: List[str] = []
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in nodes:
        if isinstance(n, ast.Name):
            names.append(n.id)
        elif isinstance(n, ast.Attribute):
            names.append(n.attr)
    return any(n in ("Exception", "BaseException") for n in names)


def _surfaces(handler: ast.ExceptHandler) -> bool:
    """Does the handler body log, re-raise, or otherwise surface?

    "Surface" also covers handing the bound exception to another
    function (``self._fail(e)`` — the error is routed, not dropped) and
    calling anything named like a logger (``_warn_rate_limited``)."""
    bound = handler.name  # `except Exception as e:` -> "e"
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if bound and any(
                    isinstance(a, ast.Name) and a.id == bound
                    for a in list(node.args) +
                    [kw.value for kw in node.keywords]):
                return True  # exception object passed onward
            if isinstance(fn, ast.Attribute):
                recv = fn.value
                recv_name = recv.id if isinstance(recv, ast.Name) else \
                    (recv.attr if isinstance(recv, ast.Attribute) else "")
                attr_l = fn.attr.lower()
                if recv_name in _LOGGERISH_RECEIVERS or \
                        fn.attr in _LOGGERISH_METHODS or \
                        "warn" in attr_l or "log" in attr_l:
                    return True
                if fn.attr == "abort" and recv_name == "context":
                    return True  # grpc context.abort raises
            elif isinstance(fn, ast.Name):
                if fn.id in ("print",):  # CLI surfacing
                    return True
    return False


def _swallow_findings(pf: PyFile) -> List[Finding]:
    findings: List[Finding] = []
    for qualname, func in function_index(pf.tree):
        ordinal = 0
        for node in ast.walk(func):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                ordinal += 1
                if _surfaces(handler):
                    continue
                findings.append(Finding(
                    rule="except-swallow", path=pf.path,
                    line=handler.lineno,
                    anchor=f"{qualname}#{ordinal}",
                    message=f"broad except in {qualname} neither logs "
                            f"nor re-raises — a failure here vanishes"))
    return findings


def _wire_findings(model: RepoModel) -> List[Finding]:
    # seed the family with every class defined in the canonical module
    family: Set[str] = set()
    for pf in model.py(_EXCEPTIONS_PATH):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                family.add(node.name)
    if not family:
        return []  # partial scan without the canonical module

    # transitively find subclasses elsewhere (two passes handle one level
    # of indirection per pass; repeat until stable)
    classes: List[Tuple[PyFile, ast.ClassDef]] = []
    registered: Dict[str, Set[str]] = {}  # path -> names registered there
    for pf in model.py_files:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                classes.append((pf, node))
                for dec in node.decorator_list:
                    name = dec.id if isinstance(dec, ast.Name) else \
                        getattr(dec, "attr", "")
                    if name == "register_wire_error":
                        registered.setdefault(pf.path, set()).add(node.name)
            elif isinstance(node, ast.Call):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else \
                    getattr(fn, "attr", "")
                if name == "register_wire_error":
                    for a in node.args:
                        if isinstance(a, ast.Name):
                            registered.setdefault(pf.path, set()).add(a.id)

    changed = True
    members: List[Tuple[PyFile, ast.ClassDef]] = []
    while changed:
        changed = False
        for pf, node in classes:
            if node.name in family:
                continue
            bases = [b.id if isinstance(b, ast.Name) else
                     getattr(b, "attr", "") for b in node.bases]
            if any(b in family for b in bases):
                family.add(node.name)
                members.append((pf, node))
                changed = True

    findings: List[Finding] = []
    for pf, node in members:
        if pf.path == _EXCEPTIONS_PATH:
            continue
        if node.name in registered.get(pf.path, set()):
            continue
        findings.append(Finding(
            rule="wire-error-unregistered", path=pf.path, line=node.lineno,
            anchor=node.name,
            message=f"{node.name} subclasses AlluxioTpuError outside "
                    f"utils/exceptions.py and is never passed to "
                    f"register_wire_error(); from_wire() will degrade it "
                    f"to its base class"))
    return findings


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    del facts
    findings: List[Finding] = []
    for pf in model.py_files:
        # files outside the package were passed explicitly (fixtures,
        # ad-hoc runs) — scope filtering only applies to the repo walk
        if pf.path.startswith(SCOPE_PREFIXES) or \
                not pf.path.startswith("alluxio_tpu_torch/"):
            findings.extend(_swallow_findings(pf))
    findings.extend(_wire_findings(model))
    return findings
