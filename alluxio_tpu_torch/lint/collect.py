"""Shared fact collection: one AST walk per file feeding every analyzer.

The walk classifies the string literals the registries care about:

- metric EMITS      first arg of ``.counter/.meter/.timer/.register_gauge``
- span EMITS        first arg of ``.span(`` / ``annotate(`` / ``Span(``
- phase EMITS       first arg of ``.phase(`` (typed phase events inside
                    spans; the catalog is the ``PHASES`` tuple in
                    utils/tracing.py)
- metric CONSUMES   any other full-string instance-prefixed literal
                    (health rules, benches, fsadmin, snapshot keys)
- conf literals     any other full-string ``atpu.*`` literal
- ``Keys.X`` attribute reads (conf-key usage through the typed catalog)

f-strings become glob patterns (each interpolated part -> ``*``) so
dynamic families like ``Worker.BytesServed.{tier}`` stay checkable.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from alluxio_tpu_torch.lint.model import PyFile, RepoModel

METRIC_INSTANCES = ("Master", "Worker", "Client", "Cluster",
                    "JobMaster", "JobWorker", "Process")
#: a full-string literal is metric-ish when it looks like Instance.Name...
METRIC_RE = re.compile(
    r"^(?:%s)(?:\.[A-Za-z0-9_{}*<>-]+)+$" % "|".join(METRIC_INSTANCES))
#: a full-string literal is conf-key-ish when it is atpu.<lowercase...>
#: (service names like atpu.FileSystemMaster are CamelCase -> excluded)
CONF_RE = re.compile(r"^atpu\.[a-z][a-z0-9_.{}*<>-]*$")

_METRIC_EMIT_METHODS = {"counter", "meter", "timer", "register_gauge"}
_SPAN_EMIT_CALLEES = {"span", "annotate", "Span", "start_span"}
_PHASE_EMIT_CALLEES = {"phase"}

#: the typed-phase catalog lives here as ``PHASES = (...)``
_PHASE_CATALOG_PATH = "alluxio_tpu_torch/utils/tracing.py"


@dataclass(frozen=True)
class StrSite:
    value: str    # literal value; '*' marks interpolated f-string parts
    path: str
    line: int
    pattern: bool  # True when value came from an f-string / has globs


#: heartbeat thread names (``Master.TtlCheck``…) look metric-ish but are
#: their own registry; this module defines it
_HEARTBEAT_CATALOG_PATH = "alluxio_tpu_torch/heartbeat/core.py"


@dataclass
class RepoFacts:
    metric_emits: List[StrSite] = field(default_factory=list)
    metric_consumes: List[StrSite] = field(default_factory=list)
    span_emits: List[StrSite] = field(default_factory=list)
    phase_emits: List[StrSite] = field(default_factory=list)
    #: phase name -> (path, line) of its PHASES-tuple catalog entry
    phase_catalog: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    conf_literals: List[StrSite] = field(default_factory=list)
    #: Keys.<ATTR> reads per file (attribute name, path, line)
    keys_attr_reads: List[Tuple[str, str, int]] = field(default_factory=list)
    #: heartbeat thread names from the HeartbeatContext catalog
    heartbeat_names: Set[str] = field(default_factory=set)

    def metric_emit_names(self) -> Set[str]:
        return {s.value for s in self.metric_emits if not s.pattern}

    def metric_emit_globs(self) -> Set[str]:
        return {s.value for s in self.metric_emits}

    def span_names(self) -> Set[str]:
        return {s.value for s in self.span_emits}

    def phase_names(self) -> Set[str]:
        return {s.value for s in self.phase_emits if not s.pattern}


def _joinedstr_glob(node: ast.JoinedStr) -> Optional[str]:
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    glob = "".join(parts)
    return glob if glob.strip("*") else None


def _first_arg_string(call: ast.Call) -> Optional[Tuple[str, bool, int]]:
    """(value, is_pattern, lineno) for a literal/f-string first argument."""
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False, a.lineno
    if isinstance(a, ast.JoinedStr):
        glob = _joinedstr_glob(a)
        if glob is not None:
            return glob, True, a.lineno
    return None


def _callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def collect_file(pf: PyFile, facts: RepoFacts) -> None:
    doc_lines = pf.docstring_lines()
    emit_nodes: Set[int] = set()  # id() of first-arg nodes already classified

    if pf.path == _PHASE_CATALOG_PATH:
        # the PHASES tuple IS the phase registry
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Assign) and \
                    any(isinstance(t, ast.Name) and t.id == "PHASES"
                        for t in node.targets) and \
                    isinstance(node.value, ast.Tuple):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and \
                            isinstance(elt.value, str):
                        facts.phase_catalog[elt.value] = \
                            (pf.path, elt.lineno)
                        emit_nodes.add(id(elt))

    if pf.path == _HEARTBEAT_CATALOG_PATH:
        # class-level string constants there ARE the heartbeat registry
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) and \
                            isinstance(stmt.value, ast.Constant) and \
                            isinstance(stmt.value.value, str):
                        facts.heartbeat_names.add(stmt.value.value)
                        emit_nodes.add(id(stmt.value))
    fstring_parts: Set[int] = set()  # id() of JoinedStr children: the
    # enclosing JoinedStr is classified as one glob, never its pieces

    for node in ast.walk(pf.tree):
        if isinstance(node, ast.JoinedStr):
            fstring_parts.update(id(v) for v in node.values)
        if isinstance(node, ast.Call):
            callee = _callee_name(node)
            arg = _first_arg_string(node)
            if callee in _METRIC_EMIT_METHODS and arg is not None and \
                    METRIC_RE.match(arg[0].replace("*", "x")):
                value, pattern, line = arg
                facts.metric_emits.append(
                    StrSite(value, pf.path, line, pattern))
                emit_nodes.add(id(node.args[0]))
            elif callee in _SPAN_EMIT_CALLEES and arg is not None:
                value, pattern, line = arg
                facts.span_emits.append(
                    StrSite(value, pf.path, line, pattern))
                emit_nodes.add(id(node.args[0]))
            elif callee in _PHASE_EMIT_CALLEES and arg is not None and \
                    isinstance(node.func, ast.Attribute):
                # attribute form only (sp.phase(...)): a bare phase()
                # is some other function, not a Span phase event
                value, pattern, line = arg
                facts.phase_emits.append(
                    StrSite(value, pf.path, line, pattern))
                emit_nodes.add(id(node.args[0]))
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "Keys":
            facts.keys_attr_reads.append((node.attr, pf.path, node.lineno))

    for node in ast.walk(pf.tree):
        if id(node) in emit_nodes or id(node) in fstring_parts:
            continue
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.lineno in doc_lines:
                continue  # docstrings are prose, not registry references
            v = node.value
            if METRIC_RE.match(v.replace("*", "x").replace("<", "x")
                               .replace(">", "x")):
                facts.metric_consumes.append(
                    StrSite(v, pf.path, node.lineno,
                            "*" in v or "{" in v or "<" in v))
            elif CONF_RE.match(v):
                facts.conf_literals.append(
                    StrSite(v, pf.path, node.lineno,
                            "*" in v or "{" in v or "<" in v))
        elif isinstance(node, ast.JoinedStr):
            glob = _joinedstr_glob(node)
            if glob is None or node.lineno in doc_lines:
                continue
            probe = glob.replace("*", "x")
            if METRIC_RE.match(probe):
                facts.metric_consumes.append(
                    StrSite(glob, pf.path, node.lineno, True))
            elif CONF_RE.match(probe):
                # f-string conf keys are minted at runtime; the analyzer
                # resolves them by literal prefix / template pattern
                facts.conf_literals.append(
                    StrSite(glob, pf.path, node.lineno, True))


def collect(model: RepoModel) -> RepoFacts:
    facts = RepoFacts()
    for pf in model.py_files:
        collect_file(pf, facts)
    return facts

