"""Analyzer 1: conf-key discipline.

Checks, against the live ``PropertyKey`` registry (imported, not
re-parsed — templates and aliases behave exactly as production):

- ``conf-unknown-key``       an ``atpu.*`` literal in code resolves to no
                             registered key, alias, template or span name
- ``conf-dead-key``          a registered key no product code reads
                             (neither ``Keys.X`` nor a string literal)
- ``conf-bad-default``       a declared default its own type fails to parse

The JAX package's two doc rules (``conf-unknown-key-doc``,
``conf-undocumented-key``) and its doc writer are left out: the port's
lint reads no docs.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from alluxio_tpu_torch.lint.collect import RepoFacts
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.model import RepoModel

RULES = ("conf-unknown-key", "conf-dead-key", "conf-bad-default")

_PROPERTY_KEY_PATH = "alluxio_tpu_torch/conf/property_key.py"


def _registry():
    from alluxio_tpu_torch.conf import property_key as pk

    return pk


def _keys_attr_map(model: RepoModel) -> Dict[str, str]:
    """``Keys.<ATTR>`` -> key name, from the catalog module's AST."""
    out: Dict[str, str] = {}
    for pf in model.py(_PROPERTY_KEY_PATH):
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ClassDef) or node.name != "Keys":
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Call) and \
                        stmt.value.args and \
                        isinstance(stmt.value.args[0], ast.Constant):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            out[tgt.id] = stmt.value.args[0].value
    return out


def _resolve(pk, name: str, span_names: Set[str]) -> bool:
    """Does ``name`` (possibly a glob / template form) resolve?"""
    if pk.REGISTRY.get(name) is not None:
        return True
    if name in span_names:
        return True
    if pk.Template.match(name) is not None:
        return True
    if any(ch in name for ch in "*{<"):
        prefix = name
        for ch in "*{<":
            prefix = prefix.split(ch)[0]
        if not prefix:
            return False
        known: List[str] = list(pk.REGISTRY.all_keys())
        known.extend(a for a in getattr(pk.REGISTRY, "_aliases", {}))
        known.extend(span_names)
        known.extend(t.pattern.split("{")[0] for t in pk._TEMPLATES)
        return any(k.startswith(prefix) or prefix.startswith(k.split("{")[0])
                   for k in known)
    return False


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    pk = _registry()
    findings: List[Finding] = []
    span_names = facts.span_names()
    attr_map = _keys_attr_map(model)

    # 1) every atpu.* literal in code resolves
    for site in facts.conf_literals:
        if site.path == _PROPERTY_KEY_PATH:
            continue  # the catalog itself (registrations, alias tuples)
        if not _resolve(pk, site.value, span_names):
            findings.append(Finding(
                rule="conf-unknown-key", path=site.path, line=site.line,
                anchor=site.value,
                message=f"'{site.value}' resolves to no registered "
                        f"PropertyKey, alias, template or span name"))

    # registry-level checks need the whole tree: a --changed run only saw
    # a slice of the usage sites, so "dead" would be meaningless noise
    if model.is_partial:
        return findings

    # Template-minted keys (tieredstore levels, mount options…) enter the
    # live REGISTRY at runtime — e.g. when an earlier test in the same
    # process called Template.format(). They have no static read site by
    # construction, so registry-level checks consider only statically
    # registered keys.
    all_keys = {n: k for n, k in pk.REGISTRY.all_keys().items()
                if pk.Template.match(n) is None}
    aliases: Dict[str, str] = dict(getattr(pk.REGISTRY, "_aliases", {}))

    # 2) every registered key is read by product code
    used: Set[str] = set()
    for attr, path, _line in facts.keys_attr_reads:
        if path == _PROPERTY_KEY_PATH:
            continue
        name = attr_map.get(attr)
        if name:
            used.add(name)
    for site in facts.conf_literals:
        if site.path == _PROPERTY_KEY_PATH:
            continue
        name = site.value
        canonical = aliases.get(name, name)
        if canonical in all_keys:
            used.add(canonical)
        elif site.pattern:
            prefix = name
            for ch in "*{<":
                prefix = prefix.split(ch)[0]
            used.update(k for k in all_keys if k.startswith(prefix))

    key_line = _key_def_lines(model)
    for name in sorted(all_keys):
        if name not in used:
            findings.append(Finding(
                rule="conf-dead-key", path=_PROPERTY_KEY_PATH,
                line=key_line.get(name, 1), anchor=name,
                message=f"registered key '{name}' is read by no product "
                        f"code (wire it through or delete it)"))

    # 3) defaults parse under their declared type
    for name, key in sorted(all_keys.items()):
        if key.default is None:
            continue
        try:
            key.parse(key.default)
        except Exception as e:  # noqa: BLE001 - the failure IS the finding
            findings.append(Finding(
                rule="conf-bad-default", path=_PROPERTY_KEY_PATH,
                line=key_line.get(name, 1), anchor=name,
                message=f"default {key.default!r} of '{name}' fails its "
                        f"declared {key.key_type.name} parser: {e}"))
    return findings


def _key_def_lines(model: RepoModel) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for pf in model.py(_PROPERTY_KEY_PATH):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else \
                    getattr(fn, "attr", "")
                if name == "_k":
                    out[node.args[0].value] = node.lineno
    return out

