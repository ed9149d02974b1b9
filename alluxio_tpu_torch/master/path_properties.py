"""Per-path configuration defaults + cluster config consistency check
(a copy of ``alluxio_tpu/master/path_properties.py``).

Re-designs of ``core/server/master/.../meta/PathProperties.java`` (journaled
path -> {property: value} map distributed to clients, longest-prefix wins)
and ``meta/checkconf/ServerConfigurationChecker.java`` (compare the configs
registered by cluster nodes and report conflicts on keys that must agree).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

from alluxio_tpu_torch.conf import REGISTRY
from alluxio_tpu_torch.journal.format import EntryType
from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError
from alluxio_tpu_torch.utils.uri import AlluxioURI


def resolve_path_property(props: Dict[str, Dict[str, str]], path: str,
                          key: str) -> Optional[str]:
    """Longest-prefix match over a path->properties map (reference:
    PathPropertiesView + PrefixPathMatcher); shared by master and the
    client-side cached view."""
    path = AlluxioURI(path).path
    best: Tuple[int, Optional[str]] = (-1, None)
    for prefix, kv in props.items():
        if key not in kv:
            continue
        if path == prefix or path.startswith(
                prefix.rstrip("/") + "/") or prefix == "/":
            if len(prefix) > best[0]:
                best = (len(prefix), kv[key])
    return best[1]


class PathProperties:
    """Journaled path-prefix -> {key: value} (reference: PathProperties)."""

    journal_name = "PathProperties"

    def __init__(self, journal) -> None:
        self._journal = journal
        self._props: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()
        # serializes add/remove: each journals the FULL merged map, so two
        # concurrent mutators reading the same pre-state would lose one
        # caller's keys (read-modify-write race). Separate from self._lock
        # because journal application re-enters process_entry -> self._lock.
        self._mutate_lock = threading.Lock()
        journal.register(self)

    # -- API -----------------------------------------------------------------
    def add(self, path: str, properties: Dict[str, str]) -> None:
        path = AlluxioURI(path).path
        for k in properties:
            if not REGISTRY.is_valid(k):
                raise InvalidArgumentError(f"unknown property key: {k}")
        with self._mutate_lock:
            with self._lock:
                merged = dict(self._props.get(path, {}))
            merged.update({k: str(v) for k, v in properties.items()})
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.PATH_PROPERTIES,
                           {"path": path, "properties": merged})

    def remove(self, path: str, keys: Optional[List[str]] = None) -> None:
        path = AlluxioURI(path).path
        with self._mutate_lock:
            with self._lock:
                if path not in self._props:
                    return
                if keys:
                    remaining = {k: v for k, v in self._props[path].items()
                                 if k not in keys}
                else:
                    remaining = {}
            if remaining:
                with self._journal.create_context() as ctx:
                    ctx.append(EntryType.PATH_PROPERTIES,
                               {"path": path, "properties": remaining})
            else:
                with self._journal.create_context() as ctx:
                    ctx.append(EntryType.REMOVE_PATH_PROPERTIES,
                               {"path": path})

    def get_all(self) -> Dict[str, Dict[str, str]]:
        with self._lock:
            return {p: dict(kv) for p, kv in self._props.items()}

    def hash(self) -> str:
        h = hashlib.md5()
        with self._lock:
            for p in sorted(self._props):
                for k in sorted(self._props[p]):
                    h.update(f"{p}|{k}={self._props[p][k]};".encode())
        return h.hexdigest()

    def resolve(self, path: str, key: str) -> Optional[str]:
        return resolve_path_property(self.get_all(), path, key)

    # -- journal contract ----------------------------------------------------
    def process_entry(self, entry) -> bool:
        if entry.type == EntryType.PATH_PROPERTIES:
            with self._lock:
                self._props[entry.payload["path"]] = dict(
                    entry.payload.get("properties", {}))
            return True
        if entry.type == EntryType.REMOVE_PATH_PROPERTIES:
            with self._lock:
                self._props.pop(entry.payload["path"], None)
            return True
        return False

    def snapshot(self) -> dict:
        return {"props": self.get_all()}

    def restore(self, snap: dict) -> None:
        with self._lock:
            self._props = {p: dict(kv)
                           for p, kv in snap.get("props", {}).items()}

    def reset_state(self) -> None:
        with self._lock:
            self._props.clear()


class ConfigurationChecker:
    """Cross-node config consistency (reference:
    ServerConfigurationChecker): nodes report their config at registration;
    keys marked ENFORCE must agree everywhere, WARN keys produce warnings."""

    def __init__(self) -> None:
        self._reports: Dict[str, Dict[str, str]] = {}  # node id -> config
        self._lock = threading.Lock()

    def register(self, node_id: str, config: Dict[str, str]) -> None:
        with self._lock:
            self._reports[node_id] = {str(k): str(v)
                                      for k, v in config.items()}

    def forget(self, node_id: str) -> None:
        with self._lock:
            self._reports.pop(node_id, None)

    def report(self) -> dict:
        """{'status': PASSED|WARN|FAILED, 'errors': [...], 'warns': [...]}"""
        from alluxio_tpu_torch.conf.property_key import ConsistencyLevel

        with self._lock:
            reports = {n: dict(c) for n, c in self._reports.items()}
        keys = set()
        for c in reports.values():
            keys.update(c)
        errors: List[str] = []
        warns: List[str] = []
        for key in sorted(keys):
            values: Dict[str, List[str]] = {}
            for node, c in reports.items():
                if key in c:
                    values.setdefault(c[key], []).append(node)
            if len(values) <= 1:
                continue
            pk = REGISTRY.get(key)
            level = getattr(pk, "consistency", None) if pk else None
            desc = ", ".join(f"{v!r} on [{', '.join(sorted(ns))}]"
                             for v, ns in sorted(values.items()))
            if level == ConsistencyLevel.ENFORCE:
                errors.append(f"{key}: {desc}")
            else:
                warns.append(f"{key}: {desc}")
        status = "FAILED" if errors else ("WARN" if warns else "PASSED")
        return {"status": status, "errors": errors, "warns": warns}
