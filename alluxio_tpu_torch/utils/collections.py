"""Concurrent-ish collections used by the registries and job DAGs (a copy of
``alluxio_tpu/utils/collections.py``).

Re-designs of ``core/base/src/main/java/alluxio/collections/``:
- ``IndexedSet`` (multi-index set backing the master's worker/block
  registries, ``collections/IndexedSet.java``)
- ``DirectedAcyclicGraph`` (job workflow ordering,
  ``collections/DirectedAcyclicGraph.java``)
- ``PrefixList`` (path prefix matching, ``collections/PrefixList.java``)

Python's GIL plus coarse per-structure locks replace the reference's
lock-striped maps; the master uses a single-writer event loop anyway.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, Hashable, Iterable, Iterator, List, Optional, Set, TypeVar

T = TypeVar("T")
K = TypeVar("K", bound=Hashable)


class FieldIndex(Generic[T, K]):
    """Named index over a field extractor; unique or non-unique."""

    def __init__(self, name: str, extractor: Callable[[T], K],
                 unique: bool = False) -> None:
        self.name = name
        self.extractor = extractor
        self.unique = unique


class IndexedSet(Generic[T]):
    """A set queryable by any registered field index."""

    def __init__(self, *indexes: FieldIndex) -> None:
        if not indexes:
            raise ValueError("at least one index required")
        self._indexes: Dict[str, FieldIndex] = {ix.name: ix for ix in indexes}
        self._maps: Dict[str, Dict[Hashable, Set[T]]] = {
            ix.name: {} for ix in indexes}
        self._items: Set[T] = set()
        self._lock = threading.RLock()

    def add(self, item: T) -> bool:
        with self._lock:
            if item in self._items:
                return False
            # validate every unique constraint BEFORE touching any index so a
            # violation leaves the set untouched
            for name, ix in self._indexes.items():
                if ix.unique:
                    key = ix.extractor(item)
                    if self._maps[name].get(key):
                        raise ValueError(
                            f"unique index {name} already has key {key!r}")
            for name, ix in self._indexes.items():
                key = ix.extractor(item)
                self._maps[name].setdefault(key, set()).add(item)
            self._items.add(item)
            return True

    def remove(self, item: T) -> bool:
        with self._lock:
            if item not in self._items:
                return False
            self._items.discard(item)
            for name, ix in self._indexes.items():
                key = ix.extractor(item)
                bucket = self._maps[name].get(key)
                if bucket is not None:
                    bucket.discard(item)
                    if not bucket:
                        del self._maps[name][key]
            return True

    def get_by(self, index: str, key: Hashable) -> Set[T]:
        with self._lock:
            return set(self._maps[index].get(key, ()))

    def get_first_by(self, index: str, key: Hashable) -> Optional[T]:
        with self._lock:
            bucket = self._maps[index].get(key)
            return next(iter(bucket)) if bucket else None

    def contains_by(self, index: str, key: Hashable) -> bool:
        with self._lock:
            return key in self._maps[index]

    def remove_by(self, index: str, key: Hashable) -> int:
        with self._lock:
            victims = list(self._maps[index].get(key, ()))
            for v in victims:
                self.remove(v)
            return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def __iter__(self) -> Iterator[T]:
        with self._lock:
            return iter(list(self._items))

    def __contains__(self, item: T) -> bool:
        with self._lock:
            return item in self._items


class DirectedAcyclicGraph(Generic[T]):
    """DAG with payloads; supports topological iteration of roots/leaves."""

    def __init__(self) -> None:
        self._parents: Dict[T, Set[T]] = {}
        self._children: Dict[T, Set[T]] = {}
        self._lock = threading.RLock()

    def add(self, node: T, parents: Iterable[T] = ()) -> None:
        with self._lock:
            parents = list(parents)
            for p in parents:
                if p not in self._parents:
                    raise ValueError(f"unknown parent {p!r}")
            if node in self._parents:
                raise ValueError(f"node {node!r} already present")
            if any(self._reaches(node, p) for p in parents):
                raise ValueError("cycle detected")
            self._parents[node] = set(parents)
            self._children[node] = set()
            for p in parents:
                self._children[p].add(node)

    def _reaches(self, src: T, dst: T) -> bool:
        if src == dst:
            return True
        stack = [src]
        seen = set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            for c in self._children.get(n, ()):
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return False

    def remove(self, node: T) -> None:
        with self._lock:
            if self._children.get(node):
                raise ValueError(f"node {node!r} still has children")
            for p in self._parents.pop(node, ()):
                self._children[p].discard(node)
            self._children.pop(node, None)

    def roots(self) -> List[T]:
        with self._lock:
            return [n for n, ps in self._parents.items() if not ps]

    def children(self, node: T) -> Set[T]:
        with self._lock:
            return set(self._children.get(node, ()))

    def parents(self, node: T) -> Set[T]:
        with self._lock:
            return set(self._parents.get(node, ()))

    def topological_order(self) -> List[T]:
        with self._lock:
            indeg = {n: len(ps) for n, ps in self._parents.items()}
            order: List[T] = []
            frontier = [n for n, d in indeg.items() if d == 0]
            while frontier:
                n = frontier.pop()
                order.append(n)
                for c in self._children.get(n, ()):
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        frontier.append(c)
            return order

    def __contains__(self, node: T) -> bool:
        with self._lock:
            return node in self._parents

    def __len__(self) -> int:
        with self._lock:
            return len(self._parents)


class PrefixList:
    """Path-prefix membership test (reference: ``PrefixList.java``)."""

    def __init__(self, prefixes: Iterable[str]) -> None:
        self._prefixes = [p for p in (s.strip() for s in prefixes) if p]

    def in_list(self, path: str) -> bool:
        return any(path.startswith(p) for p in self._prefixes)

    def out_list(self, path: str) -> bool:
        return not self.in_list(path)
