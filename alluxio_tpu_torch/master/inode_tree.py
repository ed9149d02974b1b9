"""The namespace inode tree: a copy of ``alluxio_tpu/master/inode_tree.py``.

Re-design of ``core/server/master/.../file/meta/InodeTree.java:84`` +
``InodeTreePersistentState.java:71``.

**Locking rationale.** The reference implements fine-grained per-inode
read/write locks with lock lists (``InodeLockManager.java:47``,
``SimpleInodeLockList``). This tree started life as a single-writer state
machine behind one tree-level RW lock; at millions-of-users metadata rates
that one lock became the cluster ceiling (BENCH_SUITE: ListStatus ~1.6k
ops/s while the data plane streams GB/s), so the scheme is now **two
level**:

- ``self.lock`` (tree-level RW lock) is held in READ mode by every
  path-locked operation and in WRITE mode only by heavyweight multi-phase
  operations (mount/unmount, UFS metadata load, commit_persist,
  snapshot/restore).  A tree-write therefore still excludes everything —
  the safe fallback for paths not worth striping.
- ``lock_path()`` hands out a :class:`LockedInodePath` — per-inode
  read/write locks acquired root→leaf along the path (read on ancestors,
  write on the terminal/deepest-existing inode only), mirroring the
  reference's ``SimpleInodeLockList``.  Independent subtrees — the common
  case for per-host training shards — no longer serialize.
- **WRITE_EDGE locking** (reference: ``InodeTree.LockPattern.WRITE_EDGE``):
  with ``edge_locking`` on (the default), a create takes only a READ lock
  on the deepest existing inode plus a WRITE lock on the *edge*
  ``(parent_id, name)`` it is about to fill; deletes/renames write-lock
  their terminal AND its parent edge.  Sibling creates/deletes under ONE
  hot directory — the "many trainers materializing shards into one dir"
  pattern — no longer serialize on the parent inode's write lock; only
  same-NAME operations contend.  The parent read lock still excludes a
  concurrent delete of the parent (which needs the parent's write lock).

Acquisition order is canonical and audited (``lint/pytest_lockaudit``):
``InodeTree.lock`` (read) → ``InodeTree.inode_lock`` (root→leaf, write at
the tail) → ``InodeTree.edge_lock`` (after ALL inode locks; pairs sort
their ≤2 edges by ``(parent_id, name)``) → everything downstream (journal
commit queue, BlockMaster).  Multi-path operations (rename) acquire their
two lock lists as one merged plan in lexicographic path order.

All mutations arrive as journal entries via ``process_entry`` — the tree is
a ``Journaled`` component; the FileSystemMaster validates + emits entries,
it never pokes tree state directly.  Applies are serialized by the journal
system; the small id registries (pinned/TTL/persist sets) carry their own
``registry_lock`` so snapshot readers never iterate a mutating set.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from alluxio_tpu_torch.journal.format import EntryType, JournalEntry, Journaled
from alluxio_tpu_torch.master.inode import Inode, PersistenceState
from alluxio_tpu_torch.master.metastore import HeapInodeStore, InodeStore
from alluxio_tpu_torch.master.ttl import TtlBucketList
from alluxio_tpu_torch.utils.exceptions import (
    FileDoesNotExistError, InvalidPathError,
)
from alluxio_tpu_torch.utils.locks import RWLock
from alluxio_tpu_torch.utils.uri import AlluxioURI

ROOT_ID_PARENT = -1

#: entry types that mutate the namespace — each application bumps
#: ``InodeTree.change_version`` (the listing cache's coherence stamp)
_MUTATING_TYPES = frozenset((
    EntryType.INODE_DIRECTORY, EntryType.INODE_FILE, EntryType.UPDATE_INODE,
    EntryType.NEW_BLOCK, EntryType.COMPLETE_FILE, EntryType.DELETE_FILE,
    EntryType.RENAME, EntryType.SET_ATTRIBUTE, EntryType.SET_ACL,
    EntryType.PERSIST_FILE,
))

#: (registry, timer) cache: the lock-wait timer updates on EVERY
#: path-locked metadata op, so the per-call registry lock + dict lookup
#: must stay off the hot path — but tests' ``reset_metrics()`` swaps the
#: registry, so the cache keys on registry identity, not process
#: lifetime (same constraint ``master/metrics_master.py`` documents)
_timer_cache: "Tuple[object, object]" = (None, None)


def _lock_wait_timer():
    global _timer_cache
    from alluxio_tpu_torch.metrics import metrics

    reg = metrics()
    cached_reg, timer = _timer_cache
    if cached_reg is not reg:
        timer = reg.timer("Master.MetadataInodeLockWaitTime")
        _timer_cache = (reg, timer)
    return timer


class InodeLockManager:
    """Pool of keyed RW locks, created on demand and swept when idle
    (reference: ``InodeLockManager.java:47`` — there a weak-value map).
    Keys are inode ids for the inode pool and ``(parent_id, name)``
    tuples for the edge pool — any hashable works.

    ``checkout``/``checkin`` refcount each lock so a sweep can never
    evict a lock some thread still holds: two paths locking the same
    key MUST share one RWLock object, and eviction-while-held would
    silently split them."""

    #: idle locks are swept once the pool outgrows this (a pool entry
    #: is ~a hundred bytes; 64k ≈ the hot working set of a large run)
    MAX_IDLE_POOL = 65536

    def __init__(self) -> None:
        self._locks: Dict[object, list] = {}  # key -> [lock, refcount]
        self._pool_lock = threading.Lock()
        #: test-harness hook (lint/pytest_lockaudit): wraps every fresh
        #: RWLock in an audited proxy (``InodeTree.inode_lock`` /
        #: ``InodeTree.edge_lock``)
        self._proxy_factory = None

    def checkout(self, key):
        with self._pool_lock:
            ent = self._locks.get(key)
            if ent is None:
                lock = RWLock()
                if self._proxy_factory is not None:
                    lock = self._proxy_factory(lock)
                ent = self._locks[key] = [lock, 0]
            ent[1] += 1
            return ent[0]

    def checkin(self, key) -> None:
        with self._pool_lock:
            ent = self._locks.get(key)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0 and len(self._locks) > self.MAX_IDLE_POOL:
                # amortized sweep of ALL idle entries (refcount 0 means
                # no thread can be inside acquire/release on it)
                for k in [k for k, e in self._locks.items() if e[1] <= 0]:
                    del self._locks[k]

    def pool_size(self) -> int:
        with self._pool_lock:
            return len(self._locks)


class LockedInodePath:
    """An ordered per-inode lock list along ``uri`` (reference:
    ``SimpleInodeLockList`` + ``LockedInodePath``): read locks root→parent,
    write lock on the terminal inode — or, when the terminal does not
    exist (create), on the deepest EXISTING inode, under which all new
    inodes are linked.

    Acquisition is optimistic: walk the tree unlocked (the store is
    internally synchronized), acquire the planned locks root→leaf, then
    re-validate every edge of the locked chain against the live tree —
    a concurrent rename/delete/create that moved the path retries the
    walk.  Validated chains are then stable: every inode in the chain is
    read-held here, and any namespace mutation of it (or of the edge
    below the deepest) requires a write lock this list excludes.
    """

    def __init__(self, tree: "InodeTree", uri: AlluxioURI, *,
                 write: bool = False, write_parent: bool = False) -> None:
        self._tree = tree
        self.uri = uri
        self.write = write
        #: also write-lock the terminal's parent (atomic replace:
        #: create(overwrite=True) deletes the terminal then re-creates
        #: under the parent inside ONE lock scope)
        self._write_parent = write_parent
        self._held: List[Tuple[int, str, object]] = []
        self.lookup: Optional[PathLookup] = None

    # -- acquisition --------------------------------------------------------
    def acquire(self) -> "LockedInodePath":
        tree = self._tree
        comps = self.uri.path_components()
        try:
            while True:
                chain, modes, full, edge = _plan(tree, comps, self.write,
                                                 self._write_parent)
                _acquire_planned(tree, zip(chain, modes), self._held)
                if edge is not None:
                    _acquire_edges(tree, [edge], self._held)
                if _validate_chain(tree, chain, comps, full):
                    self.lookup = PathLookup(uri=self.uri, inodes=chain)
                    return self
                self.release()
        except BaseException:
            # a store error (e.g. a SQLITE metastore hiccup) mid-plan or
            # mid-validate must not leak held locks: a leaked terminal
            # write lock would wedge its path forever
            self.release()
            raise

    def release(self) -> None:
        _release_held(self._tree, self._held)


def _plan(tree: "InodeTree", comps, write: bool, write_parent: bool):
    """Walk (unlocked) and plan lock modes root→leaf plus, under edge
    locking, the write-mode edge ``(parent_id, name)`` the operation
    mutates.  Read on ancestors; the terminal inode is write-locked when
    it exists (its fields mutate), while a CREATE write-locks only the
    missing edge and READ-locks the deepest existing inode — sibling
    creates under one directory stop excluding each other."""
    root = tree.root
    if root is None:
        raise InvalidPathError("inode tree not initialized")
    store = tree._store
    chain: List[Inode] = [root]
    cur = root
    for name in comps:
        cid = store.get_child_id(cur.id, name)
        if cid is None:
            break
        child = store.get(cid)
        if child is None:
            break
        chain.append(child)
        cur = child
    full = len(chain) == len(comps) + 1
    modes = ["r"] * len(chain)
    edge: Optional[Tuple[int, str]] = None
    if write:
        if tree.edge_locking:
            if full:
                # existing terminal: write the inode (field mutations)
                # AND its parent edge (delete/rename unlink it)
                modes[-1] = "w"
                if len(chain) >= 2:
                    edge = (chain[-2].id, comps[len(chain) - 2])
                if write_parent and len(chain) >= 2:
                    modes[-2] = "w"
            elif len(comps) > 0:
                # create: the deepest existing inode stays read-held
                # (keeping it alive — deleting it needs its write lock);
                # the FIRST MISSING edge is the thing being filled in
                edge = (chain[-1].id, comps[len(chain) - 1])
        else:
            modes[-1] = "w"
            if write_parent and full and len(chain) >= 2:
                modes[-2] = "w"
    return chain, modes, full, edge


def _acquire_planned(tree: "InodeTree", planned, held: List[Tuple]) -> None:
    """Acquire ``(inode, mode)`` pairs in the given order, recording
    into ``held`` (release via ``_release_held``)."""
    mgr = tree.lock_manager
    for inode, mode in planned:
        lock = mgr.checkout(inode.id)
        if mode == "w":
            lock.acquire_write()
        else:
            lock.acquire_read()
        held.append(("inode", inode.id, mode, lock))


def _acquire_edges(tree: "InodeTree", edges, held: List[Tuple]) -> None:
    """Write-acquire edge locks AFTER every inode lock (the canonical
    order); multi-edge callers pass them sorted by ``(parent_id,
    name)`` — the total order that keeps two renames from deadlocking."""
    mgr = tree.edge_lock_manager
    for edge in edges:
        lock = mgr.checkout(edge)
        lock.acquire_write()
        held.append(("edge", edge, "w", lock))


def _release_held(tree: "InodeTree", held: List[Tuple]) -> None:
    for kind, key, mode, lock in reversed(held):
        if mode == "w":
            lock.release_write()
        else:
            lock.release_read()
        if kind == "edge":
            tree.edge_lock_manager.checkin(key)
        else:
            tree.lock_manager.checkin(key)
    held.clear()


def _validate_chain(tree: "InodeTree", chain: List[Inode], comps,
                    full: bool) -> bool:
    store = tree._store
    if tree._root_id != chain[0].id:
        return False
    for i, child in enumerate(chain[1:]):
        # validate against the REQUESTED component names, not the
        # (mutable) inode.name attr: a same-parent rename keeps the
        # edge consistent with inode.name while leaving our path
        if store.get_child_id(chain[i].id, comps[i]) != child.id:
            return False
    if not full:
        # the first missing component must still be missing, or the
        # lock list stops above the true terminal
        if store.get_child_id(chain[-1].id, comps[len(chain) - 1]) \
                is not None:
            return False
    return True


class LockedInodePathPair:
    """Two lock lists acquired as ONE merged plan (rename).  The union
    of both chains is taken with the strongest mode per inode — the two
    root-down chains share exactly their common path prefix, so merging
    avoids the same-thread read→write upgrade a sequential acquisition
    would deadlock on — and is acquired prefix-first, then the two
    divergent suffixes in lexicographic path order (the canonical order
    all multi-path operations share)."""

    def __init__(self, tree: "InodeTree", first: AlluxioURI,
                 second: AlluxioURI) -> None:
        self._tree = tree
        self._first, self._second = first, second
        self._held: List[Tuple[int, str, object]] = []
        self.first_lookup: Optional[PathLookup] = None
        self.second_lookup: Optional[PathLookup] = None

    def acquire(self) -> "LockedInodePathPair":
        tree = self._tree
        a_uri, b_uri = sorted((self._first, self._second),
                              key=lambda u: u.path)
        a_comps, b_comps = a_uri.path_components(), b_uri.path_components()
        try:
            while True:
                a_chain, a_modes, a_full, a_edge = _plan(
                    tree, a_comps, True, False)
                b_chain, b_modes, b_full, b_edge = _plan(
                    tree, b_comps, True, False)
                # merged plan: strongest mode per inode; shared inodes are
                # exactly the chains' common prefix (root-down paths)
                want: Dict[int, str] = {}
                order: List[Inode] = []
                for chain, modes in ((a_chain, a_modes),
                                     (b_chain, b_modes)):
                    for inode, mode in zip(chain, modes):
                        if inode.id not in want:
                            want[inode.id] = mode
                            order.append(inode)
                        elif mode == "w":
                            want[inode.id] = "w"
                _acquire_planned(tree, ((i, want[i.id]) for i in order),
                                 self._held)
                # both edges AFTER the merged inode plan, in the global
                # (parent_id, name) total order — concurrent pairs can
                # never hold one edge while waiting on the other crosswise
                edges = sorted({e for e in (a_edge, b_edge)
                                if e is not None})
                _acquire_edges(tree, edges, self._held)
                if _validate_chain(tree, a_chain, a_comps, a_full) and \
                        _validate_chain(tree, b_chain, b_comps, b_full):
                    lookups = {
                        a_uri.path: PathLookup(uri=a_uri, inodes=a_chain),
                        b_uri.path: PathLookup(uri=b_uri, inodes=b_chain),
                    }
                    self.first_lookup = lookups[self._first.path]
                    self.second_lookup = lookups[self._second.path]
                    return self
                self.release()
        except BaseException:
            self.release()  # never leak a partial merged plan
            raise

    def release(self) -> None:
        _release_held(self._tree, self._held)


class _PathHandle:
    """Minimal ``lock_path`` result holder: a resolved lookup whose
    locks are managed by the enclosing scope (coarse mode and the
    pair-lock wrapper both use it)."""

    def __init__(self, lookup: "PathLookup") -> None:
        self.lookup = lookup

    def release(self) -> None:  # pragma: no cover - symmetry only
        pass


@dataclass
class PathLookup:
    """Resolution of a path: the inodes that exist along it
    (reference: ``LockedInodePath``)."""

    uri: AlluxioURI
    inodes: List[Inode] = field(default_factory=list)  # root..deepest existing

    @property
    def exists(self) -> bool:
        return len(self.inodes) == self.uri.depth() + 1

    @property
    def inode(self) -> Inode:
        if not self.exists:
            raise FileDoesNotExistError(f"path {self.uri} does not exist")
        return self.inodes[-1]

    @property
    def deepest(self) -> Inode:
        return self.inodes[-1]

    @property
    def missing_components(self) -> List[str]:
        comps = self.uri.path_components()
        return list(comps[len(self.inodes) - 1:])


class InodeTree(Journaled):
    journal_name = "InodeTree"

    def __init__(self, store: Optional[InodeStore] = None, *,
                 coarse_locking: bool = False,
                 edge_locking: bool = True) -> None:
        self._store = store if store is not None else HeapInodeStore()
        self.lock = RWLock()
        self.lock_manager = InodeLockManager()
        #: WRITE_EDGE lock pool, keyed ``(parent_id, name)`` — acquired
        #: strictly AFTER every inode lock (audited order)
        self.edge_lock_manager = InodeLockManager()
        #: True: ``lock_path`` degrades to the tree-level lock (the
        #: pre-striping single-lock master) — bench baseline + escape
        #: hatch; striped is the default
        self.coarse_locking = coarse_locking
        #: False: creates fall back to write-locking the deepest existing
        #: inode (the pre-WRITE_EDGE scheme) — bench baseline
        self.edge_locking = edge_locking
        #: guards the id registries below (pinned/to-be-persisted/lost/
        #: replication-limited sets + inode_count + change_version):
        #: journal applies mutate them while snapshot readers copy them,
        #: and striped locking means those no longer share the tree lock
        self.registry_lock = threading.Lock()
        #: monotonic namespace-mutation counter (bumped per applied
        #: mutating journal entry).  "version unchanged" == "namespace
        #: unchanged" — the listing cache's coherence stamp, replacing
        #: the tree-write-lock version that striping made incomplete.
        self.change_version = 0
        self._root_id: Optional[int] = None
        self.ttl_buckets = TtlBucketList()
        self.pinned_ids: Set[int] = set()
        self.to_be_persisted_ids: Set[int] = set()
        #: files currently marked PersistenceState.LOST — rebuilt on
        #: replay/restore so the LostFileDetector can recover them
        #: after a master restart
        self.lost_file_ids: Set[int] = set()
        #: files with replication_min>0 or replication_max>=0; the
        #: ReplicationChecker walks only these (reference: the pinned/
        #: replication-limited inode registries in InodeTreePersistentState)
        self.replication_limited_ids: Set[int] = set()
        self._inode_count = 0
        #: invalidation-log feed (FileSystemMaster installs
        #: ``invalidations.append``).  Called from ``process_entry`` —
        #: the JOURNAL APPLY path — so primary and tailing standbys
        #: advance the same deterministic md_version sequence; the RPC
        #: methods themselves never append (docs/ha.md).
        self.invalidation_sink: Optional[Callable[[str], None]] = None
        #: the log itself (FileSystemMaster wires it alongside the
        #: sink): checkpoint snapshots carry its version so a master
        #: bootstrapping from a checkpoint — which skips the entries the
        #: checkpoint covers — still counts the same md_version a full
        #: replay would (docs/ha.md)
        self.invalidation_log = None

    # ------------------------------------------------------------- locking
    @contextlib.contextmanager
    def lock_path(self, uri: AlluxioURI, *, write: bool = False,
                  write_parent: bool = False):
        """Scope holding the tree lock (read) plus an ordered per-inode
        lock list along ``uri`` — read locks on ancestors, write lock on
        the terminal (or deepest existing, for creates).  Yields the
        list with a fresh :class:`PathLookup` in ``.lookup``.  In coarse
        mode this is exactly the old single-lock critical section."""
        if self.coarse_locking:
            guard = self.lock.write_locked() if write \
                else self.lock.read_locked()
            with guard:
                yield _PathHandle(self.lookup(uri))
            return
        t0 = time.perf_counter()
        self.lock.acquire_read()
        lip = LockedInodePath(self, uri, write=write,
                              write_parent=write_parent)
        try:
            lip.acquire()
        except BaseException:
            self.lock.release_read()
            raise
        _lock_wait_timer().update(time.perf_counter() - t0)
        try:
            yield lip
        finally:
            lip.release()
            self.lock.release_read()

    @contextlib.contextmanager
    def lock_path_pair(self, first: AlluxioURI, second: AlluxioURI, *,
                       write: bool = True):
        """Two lock lists for a two-path operation (rename).  Lists are
        acquired in lexicographic path order — every multi-path caller
        converging on the same total order is what keeps two concurrent
        renames from deadlocking — and yielded in CALLER order."""
        if self.coarse_locking:
            guard = self.lock.write_locked() if write \
                else self.lock.read_locked()
            with guard:
                yield (_PathHandle(self.lookup(first)),
                       _PathHandle(self.lookup(second)))
            return
        t0 = time.perf_counter()
        self.lock.acquire_read()
        pair = LockedInodePathPair(self, first, second)
        try:
            pair.acquire()
        except BaseException:
            self.lock.release_read()
            raise
        _lock_wait_timer().update(time.perf_counter() - t0)
        try:
            yield (_PathHandle(pair.first_lookup),
                   _PathHandle(pair.second_lookup))
        finally:
            pair.release()
            self.lock.release_read()

    # ------------------------------------------------------------------ read
    @property
    def root(self) -> Optional[Inode]:
        return self._store.get(self._root_id) if self._root_id is not None else None

    @property
    def inode_count(self) -> int:
        return self._inode_count

    def get_inode(self, inode_id: int) -> Optional[Inode]:
        return self._store.get(inode_id)

    def lookup(self, uri: AlluxioURI) -> PathLookup:
        """Walk the path from root; returns all inodes that exist."""
        result = PathLookup(uri=uri)
        root = self.root
        if root is None:
            raise InvalidPathError("inode tree not initialized")
        result.inodes.append(root)
        cur = root
        for name in uri.path_components():
            child_id = self._store.get_child_id(cur.id, name)
            if child_id is None:
                break
            child = self._store.get(child_id)
            if child is None:
                break
            result.inodes.append(child)
            cur = child
        return result

    def get_path(self, inode: Inode) -> AlluxioURI:
        """Reconstruct the full path of an inode by walking parents."""
        parts: List[str] = []
        cur: Optional[Inode] = inode
        while cur is not None and cur.parent_id != ROOT_ID_PARENT:
            parts.append(cur.name)
            cur = self._store.get(cur.parent_id)
        return AlluxioURI("/" + "/".join(reversed(parts)))

    def child_names(self, inode: Inode) -> List[str]:
        return self._store.child_names(inode.id)

    def parent_of(self, inode: Inode) -> Optional[Inode]:
        if inode.parent_id == ROOT_ID_PARENT:
            return None
        return self._store.get(inode.parent_id)

    def path_of_id(self, inode_id: int) -> Optional[AlluxioURI]:
        """Current full path of an inode id, or None when it no longer
        exists (callers hold the tree lock)."""
        inode = self._store.get(inode_id)
        if inode is None:
            return None
        return self.get_path(inode)

    def children(self, inode: Inode,
                 start_after: Optional[str] = None) -> Iterator[Inode]:
        """Stream children in name order via the store's iterator
        contract — one range scan on LSM (one lookup per child instead
        of the old three), resumable at ``start_after`` for paged
        listings."""
        for _name, cid in self._store.iter_edges(inode.id, start_after):
            child = self._store.get(cid)
            if child is not None:
                yield child

    def has_children(self, inode: Inode) -> bool:
        return self._store.has_children(inode.id)

    def descendants(self, inode: Inode) -> Iterator[Inode]:
        """Post-order descendants (children before parents) for deletes."""
        for child in list(self.children(inode)):
            if child.is_directory:
                yield from self.descendants(child)
            yield child

    # ------------------------------------------------- journal application
    def process_entry(self, entry: JournalEntry) -> bool:
        # Invalidation paths resolve around the apply: delete/rename need
        # the PRE-apply path (the inode edge is gone after), creates the
        # POST-apply one.  Feeding the sink from the apply path — not the
        # RPC methods — makes the invalidation-log version a pure
        # function of the applied journal, so a tailing standby counts
        # the SAME md_version the primary stamps (docs/ha.md).
        if entry.type == EntryType.INVALIDATE_PATH:
            # a client-cache invalidation with no metadata mutation of
            # its own (block-location drift, free): journaled purely so
            # the version sequence advances identically on primary and
            # tailing standbys
            with self.registry_lock:
                self.change_version += 1
            sink = self.invalidation_sink
            if sink is not None:
                sink(entry.payload.get("path", "/"))
            return True
        pre_paths: List[str] = []
        # a "covered" DELETE_FILE is a recursive delete's descendant:
        # the delete ROOT's own entry invalidates the whole subtree by
        # client-side prefix semantics, and appending one ring entry
        # per victim would push a large delete past the bounded ring's
        # horizon — a cluster-wide cache reset where one prefix does
        covered = bool(entry.payload.get("covered"))
        if self.invalidation_sink is not None and not covered and \
                entry.type in (EntryType.DELETE_FILE, EntryType.RENAME):
            uri = self.path_of_id(entry.payload.get("id"))
            if uri is not None:
                pre_paths.append(uri.path)
        out = self._process_entry(entry)
        # bump AFTER the mutation lands: a concurrent lister that read
        # the pre-bump version can then never cache a post-mutation
        # stamp on pre-mutation data — the race fails as a cache miss,
        # never as a stale hit
        if entry.type in _MUTATING_TYPES:
            with self.registry_lock:
                self.change_version += 1
            sink = self.invalidation_sink
            if sink is not None:
                # post-apply resolution, same stale-hit ordering as the
                # change_version bump above: the version moves only once
                # the mutated state is visible
                paths = list(pre_paths)
                if entry.type not in (EntryType.DELETE_FILE,):
                    target = entry.payload.get("id",
                                               entry.payload.get("file_id"))
                    uri = self.path_of_id(target) if target is not None \
                        else None
                    if uri is not None and uri.path not in paths:
                        paths.append(uri.path)
                for p in paths:
                    sink(p)
        return out

    def _process_entry(self, entry: JournalEntry) -> bool:
        t, p = entry.type, entry.payload
        if t == EntryType.INODE_DIRECTORY or t == EntryType.INODE_FILE:
            self._apply_create(Inode.from_wire_dict(p))
        elif t == EntryType.UPDATE_INODE:
            self._apply_update(p)
        elif t == EntryType.NEW_BLOCK:
            self._apply_new_block(p)
        elif t == EntryType.COMPLETE_FILE:
            self._apply_complete(p)
        elif t == EntryType.DELETE_FILE:
            self._apply_delete(p)
        elif t == EntryType.RENAME:
            self._apply_rename(p)
        elif t == EntryType.SET_ATTRIBUTE:
            self._apply_set_attribute(p)
        elif t == EntryType.SET_ACL:
            self._apply_set_acl(p)
        elif t == EntryType.PERSIST_FILE:
            self._apply_persist(p)
        else:
            return False
        return True

    def _apply_create(self, inode: Inode) -> None:
        self._store.put(inode)
        with self.registry_lock:
            self._inode_count += 1
        if inode.parent_id == ROOT_ID_PARENT:
            self._root_id = inode.id
        else:
            self._store.add_child(inode.parent_id, inode.name, inode.id)
            parent = self._store.get(inode.parent_id)
            if parent is not None:
                parent.last_modification_time_ms = max(
                    parent.last_modification_time_ms, inode.creation_time_ms)
                self._store.put(parent)
        if inode.ttl >= 0:
            self.ttl_buckets.insert(inode.id, inode.creation_time_ms, inode.ttl)
        with self.registry_lock:
            if inode.pinned:
                self.pinned_ids.add(inode.id)
            # a file created to persist on completion (ASYNC_THROUGH)
            if inode.persistence_state == PersistenceState.TO_BE_PERSISTED:
                self.to_be_persisted_ids.add(inode.id)
            self._track_replication(inode)

    def _apply_update(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        for k, v in p.items():
            if k != "id" and hasattr(inode, k):
                setattr(inode, k, v)
        self._store.put(inode)

    def _apply_set_acl(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        inode.xattr = dict(p.get("xattr", {}))
        inode.last_modification_time_ms = p.get(
            "op_time_ms", inode.last_modification_time_ms)
        self._store.put(inode)

    def _apply_new_block(self, p: dict) -> None:
        inode = self._store.get(p["file_id"])
        if inode is None:
            return
        inode.block_ids.append(p["block_id"])
        self._store.put(inode)

    def _apply_complete(self, p: dict) -> None:
        inode = self._store.get(p["file_id"])
        if inode is None:
            return
        inode.completed = True
        inode.length = p["length"]
        inode.last_modification_time_ms = p.get("op_time_ms",
                                                inode.last_modification_time_ms)
        if "block_ids" in p and p["block_ids"] is not None:
            inode.block_ids = list(p["block_ids"])
        self._store.put(inode)

    def _apply_delete(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        self._store.remove_child(inode.parent_id, inode.name)
        self._store.remove(inode.id)
        with self.registry_lock:
            self._inode_count -= 1
            self.pinned_ids.discard(inode.id)
            self.to_be_persisted_ids.discard(inode.id)
            self.lost_file_ids.discard(inode.id)
            self.replication_limited_ids.discard(inode.id)
        if inode.ttl >= 0:
            self.ttl_buckets.remove(inode.id)
        parent = self._store.get(inode.parent_id)
        if parent is not None:
            parent.last_modification_time_ms = max(
                parent.last_modification_time_ms,
                p.get("op_time_ms", parent.last_modification_time_ms))
            self._store.put(parent)

    def _apply_rename(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        self._store.remove_child(inode.parent_id, inode.name)
        inode.parent_id = p["new_parent_id"]
        inode.name = p["new_name"]
        inode.last_modification_time_ms = p.get(
            "op_time_ms", inode.last_modification_time_ms)
        self._store.put(inode)
        self._store.add_child(inode.parent_id, inode.name, inode.id)

    def _apply_set_attribute(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        if "pinned" in p and p["pinned"] is not None:
            inode.pinned = p["pinned"]
            with self.registry_lock:
                if inode.pinned:
                    self.pinned_ids.add(inode.id)
                    inode.pinned_media = list(p.get("pinned_media") or [])
                else:
                    self.pinned_ids.discard(inode.id)
                    inode.pinned_media = []
        if "ttl" in p and p["ttl"] is not None:
            if inode.ttl >= 0:
                self.ttl_buckets.remove(inode.id)
            inode.ttl = p["ttl"]
            inode.ttl_action = p.get("ttl_action") or inode.ttl_action
            if inode.ttl >= 0:
                self.ttl_buckets.insert(
                    inode.id, p.get("op_time_ms", inode.creation_time_ms),
                    inode.ttl)
        for k in ("owner", "group", "mode", "replication_min",
                  "replication_max", "persistence_state",
                  "lost_pending_persist"):
            if p.get(k) is not None:
                setattr(inode, k, p[k])
        with self.registry_lock:
            self._track_replication(inode)
            if p.get("persistence_state") == PersistenceState.TO_BE_PERSISTED:
                self.to_be_persisted_ids.add(inode.id)
            elif p.get("persistence_state") is not None:
                self.to_be_persisted_ids.discard(inode.id)
            if p.get("persistence_state") == PersistenceState.LOST:
                self.lost_file_ids.add(inode.id)
            elif p.get("persistence_state") is not None:
                self.lost_file_ids.discard(inode.id)
        if p.get("xattr") is not None:
            inode.xattr.update(p["xattr"])
        if p.get("op_time_ms"):
            inode.last_modification_time_ms = p["op_time_ms"]
        self._store.put(inode)

    def _apply_persist(self, p: dict) -> None:
        inode = self._store.get(p["id"])
        if inode is None:
            return
        inode.persistence_state = PersistenceState.PERSISTED
        inode.ufs_fingerprint = p.get("ufs_fingerprint", inode.ufs_fingerprint)
        with self.registry_lock:
            self.to_be_persisted_ids.discard(inode.id)
            self.lost_file_ids.discard(inode.id)
        self._store.put(inode)

    def _track_replication(self, inode: Inode) -> None:
        # callers hold ``registry_lock``
        if not inode.is_directory and (inode.replication_min > 0 or
                                       inode.replication_max >= 0):
            self.replication_limited_ids.add(inode.id)
        else:
            self.replication_limited_ids.discard(inode.id)

    # ---------------------------------------------------------- checkpoint
    def snapshot(self) -> dict:
        # a store with a native checkpoint (LSM: sealed runs + empty WAL)
        # snapshots itself — no inode-by-inode materialization; HEAP /
        # SQLITE keep the original inode-list format byte-for-byte
        store_state = self._store.checkpoint_state()
        if store_state is not None:
            snap = {"root_id": self._root_id, "store_state": store_state}
        else:
            inode_dicts = []
            for iid in self._store.all_ids():
                inode = self._store.get(iid)
                if inode is not None:
                    inode_dicts.append(inode.to_wire_dict())
            snap = {
                "root_id": self._root_id,
                "inodes": inode_dicts,
            }
        if self.invalidation_log is not None:
            # restoring from this checkpoint skips the applied entries
            # it covers, so the version they advanced must ride along —
            # md_version stays a pure function of the applied journal
            snap["invalidation_version"] = self.invalidation_log.version
        return snap

    def restore(self, snap: dict) -> None:
        if self.invalidation_log is not None:
            self.invalidation_log.restore_version(
                snap.get("invalidation_version", 0))
        self._store.clear()
        self.ttl_buckets.clear()
        with self.registry_lock:
            self.pinned_ids.clear()
            self.to_be_persisted_ids.clear()
            self.lost_file_ids.clear()
            self.replication_limited_ids.clear()
            self._inode_count = 0
            self.change_version += 1
        self._root_id = snap.get("root_id")
        if "store_state" in snap:
            # native restore: adopt the run set wholesale, then rebuild
            # the derived side state (ttl buckets, id registries, count)
            # with ONE streaming pass — same bootstrap a replay would
            # produce, minus re-journaling every inode
            try:
                self._store.restore_state(snap["store_state"])
            except NotImplementedError:
                self._restore_cross_kind(snap["store_state"])
                return
            for inode in self._store.iter_inodes():
                self._index_restored(inode)
            return
        for d in snap.get("inodes", []):
            inode = Inode.from_wire_dict(d)
            self._store.put(inode)
            if inode.parent_id != ROOT_ID_PARENT:
                self._store.add_child(inode.parent_id, inode.name, inode.id)
            self._index_restored(inode)

    def _restore_cross_kind(self, store_state: dict) -> None:
        """An LSM-native checkpoint arriving at a master whose own store
        has no native format (HEAP/SQLITE standby behind an LSM primary):
        hydrate through a throwaway LSM reader instead of failing the
        bootstrap."""
        import shutil
        import tempfile

        from alluxio_tpu_torch.master.metastore.lsm import LsmInodeStore

        tmp = tempfile.mkdtemp(prefix="atpu_lsm_restore_")
        try:
            reader = LsmInodeStore(tmp, compaction=False)
            reader.restore_state(store_state)
            for inode in reader.iter_inodes():
                self._store.put(inode)
                if inode.parent_id != ROOT_ID_PARENT:
                    self._store.add_child(inode.parent_id, inode.name,
                                          inode.id)
                self._index_restored(inode)
            reader.close()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _index_restored(self, inode: Inode) -> None:
        if inode.ttl >= 0:
            self.ttl_buckets.insert(inode.id, inode.creation_time_ms,
                                    inode.ttl)
        with self.registry_lock:
            self._inode_count += 1
            if inode.pinned:
                self.pinned_ids.add(inode.id)
            if inode.persistence_state == PersistenceState.TO_BE_PERSISTED:
                self.to_be_persisted_ids.add(inode.id)
            if inode.persistence_state == PersistenceState.LOST:
                self.lost_file_ids.add(inode.id)
            self._track_replication(inode)

    def _empty_snapshot(self) -> dict:
        return {"root_id": None, "inodes": []}
