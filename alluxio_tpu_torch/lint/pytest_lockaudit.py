"""Lock-order auditing for the port's tests and drills.

The port of ``alluxio_tpu/lint/pytest_lockaudit.py``: the port's coarse
master/worker/store locks are instrumented at construction time with
``utils/race.py``'s :class:`LockOrderAuditor`, every test runs with a
fresh auditor, and ANY lock pair observed in both orders — on any
schedule, even one that did not deadlock this run — fails that test
with both acquisition stacks. This is the dynamic complement to the
static ``lock-discipline`` analyzer.

How it reaches a test: ``tests/conftest.py`` names only the JAX plugin,
and a module-level ``pytest_plugins`` would register this one for the
whole session. So the fixtures here have names of their own and every
``tests/test_torch_*.py`` imports them::

    from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
        port_lock_order_audit, port_lockaudit_install,
    )

``port_lockaudit_install`` (module scope, autouse) patches the port's
classes on its first use, before any module fixture of the importing
test file builds a cluster; ``port_lock_order_audit`` (function scope,
autouse) swaps in a fresh auditor for each test and checks it at
teardown. Outside pytest (the card's drill), :func:`install` patches
the classes and :func:`audited` makes an auditor current for a block.

Each test arms ONE port :class:`~alluxio_tpu_torch.utils.race.Watchdog`
(``ATPU_LOCK_AUDIT_WATCHDOG_S``, 240 s by default): a hang dumps every
thread's stack to stderr; the dump is diagnostic only and never fails a
slow test. The JAX plugin, which ``tests/conftest.py`` registers for
the whole session, arms its own around the same test. Both switches are
JAX's own: ``ATPU_LOCK_AUDIT=0`` turns auditing off for the run, and
``@pytest.mark.no_lockaudit`` (registered by the JAX plugin) for one
test. Role children of the process cluster are not audited, as in JAX.

The audited locks (``_INSTRUMENT``), one line each on why:

- ``InodeTree.lock``: the coarse tree lock every namespace call takes
  first.
- ``InodeTree.registry_lock``: the id registries, shared by journal
  applies and snapshot readers.
- ``LocalJournalSystem._lock``: the journal and group-commit lock;
  auditing it proves inode locks -> journal commit lock.
- ``BlockMaster._lock``: the block map, reached from file-master
  calls under inode locks.
- ``BlockMaster._reserve_lock``: container-id reservation, taken from
  journal replay and from block allocation.
- ``FileSystemMaster._persist_mutex``: the persist queue the scheduler
  drains while files complete.
- ``FileSystemMaster._listing_cache_lock``: the listing cache,
  stamped from under the tree's locks.
- ``MetricsStore._lock``: worker and client metric reports.
- ``MetricsHistory._lock`` and ``MetricsHistory._pending_lock``: the
  history store the master's heartbeats sample into.
- ``TieredBlockStore._alloc_lock``: worker space allocation and
  eviction.
- ``BlockLockManager._meta_lock``: the worker's block-lock table.
- ``InodeTree.inode_lock`` and ``InodeTree.edge_lock``: the two
  dynamic stripe pools, one audited name each.
- ``RaftNode.lock`` (added for the port): the Raft state lock the
  embedded journal proposes and applies under; a restarted Raft
  member's replay once hung the port's block master behind it.
- ``JobMaster._lock`` (added for the port): the job master's
  coordinators, which call back into the file and block masters.
- ``FaultTolerantMasterProcess._promote_lock`` (added for the port):
  promotion and demotion, which start and stop every master component.
- ``HbmPageStore._lock`` (added for the port): the device page store
  the loader and the page cache share on the main path.
- ``MemObjectStore._lock``, ``KeystoneSession._lock``,
  ``IndexedSet._lock`` and ``DirectedAcyclicGraph._lock`` (added for the
  port): the in-memory object store the ``mem://`` UFS reads under the
  worker's fetch, Swift's token cache, and the two collections; and,
  outside a constructor (``_STATIC``), the UFS registry's ``_LOCK`` and
  ``MemObjectStore._GLOBAL_LOCK`` (the bucket table).
- ``LogServerProcess._lock``, ``FuseFs._lock``, ``_OpenFile.lock``,
  ``_S3State.lock`` and ``StripeBudget._lock`` (added for the port): the
  serving surfaces' own locks (the log server's file table, the FUSE
  handle table and each open file, the proxy's multipart table) and the
  client's per-tenant stripe budget, which every striped read takes.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import threading
import warnings
from typing import Iterator, List, Optional, Set, Tuple

import pytest

from alluxio_tpu_torch.utils.race import LockOrderAuditor, Watchdog, _LockProxy

ENABLED = os.environ.get("ATPU_LOCK_AUDIT", "1") not in ("0", "false", "")
WATCHDOG_S = float(os.environ.get("ATPU_LOCK_AUDIT_WATCHDOG_S", "240"))


def _entry(module: str, cls_name: str, attr: str) -> Tuple[str, str, str, str]:
    return (module, cls_name, attr, f"{cls_name}.{attr}")


#: (module path, class name, lock attribute, audited lock name); a lock
#: audits under ``<class>.<attribute>``, as in the JAX package's table
_INSTRUMENT: Tuple[Tuple[str, str, str, str], ...] = (
    _entry("alluxio_tpu_torch.master.inode_tree", "InodeTree", "lock"),
    _entry("alluxio_tpu_torch.master.inode_tree", "InodeTree",
           "registry_lock"),
    _entry("alluxio_tpu_torch.journal.system", "LocalJournalSystem",
           "_lock"),
    _entry("alluxio_tpu_torch.master.block_master", "BlockMaster", "_lock"),
    _entry("alluxio_tpu_torch.master.block_master", "BlockMaster",
           "_reserve_lock"),
    _entry("alluxio_tpu_torch.master.file_master", "FileSystemMaster",
           "_persist_mutex"),
    _entry("alluxio_tpu_torch.master.file_master", "FileSystemMaster",
           "_listing_cache_lock"),
    _entry("alluxio_tpu_torch.master.metrics_master", "MetricsStore",
           "_lock"),
    _entry("alluxio_tpu_torch.metrics.history", "MetricsHistory", "_lock"),
    _entry("alluxio_tpu_torch.metrics.history", "MetricsHistory",
           "_pending_lock"),
    _entry("alluxio_tpu_torch.worker.tiered_store", "TieredBlockStore",
           "_alloc_lock"),
    _entry("alluxio_tpu_torch.worker.lock_manager", "BlockLockManager",
           "_meta_lock"),
    _entry("alluxio_tpu_torch.journal.raft", "RaftNode", "lock"),
    _entry("alluxio_tpu_torch.job.master", "JobMaster", "_lock"),
    _entry("alluxio_tpu_torch.master.process", "FaultTolerantMasterProcess",
           "_promote_lock"),
    _entry("alluxio_tpu_torch.client.cache.hbm_store", "HbmPageStore",
           "_lock"),
    _entry("alluxio_tpu_torch.underfs.object_base", "MemObjectStore",
           "_lock"),
    _entry("alluxio_tpu_torch.underfs.swift", "KeystoneSession", "_lock"),
    _entry("alluxio_tpu_torch.utils.collections", "IndexedSet", "_lock"),
    _entry("alluxio_tpu_torch.utils.collections", "DirectedAcyclicGraph",
           "_lock"),
    _entry("alluxio_tpu_torch.logserver.process", "LogServerProcess",
           "_lock"),
    _entry("alluxio_tpu_torch.fuse.fs", "FuseFs", "_lock"),
    _entry("alluxio_tpu_torch.fuse.fs", "_OpenFile", "lock"),
    _entry("alluxio_tpu_torch.proxy.process", "_S3State", "lock"),
    _entry("alluxio_tpu_torch.qos", "StripeBudget", "_lock"),
)

#: (module path, owner inside the module or "", lock attribute, audited
#: name): locks made once, at import, that no constructor sets
_STATIC: Tuple[Tuple[str, str, str, str], ...] = (
    ("alluxio_tpu_torch.underfs.registry", "", "_LOCK", "registry._LOCK"),
    ("alluxio_tpu_torch.underfs.object_base", "MemObjectStore",
     "_GLOBAL_LOCK", "MemObjectStore._GLOBAL_LOCK"),
)

#: the names the two dynamic stripe pools audit under
INODE_LOCK = "InodeTree.inode_lock"
EDGE_LOCK = "InodeTree.edge_lock"


class _AuditorDelegate:
    """The auditor handle baked into every proxy: forwards to whichever
    auditor is current, no-ops when none is. Instances built in one test
    keep auditing correctly in the next — names, not object identities,
    define the order graph. ``names`` collects the lock names acquired
    while the current auditor was active."""

    def __init__(self) -> None:
        self.current: Optional[LockOrderAuditor] = None
        self.names: Set[str] = set()

    def activate(self, auditor: Optional[LockOrderAuditor]) -> None:
        self.names = set()
        self.current = auditor

    def _before_acquire(self, name: str, blocking: bool = True) -> None:
        a = self.current
        if a is not None:
            a._before_acquire(name, blocking=blocking)

    def _acquired(self, name: str, *, record: bool = False) -> None:
        a = self.current
        if a is not None:
            self.names.add(name)
            a._acquired(name, record=record)

    def _abandoned(self, name: str) -> None:
        a = self.current
        if a is not None:
            a._abandoned(name)

    def _released(self, name: str) -> None:
        a = self.current
        if a is not None:
            a._released(name)


_DELEGATE = _AuditorDelegate()
_installed = False
_install_lock = threading.Lock()


def _proxy(inner, name: str) -> _LockProxy:
    return _LockProxy(inner, name, _DELEGATE)


def install() -> None:
    """Patch each target class's ``__init__`` to wrap its lock attribute
    in an audited proxy, and the inode-tree lock pools to wrap every
    fresh stripe lock. Once per process; the delegate decides whether
    events are recorded. Works outside pytest."""
    global _installed
    with _install_lock:
        if _installed:
            return
        patched = {}
        for module_name, cls_name, attr, lock_name in _INSTRUMENT:
            cls = getattr(importlib.import_module(module_name), cls_name)
            patched.setdefault(cls, []).append((attr, lock_name))

        for cls, attrs in patched.items():
            orig_init = cls.__init__

            @functools.wraps(orig_init)
            def init(self, *a, _orig=orig_init, _attrs=tuple(attrs), **kw):
                _orig(self, *a, **kw)
                for attr, lock_name in _attrs:
                    inner = getattr(self, attr, None)
                    if inner is not None and \
                            not isinstance(inner, _LockProxy):
                        setattr(self, attr, _proxy(inner, lock_name))

            cls.__init__ = init

        for module_name, owner_name, attr, lock_name in _STATIC:
            owner = importlib.import_module(module_name)
            if owner_name:
                owner = getattr(owner, owner_name)
            inner = getattr(owner, attr)
            if not isinstance(inner, _LockProxy):
                setattr(owner, attr, _proxy(inner, lock_name))

        # Per-inode striped locks are created DYNAMICALLY by the
        # InodeLockManager pool, so attribute patching cannot reach
        # them; the manager's proxy-factory hook wraps every fresh
        # RWLock, all under ONE name (the root->leaf order within a path
        # is structural; the name puts the stripe set into the
        # cross-plane graph). WRITE_EDGE locks are a second pool with
        # their OWN name, so the graph proves inode locks -> edge locks.
        from alluxio_tpu_torch.master.inode_tree import (
            InodeLockManager, InodeTree,
        )

        mgr_init = InodeLockManager.__init__

        @functools.wraps(mgr_init)
        def lock_mgr_init(self, *a, **kw):
            mgr_init(self, *a, **kw)
            self._proxy_factory = lambda lock: _proxy(lock, INODE_LOCK)

        InodeLockManager.__init__ = lock_mgr_init

        tree_init = InodeTree.__init__

        @functools.wraps(tree_init)
        def inode_tree_init(self, *a, **kw):
            tree_init(self, *a, **kw)
            self.edge_lock_manager._proxy_factory = \
                lambda lock: _proxy(lock, EDGE_LOCK)

        InodeTree.__init__ = inode_tree_init
        _installed = True


@contextlib.contextmanager
def audited() -> Iterator[LockOrderAuditor]:
    """Install, then make a fresh auditor current for the block (the
    previous one is restored after). The caller checks the auditor."""
    install()
    auditor = LockOrderAuditor()
    prev, prev_names = _DELEGATE.current, _DELEGATE.names
    _DELEGATE.activate(auditor)
    try:
        yield auditor
    finally:
        _DELEGATE.current, _DELEGATE.names = prev, prev_names


def acquired_names() -> List[str]:
    """The audited lock names acquired under the current auditor."""
    return sorted(_DELEGATE.names)


def observed_edges() -> List[Tuple[str, str]]:
    """Edges of the current auditor (empty when none is current)."""
    a = _DELEGATE.current
    return sorted(a.edges) if a is not None else []


def pytest_configure(config) -> None:
    """The plugin hook, for a session that registers this module as a
    plugin (``-p alluxio_tpu_torch.lint.pytest_lockaudit``): the
    ``no_lockaudit`` marker, and the port's classes patched."""
    config.addinivalue_line(
        "markers",
        "no_lockaudit: disable lock-order auditing for this test")
    if ENABLED:
        install()


@pytest.fixture(scope="module", autouse=True)
def port_lockaudit_install():
    """Patch the port's classes before the test module's own fixtures
    build anything."""
    if ENABLED:
        install()
    yield


@pytest.fixture(autouse=True)
def port_lock_order_audit(request):
    """A fresh auditor and a watchdog around each test; an inversion
    errors the test at teardown."""
    if not ENABLED or \
            request.node.get_closest_marker("no_lockaudit") is not None:
        yield
        return
    install()
    with audited() as auditor:
        wd = Watchdog(WATCHDOG_S)
        wd.__enter__()
        try:
            yield
        finally:
            # manual exit: the dump is diagnostic only — never turn a
            # slow-but-finishing test into a failure on a stolen-CPU box
            if wd._timer is not None:
                wd._timer.cancel()
    if wd.fired:
        warnings.warn(
            f"port lockaudit watchdog fired after {WATCHDOG_S:.0f}s "
            f"(thread stacks were dumped to stderr)", stacklevel=1)
    # an observed inversion on ANY schedule proves a deadlocking
    # schedule exists
    auditor.assert_clean()
