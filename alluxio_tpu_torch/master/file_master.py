"""FileSystemMaster: the namespace (create/complete/delete/rename/mount/free/
setAttr), TTL, persist scheduling, UFS metadata sync — a copy of
``alluxio_tpu/master/file_master.py``.

Re-design of ``core/server/master/.../file/DefaultFileSystemMaster.java``
(4487 LoC; createFile ``:1463``, completeFile ``:1295``,
getNewBlockIdForFile ``:1538``, delete ``:1621``, rename ``:2174``, mount
``:2736``, free ``:2503``, setAttribute ``:3087``, scheduleAsyncPersistence
``:3209``) composed with the journaled ``InodeTree``, ``MountTable`` and
``BlockMaster``.

Concurrency: hot metadata operations hold the tree lock in READ mode plus
a per-inode lock list along their path (``InodeTree.lock_path`` — read
locks on ancestors, write lock on the terminal), so independent subtrees
no longer serialize; heavyweight multi-phase operations (mount/unmount,
UFS metadata load, commit_persist) still take the tree-level WRITE lock,
which excludes all path-locked operations.  Journal application is the
only state mutator (see ``inode_tree.py`` rationale), and every mutation
appends the affected path to the :class:`MetadataInvalidationLog` that
keeps client metadata caches coherent (docs/metadata.md).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Set

from alluxio_tpu_torch.journal.format import EntryType
from alluxio_tpu_torch.journal.system import JournalSystem
from alluxio_tpu_torch.master.block_master import BlockMaster
from alluxio_tpu_torch.master.inode import (
    Inode, PersistenceState, TtlAction,
)
from alluxio_tpu_torch.master.inode_tree import InodeTree, PathLookup
from alluxio_tpu_torch.master.metastore import InodeStore
from alluxio_tpu_torch.master.mount_table import MountInfo, MountTable, Resolution
from alluxio_tpu_torch.underfs.base import CreateOptions as UfsCreateOptions
from alluxio_tpu_torch.underfs.base import DeleteOptions as UfsDeleteOptions
from alluxio_tpu_torch.underfs.registry import UfsManager
from alluxio_tpu_torch.utils import ids
from alluxio_tpu_torch.utils.clock import Clock, SystemClock
from alluxio_tpu_torch.utils.exceptions import (
    DirectoryNotEmptyError, FileAlreadyCompletedError, FileAlreadyExistsError,
    FileDoesNotExistError, FileIncompleteError, InvalidArgumentError,
    InvalidPathError, NotFoundError, PermissionDeniedError, UnavailableError,
    register_wire_error,
)
from alluxio_tpu_torch.utils.fingerprint import Fingerprint
from alluxio_tpu_torch.utils.uri import AlluxioURI
from alluxio_tpu_torch.utils.wire import (
    BlockInfo, FileBlockInfo, FileInfo, MountPointInfo,
)

LOG = logging.getLogger(__name__)

ROOT_MOUNT_ID = 1
#: fallback for "fast tier" classification before any worker registers
#: its topology (the live answer comes from BlockMaster.top_tiers())
_DEFAULT_DEVICE_TIERS = frozenset(("HBM", "MEM"))
#: rounds of "make the UFS parent dirs, re-check under the tree lock"
#: before an op whose ancestor chain keeps changing gives up
_UFS_DIR_ROUNDS = 3


def _transpose(rows: "List[dict]") -> dict:
    """Row wire-dicts -> struct-of-arrays listing payload. Every row
    comes from ``_file_info_dict`` so the field set is uniform."""
    if not rows:
        return {"n": 0, "cols": {}}
    return {"n": len(rows),
            "cols": {k: [r[k] for r in rows] for k in rows[0]}}


class FileSystemMaster:
    def __init__(self, block_master: BlockMaster, journal: JournalSystem,
                 ufs_manager: Optional[UfsManager] = None,
                 inode_store: Optional[InodeStore] = None,
                 clock: Optional[Clock] = None,
                 default_block_size: int = 64 << 20,
                 permission_checker=None,
                 umask: int = 0o022,
                 ufs_path_cache_capacity: int = 10_000,
                 coarse_locking: bool = False,
                 edge_locking: bool = True) -> None:
        self._block_master = block_master
        self._journal = journal
        self._ufs = ufs_manager or UfsManager()
        self._clock = clock or SystemClock()
        self._default_block_size = default_block_size
        if permission_checker is None:
            from alluxio_tpu_torch.security.authorization import PermissionChecker
            from alluxio_tpu_torch.security.user import get_os_user

            # the process user is the superuser (reference: the master's
            # login user bypasses permission checks)
            permission_checker = PermissionChecker(superuser=get_os_user())
        self._perm = permission_checker
        self._umask = umask
        self.inode_tree = InodeTree(inode_store,
                                    coarse_locking=coarse_locking,
                                    edge_locking=edge_locking)
        self.mount_table = MountTable()
        from alluxio_tpu_torch.master.invalidation import MetadataInvalidationLog

        #: versioned push-invalidation log for client metadata caches;
        #: GetStatus/ListStatus stamps and the metrics-heartbeat
        #: piggyback both read it (docs/metadata.md).  Fed from the
        #: JOURNAL APPLY path (inode-tree + mount-table sinks below),
        #: never from the RPC methods, so a tailing standby counts the
        #: exact md_version sequence the primary stamps and standby-
        #: served reads stay inside the cache coherence contract
        #: (docs/ha.md).
        self.invalidations = MetadataInvalidationLog()
        self.inode_tree.invalidation_sink = self.invalidations.append
        # the tree also carries the log's version through checkpoint
        # snapshot/restore: a bootstrap-from-checkpoint must not restart
        # the count the skipped entries already advanced
        self.inode_tree.invalidation_log = self.invalidations
        journal.register(self.inode_tree)
        journal.register(_MountTableJournal(
            self.mount_table, invalidation_sink=self.invalidations.append))
        #: inode ids with async persist requested; added to and drained
        #: under ``_persist_lock`` only, so no id lands between the
        #: drain's copy and its clear
        self._persist_requests: "set[int]" = set()
        self._persist_lock = threading.Lock()
        # serializes persist commits' UFS IO (see commit_persist)
        self._persist_mutex = threading.Lock()
        from alluxio_tpu_torch.master.sync import AbsentPathCache, UfsSyncPathCache

        #: last-sync bookkeeping (reference: UfsSyncPathCache)
        self._sync_cache = UfsSyncPathCache()
        #: UFS paths known absent (reference: AsyncUfsAbsentPathCache)
        self._absent_cache = AbsentPathCache(
            max_size=max(1, ufs_path_cache_capacity))
        #: dir inode id -> (tree_version, location_version, wire dicts).
        #: Directory listing is the #1 metadata op for training-data
        #: discovery and re-lists the same (unchanged) dirs constantly;
        #: entries are valid while BOTH coarse versions stand — every
        #: namespace mutation takes the tree write lock (bumping
        #: ``RWLock.version``) and every residency change bumps
        #: ``BlockMaster.location_version`` (reference streams ListStatus
        #: partials instead, ``file_system_master.proto:475-590``; a
        #: version-guarded server cache is the cheaper design when the
        #: whole tree sits in one process)
        self._listing_cache: Dict[int, tuple] = {}
        self._listing_cache_lock = threading.Lock()

    # -------------------------------------------------------------- startup
    def start(self, root_ufs_uri: Optional[str] = None,
              root_ufs_properties: Optional[Dict[str, str]] = None) -> None:
        """Create the root inode + root mount on first boot."""
        with self.inode_tree.lock.write_locked():
            if self.inode_tree.root is None:
                now = self._clock.millis()
                cid = self._block_master.new_container_id()
                from alluxio_tpu_torch.security.user import get_os_user

                # root is owned by the master's login user (reference:
                # InodeTree.initializeRoot uses the server login user)
                root = Inode.new_directory(
                    ids.file_id_from_container(cid), -1, "", mode=0o755,
                    owner=get_os_user(), now_ms=now)
                root.persistence_state = PersistenceState.PERSISTED
                with self._journal.create_context() as ctx:
                    ctx.append(EntryType.INODE_DIRECTORY, root.to_wire_dict())
                    if root_ufs_uri:
                        ctx.append(EntryType.ADD_MOUNT_POINT, MountInfo(
                            ROOT_MOUNT_ID, "/", root_ufs_uri, False, False,
                            root_ufs_properties or {}).to_wire())
            # (re)wire UFS instances for every mount (also after replay)
            for info in self.mount_table.mount_points():
                if not self._ufs.has(info.mount_id):
                    self._ufs.add_mount(info.mount_id, info.ufs_uri,
                                        info.properties)

    def stop(self) -> None:
        self._ufs.close()
        # disk-backed metastores own background work (LSM compactor,
        # sqlite connection) that must not outlive the master
        self.inode_tree._store.close()

    # ------------------------------------------------------------ factories
    @property
    def ufs_manager(self) -> UfsManager:
        return self._ufs

    def _now(self) -> int:
        return self._clock.millis()

    # ---------------------------------------------------------- permissions
    def _auth_user(self):
        from alluxio_tpu_torch.security.user import authenticated_user

        return authenticated_user()

    def _check_access(self, lookup: PathLookup, bits: int) -> None:
        """traverse + ``bits`` on the target inode."""
        user = self._auth_user()
        self._perm.check_traverse(user, lookup.inodes[:-1])
        self._perm.check(user, lookup.inode, bits, path=lookup.uri.path)

    def _check_parent_write(self, lookup: PathLookup) -> None:
        """traverse + WRITE on the deepest existing ancestor (create) or
        the parent (delete/rename)."""
        from alluxio_tpu_torch.security.authorization import WRITE

        user = self._auth_user()
        self._perm.check_traverse(user, lookup.inodes[:-1])
        self._perm.check(user, lookup.deepest, WRITE, path=lookup.uri.path)

    def _check_delete(self, lookup: PathLookup) -> None:
        """traverse + WRITE on the parent of an existing target."""
        from alluxio_tpu_torch.security.authorization import WRITE

        user = self._auth_user()
        self._perm.check_traverse(user, lookup.inodes[:-2])
        if len(lookup.inodes) >= 2:
            self._perm.check(user, lookup.inodes[-2], WRITE,
                             path=lookup.uri.path)

    def _fill_owner(self, owner: str, group: str) -> "tuple[str, str]":
        """Create-time defaults from the authenticated user
        (reference: inodes inherit the RPC caller's identity)."""
        user = self._auth_user()
        if user is not None:
            owner = owner or user.name
            group = group or (user.groups[0] if user.groups else user.name)
        return owner, group

    def _inherit_default_acl(self, parent: Inode, inode: Inode) -> None:
        """A directory's default ACL becomes new children's access ACL
        (and stays the default on child directories) — reference:
        DefaultAccessControlList inheritance."""
        default = parent.xattr.get(self.DEFAULT_ACL_XATTR, "")
        if not default:
            return
        inode.xattr = dict(inode.xattr)
        inode.xattr[self.ACL_XATTR] = default
        if inode.is_directory:
            inode.xattr[self.DEFAULT_ACL_XATTR] = default

    # ---------------------------------------------------------------- reads
    def get_status(self, path: "str | AlluxioURI",
                   sync_interval_ms: int = -1) -> FileInfo:
        uri = AlluxioURI(path)
        self._maybe_sync(uri, sync_interval_ms)
        with self.inode_tree.lock_path(uri) as lip:
            lookup = lip.lookup
            # POSIX stat semantics: EXECUTE on every ancestor (no READ on
            # the target itself) — without this, stat leaks metadata of
            # paths under 0700 directories
            self._perm.check_traverse(self._auth_user(),
                                      lookup.inodes[:-1] if lookup.exists
                                      else lookup.inodes)
            if not lookup.exists:
                loaded = None
            else:
                return self._file_info(lookup.inode, uri)
        # path absent: try loading metadata from UFS (on-access sync)
        loaded = self._load_metadata_if_exists(uri)
        if loaded is None:
            raise FileDoesNotExistError(f"path {uri} does not exist")
        return loaded

    def exists(self, path: "str | AlluxioURI") -> bool:
        try:
            self.get_status(path)
            return True
        except FileDoesNotExistError:
            return False

    def list_status(self, path: "str | AlluxioURI", *, recursive: bool = False,
                    load_direct_children: bool = True,
                    sync_interval_ms: int = -1,
                    wire: bool = False,
                    columnar: bool = False) -> "List[FileInfo] | dict":
        """``wire=True``: entries are returned as wire DICTS (what the
        RPC handler ships) — N dataclass constructions skipped.
        ``columnar=True`` (implies wire, non-recursive only): the listing
        comes back struct-of-arrays, ``{"n": N, "cols": {field: [N
        values]}}`` — one msgpack map of 30 arrays instead of N 30-key
        maps, cutting encode+decode cost ~in half at listing fan-out
        (the reference streams ListStatus partials instead,
        ``file_system_master.proto:475-590``). Transposed once per
        directory version and memoized in the listing cache."""
        uri = AlluxioURI(path)
        wire = wire or columnar
        synced = self._maybe_sync(uri, sync_interval_ms)
        status = self.get_status(uri)  # loads the inode itself if needed
        if not status.folder:
            if columnar:
                return _transpose([status.to_wire()])
            return [status.to_wire()] if wire else [status]
        if load_direct_children:
            self._load_children_if_needed(uri, force=synced)
            if recursive:
                # DescendantType.ALL semantics (reference
                # ``InodeSyncStream``): a recursive listing must surface
                # UNLOADED UFS subtrees too — walk each directory's
                # children before the locked emit (UFS IO cannot run
                # under the tree lock). The child inode's
                # ``direct_children_loaded`` flag is read in the same
                # lock pass as the traversal, so a warm subtree costs
                # one lookup per directory and zero load calls.
                queue = [uri]
                while queue:
                    d = queue.pop()
                    with self.inode_tree.lock.read_locked():
                        lk = self.inode_tree.lookup(d)
                        if not lk.exists or not lk.inode.is_directory:
                            continue
                        subdirs = [(c.name, c.direct_children_loaded)
                                   for c in
                                   self.inode_tree.children(lk.inode)
                                   if c.is_directory]
                    for name, loaded in subdirs:
                        child = d.join(name)
                        if synced or not loaded:
                            self._load_children_if_needed(child,
                                                          force=synced)
                        queue.append(child)
        info = self._file_info_dict if wire else self._file_info
        out: List[FileInfo] = []
        with self.inode_tree.lock_path(uri) as lip:
            lookup = lip.lookup
            if not lookup.exists:
                raise FileDoesNotExistError(f"path {uri} does not exist")
            from alluxio_tpu_torch.security.authorization import READ

            self._check_access(lookup, READ)
            if wire and not recursive:
                # per-caller access check done above; the emitted child
                # entries themselves are caller-independent.  The cache
                # stamp is the namespace-wide change_version: with
                # striped locking the tree lock's own version no longer
                # sees path-locked mutations, but every mutation still
                # bumps change_version at journal-apply time.
                dir_id = lookup.inode.id
                tree_ver = self.inode_tree.change_version
                loc_ver = self._block_master.location_version
                hit = self._listing_cache.get(dir_id)
                if hit is not None and hit[0] == tree_ver and \
                        hit[1] == loc_ver:
                    if not columnar:
                        return hit[2]
                    if hit[3] is None:
                        hit = hit[:3] + (_transpose(hit[2]),)
                        with self._listing_cache_lock:
                            self._listing_cache[dir_id] = hit
                    return hit[3]

            def emit(dir_inode: Inode, dir_uri: AlluxioURI) -> None:
                # resolve the directory's mount ONCE; children extend it
                # by name. Only a child that is itself a mount point (a
                # nested mount lands exactly one level down) needs its
                # own resolution — the rest skip the per-child mount
                # walk + URI construction that dominated listing CPU.
                try:
                    dres = self.mount_table.resolve(dir_uri)
                    d_ufs = dres.ufs_path.rstrip("/")
                    d_mount = dres.mount_id
                except (NotFoundError, InvalidPathError):
                    d_ufs, d_mount = "", 0  # unmounted region
                d_path = dir_uri.path if dir_uri.path != "/" else ""
                for child in self.inode_tree.children(dir_inode):
                    child_path = f"{d_path}/{child.name}"
                    if self.mount_table.is_mount_path(child_path):
                        child_uri = dir_uri.join(child.name)
                        out.append(info(child, child_uri))
                    else:
                        mount = (f"{d_ufs}/{child.name}" if d_ufs else "",
                                 d_mount)
                        out.append(info(child, child_path, mount=mount))
                    if recursive and child.is_directory:
                        emit(child, dir_uri.join(child.name))

            emit(lookup.inode, uri)
            if wire and not recursive and \
                    self.inode_tree.change_version == tree_ver and \
                    self._block_master.location_version == loc_ver:
                # a mutation anywhere (version moved) or a location
                # change mid-emit makes this listing uncacheable —
                # serve it, but don't memoize a potentially torn view
                cols = _transpose(out) if columnar else None
                with self._listing_cache_lock:
                    # multiple listing threads share the tree READ lock;
                    # dict iteration for eviction needs its own mutex
                    if len(self._listing_cache) >= 1024:
                        self._listing_cache.pop(
                            next(iter(self._listing_cache)), None)
                    self._listing_cache[lookup.inode.id] = (
                        tree_ver, loc_ver, out, cols)
                if columnar:
                    return cols
        return _transpose(out) if columnar else out

    def list_status_page(self, path: "str | AlluxioURI", *,
                         start_after: Optional[str] = None,
                         limit: int = 500) -> dict:
        """One PAGE of a directory listing: up to ``limit`` children in
        name order strictly after ``start_after``, as wire dicts, plus
        the resume cursor.  Each page takes (and drops) its own path
        lock and streams straight off the store's ``iter_edges`` range
        scan — a million-entry LSM directory is never materialized in
        master memory, which is what the streamed-listing RPC rides for
        big directories.  Pages compose a weakly-consistent listing
        (entries created/deleted between pages may or may not appear —
        same contract as the reference's partial ListStatus); each page
        carries ``md_version`` so clients can detect drift."""
        uri = AlluxioURI(path)
        limit = max(1, limit)
        with self.inode_tree.lock_path(uri) as lip:
            lookup = lip.lookup
            if not lookup.exists:
                raise FileDoesNotExistError(f"path {uri} does not exist")
            from alluxio_tpu_torch.security.authorization import READ

            self._check_access(lookup, READ)
            inode = lookup.inode
            if not inode.is_directory:
                entry = [] if start_after else \
                    [self._file_info_dict(inode, uri)]
                return {"infos": entry, "next": None,
                        "md_version": self.invalidations.version}
            try:
                dres = self.mount_table.resolve(uri)
                d_ufs = dres.ufs_path.rstrip("/")
                d_mount = dres.mount_id
            except (NotFoundError, InvalidPathError):
                d_ufs, d_mount = "", 0
            d_path = uri.path if uri.path != "/" else ""
            infos: List[dict] = []
            last_name: Optional[str] = None
            for child in self.inode_tree.children(inode,
                                                  start_after=start_after):
                child_path = f"{d_path}/{child.name}"
                if self.mount_table.is_mount_path(child_path):
                    infos.append(self._file_info_dict(
                        child, uri.join(child.name)))
                else:
                    mount = (f"{d_ufs}/{child.name}" if d_ufs else "",
                             d_mount)
                    infos.append(self._file_info_dict(
                        child, child_path, mount=mount))
                last_name = child.name
                if len(infos) >= limit:
                    break
            return {"infos": infos,
                    "next": last_name if len(infos) >= limit else None,
                    "md_version": self.invalidations.version}

    def metastore_stats(self) -> dict:
        """The inode store's own counters (kind, memtable/run/compaction
        gauges, cache hit ratio) — fsadmin report, the status page and
        the ``Master.Metastore*`` metrics all read this."""
        return self.inode_tree._store.stats()

    def get_file_block_info_list(self, path: "str | AlluxioURI") -> List[FileBlockInfo]:
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri) as lip:
            lookup = lip.lookup
            inode = lookup.inode
            from alluxio_tpu_torch.security.authorization import READ

            self._check_access(lookup, READ)
            if inode.is_directory:
                raise InvalidArgumentError(f"{uri} is a directory")
            return self._file_block_infos(inode)

    def _file_block_infos(self, inode: Inode) -> List[FileBlockInfo]:
        infos = self._block_master.get_block_infos(inode.block_ids)
        by_id = {b.block_id: b for b in infos}
        out = []
        for i, bid in enumerate(inode.block_ids):
            bi = by_id.get(bid, BlockInfo(block_id=bid, length=0))
            out.append(FileBlockInfo(block_info=bi,
                                     offset=i * inode.block_size_bytes))
        return out

    def _file_info(self, inode: Inode, uri: "AlluxioURI | str",
                   mount: Optional[tuple] = None) -> FileInfo:
        return FileInfo.from_wire(self._file_info_dict(inode, uri, mount))

    def _file_info_dict(self, inode: Inode, uri: "AlluxioURI | str",
                        mount: Optional[tuple] = None) -> dict:
        """FileInfo in WIRE-DICT form — the RPC handlers ship this
        straight into msgpack without materializing a FileInfo (a
        listing of N entries skips N dataclass constructions + N
        ``to_wire`` copies; in-process callers get objects via
        ``_file_info``). ``mount``: precomputed ``(ufs_path, mount_id)``
        from a listing loop that resolved the parent once (the child
        then cannot be a mount point — the caller checked); ``uri`` may
        then be a plain path string, skipping per-child URI
        construction."""
        in_mem = 0
        fbi: List[FileBlockInfo] = []
        if not inode.is_directory and inode.block_ids:
            fbi = self._file_block_infos(inode)
            fast = self._block_master.top_tiers() or \
                _DEFAULT_DEVICE_TIERS
            mem_bytes = 0
            for f in fbi:
                if any(loc.tier_alias in fast
                       for loc in f.block_info.locations):
                    mem_bytes += f.block_info.length
            in_mem = int(100 * mem_bytes / inode.length) if inode.length else (
                100 if fbi else 0)
        if mount is not None:
            ufs_path, mount_id = mount
            is_mp = False
            path = uri if isinstance(uri, str) else uri.path
        else:
            if isinstance(uri, str):
                uri = AlluxioURI(uri)
            path = uri.path
            try:
                resolution = self.mount_table.resolve(uri)
                ufs_path = resolution.ufs_path
                mount_id = resolution.mount_id
            except (NotFoundError, InvalidPathError):
                ufs_path, mount_id = "", 0  # unmounted: no UFS path
            is_mp = self.mount_table.is_mount_point(uri)
        return {
            "file_id": inode.id, "name": inode.name or "/", "path": path,
            "ufs_path": ufs_path, "length": inode.length,
            "block_size_bytes": inode.block_size_bytes,
            "creation_time_ms": inode.creation_time_ms,
            "last_modification_time_ms": inode.last_modification_time_ms,
            "last_access_time_ms": inode.last_access_time_ms,
            "completed": inode.completed or inode.is_directory,
            "folder": inode.is_directory, "pinned": inode.pinned,
            "pinned_media": list(inode.pinned_media),
            "cacheable": inode.cacheable,
            "persisted":
                inode.persistence_state == PersistenceState.PERSISTED,
            "persistence_state": inode.persistence_state,
            "block_ids": list(inode.block_ids),
            "in_memory_percentage": in_mem,
            "ttl": inode.ttl, "ttl_action": inode.ttl_action,
            "owner": inode.owner, "group": inode.group, "mode": inode.mode,
            "mount_point": is_mp, "mount_id": mount_id,
            "replication_min": inode.replication_min,
            "replication_max": inode.replication_max,
            "file_block_infos": [f.to_wire() for f in fbi],
            "xattr": dict(inode.xattr)}

    # --------------------------------------------------------------- create
    def create_file(self, path: "str | AlluxioURI", *,
                    block_size_bytes: Optional[int] = None,
                    recursive: bool = True, ttl: int = -1,
                    ttl_action: str = TtlAction.DELETE,
                    mode: Optional[int] = None,
                    owner: str = "", group: str = "",
                    replication_min: int = 0, replication_max: int = -1,
                    cacheable: bool = True,
                    persist_on_complete: bool = False,
                    overwrite: bool = False) -> FileInfo:
        """Reference: ``DefaultFileSystemMaster.createFile:1463``.
        ``overwrite=True`` atomically replaces an existing FILE (delete +
        create under one tree write lock — the POSIX/fsspec 'wb'
        truncate contract, server-side so no client delete/create race);
        an existing directory still raises."""
        uri = AlluxioURI(path)
        if uri.is_root():
            raise InvalidPathError("cannot create root")
        self._check_reserved_name(uri)
        block_size = block_size_bytes or self._default_block_size
        # overwrite also write-locks the PARENT: the replace must stay
        # atomic across the inner delete (which unlinks the terminal
        # whose lock would otherwise be our only exclusion)
        with self.inode_tree.lock_path(uri, write=True,
                                       write_parent=overwrite) as lip:
            lookup = lip.lookup
            if lookup.exists and overwrite and not \
                    lookup.inode.is_directory:
                # atomic replace under the HELD parent+terminal write
                # locks (no nested lock_path — the canonical order
                # audit would flag re-entering the tree lock)
                self._delete_locked(uri, lookup)
                lookup = self.inode_tree.lookup(uri)
            if lookup.exists:
                raise FileAlreadyExistsError(f"{uri} already exists")
            self._check_parent_write(lookup)
            owner, group = self._fill_owner(owner, group)
            # umask shapes the DEFAULT mode only; explicit modes are kept
            # (reference: ModeUtils.applyFileUMask on option defaults)
            mode = (0o666 & ~self._umask) if mode is None else mode
            parents = self._prepare_parents(lookup, recursive)
            now = self._now()
            cid = self._block_master.new_container_id()
            inode = Inode.new_file(
                cid, 0, uri.name, block_size_bytes=block_size, owner=owner,
                group=group, mode=mode, ttl=ttl, ttl_action=ttl_action,
                replication_min=replication_min,
                replication_max=replication_max, now_ms=now)
            inode.cacheable = cacheable
            if persist_on_complete:
                inode.persistence_state = PersistenceState.TO_BE_PERSISTED
            with self._journal.create_context() as ctx:
                prev = lookup.deepest
                for p in parents:
                    p.parent_id = prev.id
                    # intermediate dirs inherit identity + default ACL so
                    # children created under them later inherit correctly
                    p.owner, p.group = owner, group
                    p.mode = 0o777 & ~self._umask
                    self._inherit_default_acl(prev, p)
                    ctx.append(EntryType.INODE_DIRECTORY, p.to_wire_dict())
                    prev = p
                inode.parent_id = prev.id
                self._inherit_default_acl(prev, inode)
                ctx.append(EntryType.INODE_FILE, inode.to_wire_dict())
            self._absent_cache.remove(uri.path)
            return self._file_info(self.inode_tree.get_inode(inode.id), uri)

    def create_directory(self, path: "str | AlluxioURI", *,
                         recursive: bool = True, allow_exists: bool = False,
                         mode: Optional[int] = None,
                         owner: str = "", group: str = "",
                         persisted: bool = False) -> FileInfo:
        uri = AlluxioURI(path)
        if uri.is_root():
            raise InvalidPathError("cannot create root")
        self._check_reserved_name(uri)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            lookup = lip.lookup
            if lookup.exists:
                if allow_exists and lookup.inode.is_directory:
                    return self._file_info(lookup.inode, uri)
                raise FileAlreadyExistsError(f"{uri} already exists")
            self._check_parent_write(lookup)
            owner, group = self._fill_owner(owner, group)
            mode = (0o777 & ~self._umask) if mode is None else mode
            parents = self._prepare_parents(lookup, recursive)
            now = self._now()
            cid = self._block_master.new_container_id()
            inode = Inode.new_directory(
                ids.file_id_from_container(cid), 0, uri.name, owner=owner,
                group=group, mode=mode, now_ms=now)
            if persisted:
                inode.persistence_state = PersistenceState.PERSISTED
            with self._journal.create_context() as ctx:
                prev = lookup.deepest
                for p in parents:
                    p.parent_id = prev.id
                    # intermediate dirs inherit identity + default ACL so
                    # children created under them later inherit correctly
                    p.owner, p.group = owner, group
                    p.mode = 0o777 & ~self._umask
                    self._inherit_default_acl(prev, p)
                    ctx.append(EntryType.INODE_DIRECTORY, p.to_wire_dict())
                    prev = p
                inode.parent_id = prev.id
                self._inherit_default_acl(prev, inode)
                ctx.append(EntryType.INODE_DIRECTORY, inode.to_wire_dict())
            self._absent_cache.remove(uri.path)
            return self._file_info(self.inode_tree.get_inode(inode.id), uri)

    def _prepare_parents(self, lookup: PathLookup,
                         recursive: bool) -> List[Inode]:
        """Build inodes for missing intermediate directories (ids assigned,
        parent ids patched at journal time)."""
        missing = lookup.missing_components[:-1]
        if missing and not recursive:
            raise FileDoesNotExistError(
                f"parent of {lookup.uri} does not exist (non-recursive)")
        if not lookup.deepest.is_directory:
            raise InvalidPathError(
                f"ancestor {lookup.deepest.name!r} of {lookup.uri} is a file")
        out: List[Inode] = []
        now = self._now()
        for name in missing:
            cid = self._block_master.new_container_id()
            d = Inode.new_directory(ids.file_id_from_container(cid), 0, name,
                                    now_ms=now)
            # inherit persistence from the fact the parent chain is persisted
            out.append(d)
        return out

    # --------------------------------------------------------------- blocks
    def get_new_block_id_for_file(self, path: "str | AlluxioURI") -> int:
        """Reference: ``getNewBlockIdForFile:1538``."""
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            from alluxio_tpu_torch.security.authorization import WRITE

            self._check_access(lip.lookup, WRITE)
            inode = self._existing_inode(lip.lookup, uri)
            if inode.completed:
                raise FileAlreadyCompletedError(f"{uri} is completed")
            bid = inode.next_block_id()
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.NEW_BLOCK,
                           {"file_id": inode.id, "block_id": bid})
            return bid

    def complete_file(self, path: "str | AlluxioURI", *,
                      length: Optional[int] = None,
                      ufs_fingerprint: str = "") -> None:
        """Reference: ``completeFile:1295``.

        Striped fast path: the terminal's write lock suffices while the
        parent chain is already PERSISTED (steady state).  When a
        fingerprinted complete must also flip unpersisted ANCESTOR
        directories — inodes this path list only read-holds — it falls
        back to the exclusive tree lock (rare: first persist under a
        fresh directory).  Phase 2 re-derives EVERYTHING — access check,
        target inode, length, ancestor chain — because nothing captured
        under the released phase-1 locks is trustworthy (the same rule
        ``mark_persisted``/``rename`` follow for their fallbacks)."""
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            plan = self._complete_locked(uri, lip.lookup, length,
                                         ufs_fingerprint)
        if plan:
            self._journal_after_ufs_dirs(
                plan, lambda made: self._complete_locked(
                    uri, self.inode_tree.lookup(uri), length,
                    ufs_fingerprint, made=made))

    def _complete_locked(self, uri: AlluxioURI, lookup: PathLookup,
                         length: "Optional[int]", ufs_fingerprint: str, *,
                         made: "Set[tuple]" = frozenset()) -> "List[tuple]":
        """Validate + journal a complete under the caller's locks, or
        journal nothing and return the UFS directories (not in
        ``made``, the ones already made) that its unpersisted ancestors
        still need: flipping those takes the exclusive tree lock, and
        their directories are made first, with no lock held."""
        from alluxio_tpu_torch.security.authorization import WRITE

        self._check_access(lookup, WRITE)
        inode = self._existing_inode(lookup, uri)
        if inode.completed:
            raise FileAlreadyCompletedError(f"{uri} already completed")
        if length is None:
            infos = self._block_master.get_block_infos(inode.block_ids)
            length = sum(b.length for b in infos)
        anc = self._unpersisted_chain(
            self.inode_tree.parent_of(inode), uri) if ufs_fingerprint else []
        # breadcrumbs come BEFORE the durable flip: a crash after the
        # journal fsync must not leave PERSISTED dirs that exist only as
        # implicit object prefixes
        missing = self._ufs_dir_plan(anc, made)
        if missing:
            return missing
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.COMPLETE_FILE, {
                "file_id": inode.id, "length": length,
                "op_time_ms": self._now()})
            if ufs_fingerprint:
                self._journal_persisted(ctx, inode, ufs_fingerprint,
                                        ancestors=anc)
        if inode.persistence_state == PersistenceState.TO_BE_PERSISTED:
            self._request_persist(inode.id)
        return []

    def _existing_file(self, uri: AlluxioURI) -> Inode:
        return self._existing_inode(self.inode_tree.lookup(uri), uri)

    @staticmethod
    def _existing_inode(lookup: PathLookup, uri: AlluxioURI) -> Inode:
        inode = lookup.inode
        if inode.is_directory:
            raise InvalidPathError(f"{uri} is a directory")
        return inode

    # --------------------------------------------------------------- delete
    def delete(self, path: "str | AlluxioURI", *, recursive: bool = False,
               alluxio_only: bool = False) -> None:
        """Reference: ``delete:1621``. Removes inodes bottom-up, drops block
        metadata, and (unless ``alluxio_only``) deletes in the UFS."""
        uri = AlluxioURI(path)
        if uri.is_root():
            raise InvalidPathError("cannot delete root")
        with self.inode_tree.lock_path(uri, write=True) as lip:
            self._delete_locked(uri, lip.lookup, recursive=recursive,
                                alluxio_only=alluxio_only)

    def _delete_locked(self, uri: AlluxioURI, lookup: PathLookup, *,
                       recursive: bool = False,
                       alluxio_only: bool = False) -> None:
        """Delete under the caller's locks (terminal write-held):
        ``delete`` proper and ``create_file(overwrite=True)``'s atomic
        replace both land here."""
        inode = lookup.inode
        self._check_delete(lookup)
        if self.mount_table.is_mount_point(uri):
            raise InvalidPathError(
                f"{uri} is a mount point; unmount it instead")
        victims: List[Inode] = []
        if inode.is_directory:
            # emptiness probe, not a materialized name list — a
            # millions-wide directory answers from its first edge
            if not recursive and self.inode_tree.has_children(inode):
                raise DirectoryNotEmptyError(
                    f"{uri} is non-empty; need recursive")
            if self.mount_table.contains_mount_below(uri):
                raise InvalidPathError(
                    f"{uri} contains nested mount points")
            victims.extend(self.inode_tree.descendants(inode))
        victims.append(inode)
        block_ids: List[int] = []
        persisted_paths: List[Inode] = []
        for v in victims:
            block_ids.extend(v.block_ids)
            if v.persistence_state == PersistenceState.PERSISTED:
                persisted_paths.append(v)
        if not alluxio_only and persisted_paths:
            # fail fast BEFORE journaling: a read-only mount must leave
            # both Alluxio and UFS state untouched
            self._check_ufs_writable(uri)
        now = self._now()
        with self._journal.create_context() as ctx:
            for v in victims:
                payload = {"id": v.id, "op_time_ms": now}
                if v is not inode:
                    # the delete ROOT's entry invalidates the whole
                    # subtree by client-side prefix semantics; marking
                    # descendants "covered" keeps a recursive delete
                    # from flooding the bounded invalidation ring into
                    # a cluster-wide cache reset
                    payload["covered"] = True
                ctx.append(EntryType.DELETE_FILE, payload)
        if block_ids:
            self._block_master.remove_blocks(block_ids,
                                             delete_metadata=True)
        if not alluxio_only and persisted_paths:
            self._delete_in_ufs(uri, persisted_paths)

    def _check_reserved_name(self, uri: AlluxioURI) -> None:
        """Framework temp prefixes are reserved: a user file named like
        one would be hidden from metadata sync and swept from the UFS by
        the UfsCleaner after the TTL — silent data loss."""
        from alluxio_tpu_torch.master.integrity import is_infra_temp

        if is_infra_temp(uri.name):
            raise InvalidPathError(
                f"{uri.name!r} uses a reserved framework temp prefix")

    def _check_ufs_writable(self, uri: AlluxioURI) -> None:
        try:
            resolution = self.mount_table.resolve(uri)
        except (NotFoundError, InvalidPathError):
            return
        if resolution.mount_info.read_only:
            raise PermissionDeniedError(
                f"mount {resolution.mount_info.alluxio_path} is read-only")

    def _delete_in_ufs(self, base_uri: AlluxioURI, inodes: List[Inode]) -> None:
        try:
            resolution = self.mount_table.resolve(base_uri)
        except (NotFoundError, InvalidPathError):
            return
        ufs = self._ufs.get(resolution.mount_id)
        # deepest-first ufs delete; base last
        if len(inodes) == 1 and not inodes[0].is_directory:
            ufs.delete_file(resolution.ufs_path)
        else:
            ufs.delete_directory(resolution.ufs_path,
                                 UfsDeleteOptions(recursive=True))

    # --------------------------------------------------------------- rename
    def rename(self, src: "str | AlluxioURI", dst: "str | AlluxioURI") -> None:
        """Reference: ``rename:2174``.

        Striped fast path: two per-inode lock lists acquired in
        lexicographic path order (see ``InodeTree.lock_path_pair``) —
        write on the src terminal, write on dst's deepest existing inode
        (the parent gaining the edge).  When the rename must also flip
        unpersisted ancestors ABOVE dst's parent to PERSISTED (inodes
        the lists only read-hold), it falls back to the exclusive tree
        lock — rare: persisted file renamed under a fresh dir chain."""
        src_uri, dst_uri = AlluxioURI(src), AlluxioURI(dst)
        if src_uri.is_root() or dst_uri.is_root():
            raise InvalidPathError("cannot rename to/from root")
        if src_uri.is_ancestor_of(dst_uri):
            raise InvalidPathError(f"cannot rename {src_uri} under itself")
        self._check_reserved_name(dst_uri)
        with self.inode_tree.lock_path_pair(src_uri, dst_uri) as (
                src_lip, dst_lip):
            plan = self._rename_locked(src_uri, dst_uri, src_lip.lookup,
                                       dst_lip.lookup)
        if plan:
            self._journal_after_ufs_dirs(
                plan, lambda made: self._rename_locked(
                    src_uri, dst_uri, self.inode_tree.lookup(src_uri),
                    self.inode_tree.lookup(dst_uri), made=made))

    def _rename_locked(self, src_uri: AlluxioURI, dst_uri: AlluxioURI,
                       src_lookup: PathLookup, dst_lookup: PathLookup, *,
                       made: "Set[tuple]" = frozenset()) -> "List[tuple]":
        """Validate + journal a rename under the caller's locks, or
        journal nothing and return the UFS directories (not in
        ``made``) that dst's unpersisted ancestors still need when the
        op must flip them to PERSISTED: the flip takes the exclusive
        tree lock, and the directories are made first with no lock
        held."""
        inode = src_lookup.inode
        self._check_delete(src_lookup)
        if self.mount_table.is_mount_point(src_uri):
            raise InvalidPathError(f"{src_uri} is a mount point")
        # cross-mount renames are unsupported (reference behavior)
        src_mp = self.mount_table.get_mount_point(src_uri)
        dst_mp = self.mount_table.get_mount_point(dst_uri)
        if src_mp != dst_mp:
            raise InvalidPathError("rename across mount points")
        if dst_lookup.exists:
            raise FileAlreadyExistsError(f"{dst_uri} already exists")
        self._check_parent_write(dst_lookup)
        if len(dst_lookup.missing_components) > 1:
            raise FileDoesNotExistError(
                f"parent of {dst_uri} does not exist")
        new_parent = dst_lookup.deepest
        if not new_parent.is_directory:
            raise InvalidPathError(f"parent of {dst_uri} is a file")
        now = self._now()
        persisted = inode.persistence_state == PersistenceState.PERSISTED
        if persisted:
            self._check_ufs_writable(src_uri)
        dst_anc = self._unpersisted_chain(new_parent, dst_uri) \
            if persisted else []
        missing = self._ufs_dir_plan(dst_anc, made)
        if missing:
            return missing
        # the UFS rename will implicitly create dst's parent chain;
        # those inodes flip PERSISTED in the SAME journal context as the
        # RENAME (a second context would leave a crash window replaying
        # the rename with NOT_PERSISTED dst parents — re-opening the
        # ghost-tree bug)
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.RENAME, {
                "id": inode.id, "new_parent_id": new_parent.id,
                "new_name": dst_uri.name, "op_time_ms": now})
            for cur in dst_anc:
                ctx.append(EntryType.PERSIST_FILE, {"id": cur.id})
        if persisted:
            self._rename_in_ufs(src_uri, dst_uri, inode.is_directory)
        self._absent_cache.remove(dst_uri.path)
        return []

    def _rename_in_ufs(self, src_uri: AlluxioURI, dst_uri: AlluxioURI,
                       is_dir: bool) -> None:
        try:
            src_res = self.mount_table.resolve(src_uri)
            dst_res = self.mount_table.resolve(dst_uri)
        except (NotFoundError, InvalidPathError):
            return
        ufs = self._ufs.get(src_res.mount_id)
        if is_dir:
            ufs.rename_directory(src_res.ufs_path, dst_res.ufs_path)
        else:
            ufs.rename_file(src_res.ufs_path, dst_res.ufs_path)

    # ----------------------------------------------------------------- free
    def journal_invalidations(self, paths: "List[str]") -> None:
        """Journal client-cache invalidations that have no metadata
        entry of their own (block-location drift: worker loss,
        quarantine/release, re-replication).  Routed through an
        ``INVALIDATE_PATH`` entry — never straight into the log — so the
        invalidation version stays a pure function of the applied
        journal and tailing standbys stamp the exact sequence the
        primary does (docs/ha.md)."""
        if not paths:
            return
        with self._journal.create_context() as ctx:
            for p in paths:
                ctx.append(EntryType.INVALIDATE_PATH, {"path": p})

    def free(self, path: "str | AlluxioURI", *, recursive: bool = False,
             forced: bool = False) -> List[int]:
        """Evict cached replicas; keep metadata + UFS copy
        (reference: ``free:2503``). Returns freed block ids."""
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            lookup = lip.lookup
            inode = lookup.inode
            from alluxio_tpu_torch.security.authorization import WRITE

            self._check_access(lookup, WRITE)
            targets: List[Inode] = []
            if inode.is_directory:
                if not recursive and self.inode_tree.has_children(inode):
                    raise DirectoryNotEmptyError(
                        f"{uri} is non-empty; need recursive")
                targets.extend(self.inode_tree.descendants(inode))
            targets.append(inode)
            block_ids: List[int] = []
            for t in targets:
                if t.is_directory:
                    continue
                if t.pinned and not forced:
                    raise InvalidArgumentError(
                        f"{self.inode_tree.get_path(t)} is pinned; "
                        "use forced free")
                if t.persistence_state != PersistenceState.PERSISTED:
                    raise FailedToFreeNonPersistedError(
                        f"{self.inode_tree.get_path(t)} is not persisted")
                block_ids.extend(t.block_ids)
            if forced or block_ids:
                with self._journal.create_context() as ctx:
                    if forced:
                        for t in targets:
                            if not t.is_directory and t.pinned:
                                ctx.append(EntryType.SET_ATTRIBUTE,
                                           {"id": t.id, "pinned": False})
                    if block_ids:
                        # freed replicas change location-derived fields
                        # (in-Alluxio state) under untouched inodes, so
                        # no other entry pushes the invalidation; one
                        # prefix covers the whole freed subtree
                        ctx.append(EntryType.INVALIDATE_PATH,
                                   {"path": uri.path})
        if block_ids:
            self._block_master.remove_blocks(block_ids, delete_metadata=False)
        return block_ids

    # ---------------------------------------------------------------- mount
    def mount(self, path: "str | AlluxioURI", ufs_uri: str, *,
              read_only: bool = False, shared: bool = False,
              properties: Optional[Dict[str, str]] = None) -> None:
        """Reference: ``mount:2736``."""
        uri = AlluxioURI(path)
        if uri.is_root():
            raise InvalidPathError("root mount is set at startup")
        # Validate the UFS BEFORE taking the tree lock: get_status is a
        # backing-store round trip (seconds against a cold object store)
        # and holding the global write lock across it would stall every
        # metadata operation cluster-wide.  The fresh mount_id is not
        # routable until ADD_MOUNT_POINT applies, so the early
        # UfsManager registration is invisible to readers; any failure
        # from here on removes it.
        mount_id = ids.create_mount_id()
        ufs = self._ufs.add_mount(mount_id, ufs_uri, properties)
        try:
            status = ufs.get_status(ufs_uri)
            if status is None or not status.is_directory:
                raise InvalidArgumentError(
                    f"UFS path {ufs_uri} is not an existing directory")
            with self.inode_tree.lock.write_locked():
                lookup = self.inode_tree.lookup(uri)
                if lookup.exists:
                    raise FileAlreadyExistsError(f"{uri} already exists")
                if len(lookup.missing_components) > 1:
                    raise FileDoesNotExistError(f"parent of {uri} must exist")
                self._check_parent_write(lookup)
                info = MountInfo(mount_id, uri.path, ufs_uri, read_only,
                                 shared, dict(properties or {}))
                now = self._now()
                cid = self._block_master.new_container_id()
                dir_inode = Inode.new_directory(
                    ids.file_id_from_container(cid), lookup.deepest.id,
                    uri.name, now_ms=now)
                dir_inode.mount_point = True
                dir_inode.persistence_state = PersistenceState.PERSISTED
                with self._journal.create_context() as ctx:
                    ctx.append(EntryType.INODE_DIRECTORY,
                               dir_inode.to_wire_dict())
                    ctx.append(EntryType.ADD_MOUNT_POINT, info.to_wire())
                # a new mount can reveal paths previously recorded absent
                self._absent_cache.clear()
        except Exception:
            self._ufs.remove_mount(mount_id)
            raise

    def unmount(self, path: "str | AlluxioURI") -> None:
        uri = AlluxioURI(path)
        with self.inode_tree.lock.write_locked():
            if not self.mount_table.is_mount_point(uri):
                raise InvalidPathError(f"{uri} is not a mount point")
            self._check_delete(self.inode_tree.lookup(uri))
            info = next(i for i in self.mount_table.mount_points()
                        if i.alluxio_path == uri.path)
            lookup = self.inode_tree.lookup(uri)
            victims = list(self.inode_tree.descendants(lookup.inode))
            victims.append(lookup.inode)
            block_ids = [b for v in victims for b in v.block_ids]
            now = self._now()
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.DELETE_MOUNT_POINT, {"path": uri.path})
                for v in victims:
                    payload = {"id": v.id, "op_time_ms": now}
                    if v is not lookup.inode:
                        # unmount root's entry covers the subtree by
                        # prefix; see _delete_locked
                        payload["covered"] = True
                    ctx.append(EntryType.DELETE_FILE, payload)
            if block_ids:
                self._block_master.remove_blocks(block_ids,
                                                 delete_metadata=True)
            self._ufs.remove_mount(info.mount_id)

    def get_mount_points(self) -> List[MountPointInfo]:
        out = []
        for info in self.mount_table.mount_points():
            ufs_type = ""
            total = used = -1
            if self._ufs.has(info.mount_id):
                ufs = self._ufs.get(info.mount_id)
                ufs_type = ufs.get_underfs_type()
                total, used = ufs.get_space_total(), ufs.get_space_used()
            out.append(MountPointInfo(
                alluxio_path=info.alluxio_path,
                ufs_uri=info.ufs_uri, ufs_type=ufs_type,
                ufs_capacity_bytes=total, ufs_used_bytes=used,
                read_only=info.read_only, shared=info.shared,
                mount_id=info.mount_id, properties=dict(info.properties)))
        return out

    # --------------------------------------------------------- setAttribute
    def set_attribute(self, path: "str | AlluxioURI", *,
                      pinned: Optional[bool] = None,
                      pinned_media: Optional[List[str]] = None,
                      ttl: Optional[int] = None,
                      ttl_action: Optional[str] = None,
                      mode: Optional[int] = None,
                      owner: Optional[str] = None,
                      group: Optional[str] = None,
                      replication_min: Optional[int] = None,
                      replication_max: Optional[int] = None,
                      recursive: bool = False,
                      xattr: Optional[Dict[str, str]] = None) -> None:
        """Reference: ``setAttribute:3087``."""
        uri = AlluxioURI(path)
        if replication_min is not None and replication_max is not None and \
                0 <= replication_max < replication_min:
            raise InvalidArgumentError("replication_max < replication_min")
        with self.inode_tree.lock_path(uri, write=True) as lip:
            lookup = lip.lookup
            inode = lookup.inode
            user = self._auth_user()
            self._perm.check_traverse(user, lookup.inodes[:-1])
            if owner is not None:
                # chown is superuser-only (reference parity)
                self._perm.check_superuser(user)
            elif mode is not None or group is not None:
                self._perm.check_owner(user, inode, path=uri.path)
            else:
                from alluxio_tpu_torch.security.authorization import WRITE

                self._perm.check(user, inode, WRITE, path=uri.path)
            if xattr is not None and any(k.startswith("system.")
                                         for k in xattr):
                # ACLs are managed via set_acl (owner-checked); letting a
                # WRITE-only caller plant system.* xattrs would forge ACLs
                raise InvalidArgumentError(
                    "system.* xattr keys cannot be set via set_attribute")
            targets = [inode]
            if recursive and inode.is_directory:
                targets.extend(self.inode_tree.descendants(inode))
            now = self._now()
            with self._journal.create_context() as ctx:
                for t in targets:
                    payload = {"id": t.id, "op_time_ms": now}
                    if pinned is not None:
                        payload["pinned"] = pinned
                        payload["pinned_media"] = pinned_media or []
                    if ttl is not None:
                        payload["ttl"] = ttl
                        payload["ttl_action"] = ttl_action or TtlAction.DELETE
                    if mode is not None:
                        payload["mode"] = mode
                    if owner is not None:
                        payload["owner"] = owner
                    if group is not None:
                        payload["group"] = group
                    if replication_min is not None:
                        payload["replication_min"] = replication_min
                    if replication_max is not None:
                        payload["replication_max"] = replication_max
                    if xattr is not None:
                        payload["xattr"] = xattr
                    ctx.append(EntryType.SET_ATTRIBUTE, payload)

    # -------------------------------------------------------------- ACLs
    from alluxio_tpu_torch.security.authorization import (
        ACL_XATTR, DEFAULT_ACL_XATTR,
    )

    def set_acl(self, path: "str | AlluxioURI", entries: List[str], *,
                default: bool = False, recursive: bool = False) -> None:
        """Replace the extended ACL (reference: ``setAcl`` +
        ``SET_ACL`` journal entry). ``entries``: ``user:name:rwx`` strings;
        empty list removes the ACL. ``default=True`` sets the default ACL
        inherited by new children (directories only)."""
        from alluxio_tpu_torch.security.authorization import AccessControlList

        AccessControlList.from_entries(entries)  # validate
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            lookup = lip.lookup
            inode = lookup.inode
            user = self._auth_user()
            self._perm.check_traverse(user, lookup.inodes[:-1])
            self._perm.check_owner(user, inode, path=uri.path)
            if default and not inode.is_directory:
                raise InvalidArgumentError(
                    "default ACLs apply to directories only")
            key = self.DEFAULT_ACL_XATTR if default else self.ACL_XATTR
            targets = [inode]
            if recursive and inode.is_directory:
                targets.extend(
                    d for d in self.inode_tree.descendants(inode)
                    # default ACLs exist only on directories
                    if d.is_directory or not default)
            now = self._now()
            with self._journal.create_context() as ctx:
                for t in targets:
                    xattr = dict(t.xattr)
                    if entries:
                        xattr[key] = ",".join(entries)
                    else:
                        xattr.pop(key, None)
                    ctx.append(EntryType.SET_ACL, {
                        "id": t.id, "xattr": xattr, "op_time_ms": now})

    def get_acl(self, path: "str | AlluxioURI") -> Dict[str, List[str]]:
        """Owner/group/mode base entries + extended + default entries
        (reference: ``getAcl`` wire shape)."""
        from alluxio_tpu_torch.security.authorization import bits_to_string

        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri) as lip:
            lookup = lip.lookup
            inode = lookup.inode
            from alluxio_tpu_torch.security.authorization import READ

            self._check_access(lookup, READ)
            base = [
                f"user:{inode.owner}:{bits_to_string((inode.mode >> 6) & 7)}",
                f"group:{inode.group}:{bits_to_string((inode.mode >> 3) & 7)}",
                f"other::{bits_to_string(inode.mode & 7)}",
            ]
            extended = inode.xattr.get(self.ACL_XATTR, "")
            default = inode.xattr.get(self.DEFAULT_ACL_XATTR, "")
            return {
                "owner": inode.owner, "group": inode.group,
                "mode": inode.mode,
                "entries": base + ([e for e in extended.split(",") if e]),
                "default_entries":
                    [e for e in default.split(",") if e],
            }

    def get_pinned_file_ids(self) -> Set[int]:
        # registry_lock, not the tree lock: striped mutations update the
        # pinned set at journal-apply time without holding the tree lock
        with self.inode_tree.registry_lock:
            return set(self.inode_tree.pinned_ids)

    def files_with_replication_constraints(self) -> List[Inode]:
        """Completed files whose replication is bounded — the
        ReplicationChecker's work list (reference:
        ``ReplicationChecker.java:57`` walks the replication-limited
        inode registry)."""
        with self.inode_tree.registry_lock:
            ids = list(self.inode_tree.replication_limited_ids)
        out = []
        for iid in ids:
            inode = self.inode_tree.get_inode(iid)
            if inode is not None and inode.completed:
                out.append(inode)
        return out

    # ------------------------------------------------------ persist control
    def schedule_async_persistence(self, path: "str | AlluxioURI") -> None:
        """Reference: ``scheduleAsyncPersistence:3209``."""
        uri = AlluxioURI(path)
        with self.inode_tree.lock_path(uri, write=True) as lip:
            from alluxio_tpu_torch.security.authorization import WRITE

            self._check_access(lip.lookup, WRITE)
            inode = self._existing_inode(lip.lookup, uri)
            if not inode.completed:
                raise FileIncompleteError(f"{uri} is not completed")
            if inode.persistence_state == PersistenceState.PERSISTED:
                return
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.SET_ATTRIBUTE, {
                    "id": inode.id,
                    "persistence_state": PersistenceState.TO_BE_PERSISTED})
            self._request_persist(inode.id)

    def _request_persist(self, inode_id: int) -> None:
        with self._persist_lock:
            self._persist_requests.add(inode_id)

    def pop_persist_requests(self) -> "set[int]":
        """Drain scheduled persist work as inode IDS (consumed by the
        persistence scheduler heartbeat). Paths are deliberately NOT
        stored here — a stored path is stale-by-design after a rename;
        the scheduler re-resolves via ``current_path_of``. The copy and
        the clear are one step under the lock every add takes, so an id
        requested meanwhile waits for the next drain instead of being
        cleared unseen."""
        with self._persist_lock:
            out = set(self._persist_requests)
            self._persist_requests.clear()
        return out

    def _unpersisted_chain(self, start, mount_uri: AlluxioURI) -> list:
        """``start`` and its ancestors (nearest first) that are not yet
        PERSISTED, stopping at ``mount_uri``'s mount point: an OUTER
        mount's directories live in a different UFS namespace — a
        persist inside a nested mount must never flip them (their UFS
        has no such dir and breadcrumbs cannot be written there).
        Callers hold the tree lock."""
        mp = self.mount_table.get_mount_point(mount_uri)
        out = []
        cur = start
        while cur is not None and \
                cur.persistence_state != PersistenceState.PERSISTED:
            if self.mount_table.get_mount_point(
                    self.inode_tree.get_path(cur)) != mp:
                break
            out.append(cur)
            cur = self.inode_tree.parent_of(cur)
        return out

    def _journal_persisted(self, ctx, inode, ufs_fingerprint: str = "",
                           ancestors: "Optional[list]" = None) -> None:
        """Journal PERSIST_FILE for ``inode`` AND every not-yet-persisted
        ancestor directory within the same mount. The UFS write that
        made the file durable also created its parent directories in
        the UFS, so their inodes must say PERSISTED — otherwise
        renaming such a directory skips the UFS-side rename (``rename``
        gates on the DIR's state) and the old UFS tree gets resurrected
        by metadata sync (observed: ghost ``/cp`` after ``mv /cp
        /moved`` once ``/cp/f`` had persisted). Callers that computed
        the chain already (to order breadcrumbs before this durable
        flip) pass it via ``ancestors``."""
        ctx.append(EntryType.PERSIST_FILE, {
            "id": inode.id, "ufs_fingerprint": ufs_fingerprint})
        if ancestors is None:
            ancestors = self._unpersisted_chain(
                self.inode_tree.parent_of(inode),
                self.inode_tree.get_path(inode))
        for cur in ancestors:
            ctx.append(EntryType.PERSIST_FILE, {"id": cur.id})

    def _ufs_dir_plan(self, ancestors: list,
                      made: "Set[tuple]" = frozenset()) -> "List[tuple]":
        """The UFS directories that ``ancestors`` (unpersisted
        directory inodes of one mount, nearest first) need and that are
        not in ``made``, shallowest first, as ``(mount id, UFS path)``.
        Decided under the caller's tree locks; :meth:`_make_ufs_dirs`
        makes them after release."""
        plan = []
        for inode in reversed(ancestors):
            res = self.mount_table.resolve(self.inode_tree.get_path(inode))
            if (res.mount_id, res.ufs_path) not in made:
                plan.append((res.mount_id, res.ufs_path))
        return plan

    def _make_ufs_dirs(self, plan: "List[tuple]") -> "Set[tuple]":
        """Make the UFS directories of ``plan`` (breadcrumb objects on
        object stores, real dirs elsewhere; idempotent) with no tree
        lock held, and return them as a set. A directory inode marked
        PERSISTED must exist in the UFS in its own right —
        implicit-prefix-only existence means metadata sync would delete
        the directory (and its cache-only children) as soon as its last
        persisted file is removed — and a PERSISTED inode under a
        NOT_PERSISTED directory brings back the ghost tree
        (:meth:`_journal_persisted`). So a failed mkdirs raises
        :class:`UnavailableError` before the caller journals anything or
        touches the UFS: the op, or the persist job, is retried."""
        for mount_id, ufs_path in plan:
            try:
                self._ufs.get(mount_id).mkdirs(ufs_path)
            except Exception as e:  # noqa: BLE001 any UFS fault: retry
                raise UnavailableError(
                    f"mkdirs {ufs_path} failed in the UFS: {e}") from e
        return set(plan)

    def _journal_after_ufs_dirs(self, plan: "List[tuple]", step) -> None:
        """Make ``plan``'s UFS directories with no tree lock held, then
        run ``step(made)`` under the exclusive tree lock. ``step``
        re-derives the op and journals it once every directory its
        ancestors now need is in ``made``; otherwise (the chain changed
        while the lock was released) it journals nothing and returns the
        rest, made on the next round."""
        made: "Set[tuple]" = set()
        for _ in range(_UFS_DIR_ROUNDS):
            made |= self._make_ufs_dirs(plan)
            with self.inode_tree.lock.write_locked():
                plan = step(made)
            if not plan:
                return
        raise UnavailableError(
            f"the UFS parent chain changed {_UFS_DIR_ROUNDS} times while "
            "its directories were made")

    def current_path_of(self, inode_id: int) -> "Optional[str]":
        """Re-resolve an inode id to its CURRENT path (None when the
        inode no longer exists). Persistence tracks files by id so a
        rename between scheduling and submission keeps durability at
        the new path (reference: fileId-keyed ``PersistJob``)."""
        with self.inode_tree.lock.read_locked():
            uri = self.inode_tree.path_of_id(inode_id)
        return str(uri) if uri is not None else None

    def mark_persisted(self, path: "str | AlluxioURI",
                       ufs_fingerprint: str = "") -> None:
        """A worker/job reports the file durable in the UFS.  Same
        striped-fast-path / coarse-ancestor-flip split as
        :meth:`complete_file`."""
        uri = AlluxioURI(path)

        def step(lookup: PathLookup,
                 made: "Set[tuple]" = frozenset()) -> "List[tuple]":
            inode = self._existing_inode(lookup, uri)
            anc = self._unpersisted_chain(
                self.inode_tree.parent_of(inode), uri)
            missing = self._ufs_dir_plan(anc, made)
            if not missing:
                with self._journal.create_context() as ctx:
                    self._journal_persisted(ctx, inode, ufs_fingerprint,
                                            ancestors=anc)
            return missing

        with self.inode_tree.lock_path(uri, write=True) as lip:
            plan = step(lip.lookup)
        if plan:
            # breadcrumbs BEFORE the durable flip, with no tree lock held
            self._journal_after_ufs_dirs(
                plan, lambda made: step(self.inode_tree.lookup(uri), made))

    def commit_persist(self, path: "str | AlluxioURI",
                       temp_ufs_path: str, *,
                       expected_id: int = 0) -> str:
        """Atomically promote a temp UFS persist file written by a worker.

        The async-persist race (reference solves it the same way —
        persists go to a temporary UFS path and a master-side commit
        renames into place, ``DefaultFileSystemMaster`` persist jobs +
        ``UfsCleaner`` for abandoned temps): a worker finishing a persist
        AFTER the file was deleted must not leave a zombie UFS file that
        metadata sync would resurrect.

        ``expected_id`` pins the commit to the inode the persist was
        scheduled for: a delete+recreate at the same path must NOT get the
        old file's bytes renamed over its data. ``temp_ufs_path=""`` means
        a zero-block file — the final UFS file is created empty (without
        it, a later metadata sync would see a PERSISTED inode with no UFS
        object and remove the file).

        Three phases so the slow UFS rename doesn't stall the whole
        namespace behind the tree write lock: (1) validate under the
        lock, (2) rename with the tree lock RELEASED, (3) re-validate
        under the lock and journal — if the inode vanished or changed
        during (2), the just-renamed file is deleted, never journaled.
        A master-wide persist mutex serializes phase 2 across commits:
        without it, a commit for a RECREATED inode at the same path could
        land inside another commit's rename window and have its freshly
        committed UFS file overwritten/cleaned by the stale one. Every
        persist path (async, sync CACHE_THROUGH, zero-block) flows
        through this method, so the mutex covers all final-file writes."""
        uri = AlluxioURI(path)

        def _validated_inode():
            inode = self._existing_file(uri)
            if expected_id and inode.id != expected_id:
                raise FileDoesNotExistError(
                    f"{uri} was recreated (inode {inode.id} != persist "
                    f"target {expected_id})")
            return inode

        with self._persist_mutex:
            with self.inode_tree.lock.write_locked():
                try:
                    inode = _validated_inode()
                except (FileDoesNotExistError, InvalidPathError):
                    self._discard_temp(uri, temp_ufs_path)
                    raise
                resolution = self.mount_table.resolve(uri)
                plan = self._ufs_dir_plan(self._unpersisted_chain(
                    self.inode_tree.parent_of(inode), uri))
            ufs = self._ufs.get(resolution.mount_id)
            # phase 2: UFS IO outside the tree lock (can be a
            # multi-second server-side copy on object stores).
            # Parent-chain breadcrumbs FIRST: the ancestors are about
            # to be journaled PERSISTED and must exist explicitly
            # (steady state — chain already persisted — skips the RPC);
            # a failed mkdirs raises before the rename, and the temp is
            # left for the job's retry or the UfsCleaner's sweep
            made = self._make_ufs_dirs(plan)
            if temp_ufs_path:
                if not ufs.rename_file(temp_ufs_path, resolution.ufs_path):
                    raise UnavailableError(
                        f"rename {temp_ufs_path} -> {resolution.ufs_path} "
                        "failed in the UFS")
            else:  # zero-block file: create the empty UFS object
                ufs.create(resolution.ufs_path).close()
            fp = ufs.get_fingerprint(resolution.ufs_path)
            fingerprint = fp.serialize() if fp is not None else ""
            with self.inode_tree.lock.write_locked():
                try:
                    inode = _validated_inode()
                    anc = self._unpersisted_chain(
                        self.inode_tree.parent_of(inode), uri)
                    if self._ufs_dir_plan(anc, made):
                        raise UnavailableError(
                            f"the UFS parent chain of {uri} changed during "
                            "the persist commit")
                except (FileDoesNotExistError, InvalidPathError,
                        UnavailableError):
                    # deleted/recreated during the rename: the delete's
                    # own UFS cleanup has already swept the directory —
                    # remove the file if it survived (no other persist
                    # can have committed here: we hold the mutex)
                    try:
                        ufs.delete_file(resolution.ufs_path)
                    except Exception:  # noqa: BLE001 best-effort
                        LOG.debug("post-rename cleanup failed for %s",
                                  resolution.ufs_path, exc_info=True)
                    raise
                with self._journal.create_context() as ctx:
                    self._journal_persisted(ctx, inode, fingerprint,
                                            ancestors=anc)
                return fingerprint

    def _discard_temp(self, uri: AlluxioURI, temp_ufs_path: str) -> None:
        if not temp_ufs_path:
            return
        try:
            resolution = self.mount_table.resolve(uri)
            ufs = self._ufs.get(resolution.mount_id)
            ufs.delete_file(temp_ufs_path)
            # the worker's temp write mkdirs'd the final file's parent
            # chain in the UFS (temps live next to their final files
            # for same-dir rename atomicity). When this commit failed
            # because the file MOVED (rename raced the persist), those
            # directories are namespace orphans now — metadata sync
            # would resurrect them as ghost paths (observed: /rp back
            # after `mv /rp /rp-moved` raced an async persist). Prune
            # empty orphaned parents bottom-up, stopping at the first
            # directory the namespace still knows, a non-empty one, or
            # the mount root.
            parent = uri.parent()
            ufs_dir = temp_ufs_path.rsplit("/", 1)[0]
            mount_root = resolution.mount_info.ufs_uri.rstrip("/")
            while parent is not None and parent.path not in ("", "/") \
                    and ufs_dir.rstrip("/") != mount_root:
                lookup = self.inode_tree.lookup(parent)
                if len(lookup.inodes) == \
                        1 + len(parent.path_components()):
                    break  # dir still exists in the namespace: owned
                if ufs.list_status(ufs_dir):
                    break  # not empty: someone else's contents
                if not ufs.delete_directory(ufs_dir):
                    break
                parent = parent.parent()
                ufs_dir = ufs_dir.rsplit("/", 1)[0]
        except Exception:  # noqa: BLE001 UfsCleaner sweeps later
            LOG.debug("temp persist cleanup failed for %s",
                      temp_ufs_path, exc_info=True)

    def file_system_heartbeat(self, worker_id: int,
                              persisted_files: List[int]) -> None:
        """Worker-reported persist completions
        (reference: FileSystemMasterWorkerService.FileSystemHeartbeat)."""
        for fid in persisted_files:
            inode = self.inode_tree.get_inode(fid)
            if inode is None:
                continue
            uri = self.inode_tree.get_path(inode)
            try:
                self.mark_persisted(uri)
            except FileDoesNotExistError:
                pass

    # ------------------------------------------------------- UFS metadata sync
    def _maybe_sync(self, uri: AlluxioURI, sync_interval_ms: int) -> bool:
        """On-access sync gate (reference: ``InodeSyncStream.java:115`` +
        ``UfsSyncPathCache``): -1 never, 0 always, >0 min interval. A
        recursive sync of an ancestor freshens this path too. Returns
        True when a sync actually ran — listings use that to force a
        UFS child re-list past ``direct_children_loaded``."""
        if not self._sync_cache.should_sync(uri.path, self._now(),
                                            sync_interval_ms):
            return False
        self.sync_metadata(uri)
        return True

    def sync_metadata(self, path: "str | AlluxioURI", *,
                      recursive: bool = False) -> bool:
        """Diff UFS vs inode state via fingerprints; reload on change.
        ``recursive`` extends the diff to the whole subtree (the
        ``DescendantType.ALL`` mode of ``InodeSyncStream``). Returns True
        if anything changed.

        Reconciliation runs with master privileges (auth user rebound to
        None, trusted in-process), matching the reference where
        ``InodeSyncStream`` performs internal deletes/loads as the master —
        a read-only caller's on-access sync must not fail permission checks
        for namespace repair it did not itself request."""
        from alluxio_tpu_torch.security.user import (
            reset_authenticated_user, set_authenticated_user,
        )
        token = set_authenticated_user(None)
        try:
            uri = AlluxioURI(path)
            changed = self._sync_one(uri)
            if recursive:
                changed = self._sync_children(uri) or changed
            self._sync_cache.notify_synced(uri.path, self._now(),
                                           recursive=recursive)
            return changed
        finally:
            reset_authenticated_user(token)

    def _sync_one(self, uri: AlluxioURI, *,
                  status: "UfsStatus | None" = None,
                  status_known: bool = False) -> bool:
        """``status_known=True`` means the caller already holds the UFS
        status (e.g. from a directory listing) — skip the per-path probe."""
        try:
            resolution = self.mount_table.resolve(uri)
        except (NotFoundError, InvalidPathError):
            return False
        ufs = self._ufs.get(resolution.mount_id)
        if not status_known:
            status = ufs.get_status(resolution.ufs_path)
        with self.inode_tree.lock.read_locked():
            lookup = self.inode_tree.lookup(uri)
            exists = lookup.exists
            inode = lookup.inode if exists else None
        if status is None:
            self._absent_cache.add(uri.path)
            if exists and inode.persistence_state == PersistenceState.PERSISTED:
                # UFS deleted it out-of-band
                self.delete(uri, recursive=True, alluxio_only=True)
                return True
            return False
        self._absent_cache.remove(uri.path)
        new_fp = Fingerprint.from_status(status)
        if not exists:
            self._load_metadata_if_exists(uri, status=status)
            return True
        if inode.is_directory != status.is_directory:
            self.delete(uri, recursive=True, alluxio_only=True)
            self._load_metadata_if_exists(uri, status=status)
            return True
        old_fp = Fingerprint.parse(inode.ufs_fingerprint)
        if not inode.is_directory and not new_fp.matches_content(old_fp) and \
                inode.persistence_state == PersistenceState.PERSISTED:
            # content changed under us: drop cached blocks + metadata, reload
            self.delete(uri, recursive=False, alluxio_only=True)
            self._load_metadata_if_exists(uri, status=status)
            return True
        return False

    def _sync_children(self, uri: AlluxioURI) -> bool:
        """Recursive UFS-vs-tree diff below ``uri``: load new UFS entries,
        re-check known ones, drop persisted inodes the UFS lost."""
        try:
            resolution = self.mount_table.resolve(uri)
        except (NotFoundError, InvalidPathError):
            return False
        if not self._ufs.has(resolution.mount_id):
            return False
        ufs = self._ufs.get(resolution.mount_id)
        listing = ufs.list_status(resolution.ufs_path)
        if listing is None:
            return False
        from alluxio_tpu_torch.master.integrity import is_infra_temp

        # in-flight/abandoned framework temps (persist temps, atomic-
        # create temps) are infrastructure, not data: loading one would
        # surface it as a file and break when the rename removes it
        ufs_names = {st.name: st for st in listing
                     if not is_infra_temp(st.name)}
        changed = False
        with self.inode_tree.lock.read_locked():
            lookup = self.inode_tree.lookup(uri)
            if not lookup.exists or not lookup.inode.is_directory:
                return False
            known = {c.name: c for c in
                     self.inode_tree.children(lookup.inode)}
        # UFS entries unknown to the tree -> load; the listing already
        # carries each child's status, so no per-child UFS probe is needed
        for name, st in ufs_names.items():
            child = uri.join(name)
            if name not in known:
                self._load_metadata_if_exists(child, status=st)
                changed = True
            else:
                changed = self._sync_one(child, status=st,
                                         status_known=True) or changed
            if st.is_directory:
                changed = self._sync_children(child) or changed
        # persisted inodes gone from the UFS -> drop (cache-only stays)
        for name, inode in known.items():
            if name not in ufs_names and \
                    inode.persistence_state == PersistenceState.PERSISTED:
                self.delete(uri.join(name), recursive=True,
                            alluxio_only=True)
                changed = True
        return changed

    def _load_metadata_if_exists(self, uri: AlluxioURI, *,
                                 status: "UfsStatus | None" = None
                                 ) -> Optional[FileInfo]:
        """Create inodes mirroring an existing UFS path (metadata load on
        access — reference: ``InodeSyncStream`` loadMetadata). A caller
        that already holds the UFS status passes it to skip the probe."""
        from alluxio_tpu_torch.master.integrity import is_infra_temp

        if is_infra_temp(uri.name):
            return None  # framework temps never enter the namespace
        if status is None and self._absent_cache.is_absent(uri.path):
            return None
        try:
            resolution = self.mount_table.resolve(uri)
        except (NotFoundError, InvalidPathError):
            return None
        if not self._ufs.has(resolution.mount_id):
            return None
        ufs = self._ufs.get(resolution.mount_id)
        if status is None:
            status = ufs.get_status(resolution.ufs_path)
        if status is None:
            self._absent_cache.add(uri.path)
            return None
        with self.inode_tree.lock.write_locked():
            lookup = self.inode_tree.lookup(uri)
            if lookup.exists:
                return self._file_info(lookup.inode, uri)
            # ensure ancestors exist (each may itself be a UFS dir)
            now = self._now()
            parent_id = lookup.deepest.id
            with self._journal.create_context() as ctx:
                for name in lookup.missing_components[:-1]:
                    cid = self._block_master.new_container_id()
                    d = Inode.new_directory(
                        ids.file_id_from_container(cid), parent_id, name,
                        now_ms=now)
                    d.persistence_state = PersistenceState.PERSISTED
                    ctx.append(EntryType.INODE_DIRECTORY, d.to_wire_dict())
                    parent_id = d.id
                cid = self._block_master.new_container_id()
                if status.is_directory:
                    inode = Inode.new_directory(
                        ids.file_id_from_container(cid), parent_id, uri.name,
                        now_ms=now)
                else:
                    inode = Inode.new_file(
                        cid, parent_id, uri.name,
                        block_size_bytes=self._default_block_size, now_ms=now)
                    inode.length = status.length
                    inode.completed = True
                    n_blocks = ((status.length + self._default_block_size - 1)
                                // self._default_block_size)
                    inode.block_ids = [ids.block_id(cid, i)
                                       for i in range(n_blocks)]
                inode.persistence_state = PersistenceState.PERSISTED
                inode.ufs_fingerprint = Fingerprint.from_status(
                    status).serialize()
                if status.mode is not None:
                    inode.mode = status.mode
                ctx.append(EntryType.INODE_FILE if not status.is_directory
                           else EntryType.INODE_DIRECTORY,
                           inode.to_wire_dict())
            # register block lengths so reads can size them
            if not status.is_directory:
                fresh = self.inode_tree.get_inode(inode.id)
                remaining = status.length
                for bid in fresh.block_ids:
                    self._block_master.commit_block_in_ufs(
                        bid, min(self._default_block_size, remaining))
                    remaining -= self._default_block_size
            return self._file_info(self.inode_tree.get_inode(inode.id), uri)

    def _load_children_if_needed(self, uri: AlluxioURI,
                                 force: bool = False) -> None:
        """List the UFS dir and load any children absent from the tree —
        ONCE per directory: ``direct_children_loaded`` marks a dir whose
        UFS children are in the tree, and subsequent listings skip the
        UFS round trip entirely. A listing whose sync-interval fired
        passes ``force=True`` to re-list past the flag (that is HOW
        external UFS changes surface — reference:
        ``InodeDirectory.isDirectChildrenLoaded`` +
        ``DefaultFileSystemMaster.listStatus`` descendant sync)."""
        if not force:
            with self.inode_tree.lock.read_locked():
                lookup = self.inode_tree.lookup(uri)
                if lookup.exists and lookup.inode.direct_children_loaded:
                    return
        try:
            resolution = self.mount_table.resolve(uri)
        except (NotFoundError, InvalidPathError):
            return
        if not self._ufs.has(resolution.mount_id):
            return
        ufs = self._ufs.get(resolution.mount_id)
        children = ufs.list_status(resolution.ufs_path)
        if children is None:
            # could not list (UFS dir gone/unreadable) — the once-only
            # flag must NOT latch on this outcome or the children would
            # be hidden forever once the dir reappears
            return
        with self.inode_tree.lock.read_locked():
            lookup = self.inode_tree.lookup(uri)
            if not lookup.exists:
                return
            known = set(self.inode_tree.child_names(lookup.inode))
        for st in children:
            if st.name not in known:
                self._load_metadata_if_exists(uri.join(st.name))
        self._mark_children_loaded(uri)

    def _mark_children_loaded(self, uri: AlluxioURI) -> None:
        """Journal ``direct_children_loaded`` so the once-only contract
        survives failover (the flag rides the same INODE_DIRECTORY
        upsert entries create_file journals for implicit parents)."""
        with self.inode_tree.lock.write_locked():
            lookup = self.inode_tree.lookup(uri)
            if not lookup.exists or not lookup.inode.is_directory or \
                    lookup.inode.direct_children_loaded:
                return
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.UPDATE_INODE,
                           {"id": lookup.inode.id,
                            "direct_children_loaded": True})

    # --------------------------------------------------------------- TTL
    def check_ttl_expired(self) -> List[str]:
        """One TTL-checker tick (reference: ``InodeTtlChecker.java``):
        apply DELETE/FREE actions to expired inodes. Returns acted paths."""
        now = self._now()
        expired = self.inode_tree.ttl_buckets.poll_expired(now)
        acted: List[str] = []
        for iid in expired:
            inode = self.inode_tree.get_inode(iid)
            if inode is None:
                self.inode_tree.ttl_buckets.remove(iid)
                continue
            uri = self.inode_tree.get_path(inode)
            try:
                if inode.ttl_action == TtlAction.FREE:
                    self.free(uri, recursive=True, forced=True)
                    self.set_attribute(uri, ttl=-1)
                else:
                    self.delete(uri, recursive=True, alluxio_only=not (
                        inode.persistence_state == PersistenceState.PERSISTED))
                acted.append(uri.path)
            except Exception as e:  # noqa: BLE001 - retried next tick
                LOG.warning("TTL action %s on %s failed (retrying next "
                            "tick): %s", inode.ttl_action, uri, e)
                continue
            self.inode_tree.ttl_buckets.remove(iid)
        return acted


@register_wire_error
class FailedToFreeNonPersistedError(InvalidArgumentError):
    pass


class _MountTableJournal:
    """Adapter making MountTable a Journaled component."""

    journal_name = "MountTable"

    def __init__(self, table: MountTable, *,
                 invalidation_sink=None) -> None:
        self._table = table
        self._invalidation_sink = invalidation_sink

    def process_entry(self, entry) -> bool:
        if entry.type == EntryType.ADD_MOUNT_POINT:
            info = MountInfo.from_wire(entry.payload)
            self._table.add(info)
            if self._invalidation_sink is not None:
                self._invalidation_sink(info.alluxio_path)
            return True
        if entry.type == EntryType.DELETE_MOUNT_POINT:
            self._table.delete(entry.payload["path"])
            if self._invalidation_sink is not None:
                self._invalidation_sink(entry.payload["path"])
            return True
        return False

    def snapshot(self) -> dict:
        return {"mounts": self._table.snapshot()}

    def restore(self, snap: dict) -> None:
        self._table.restore(snap.get("mounts", []))

    def reset_state(self) -> None:
        self._table.clear()
