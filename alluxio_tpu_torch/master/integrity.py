"""Master integrity daemons: lost files, orphan blocks, abandoned temps (a
copy of ``alluxio_tpu/master/integrity.py``).

Re-design of ``core/server/master/src/main/java/alluxio/master/file/
{LostFileDetector,BlockIntegrityChecker,UfsCleaner}.java`` as tickable
heartbeats:

- **LostFileDetector** — a file whose every block has no live worker
  location and no UFS copy is unrecoverable: mark it ``LOST`` (journaled)
  so clients fail fast instead of timing out; if a worker holding the
  blocks re-registers, the detector restores the state.
- **BlockIntegrityChecker** — blocks in the master map whose owning file
  inode no longer exists are garbage (a crash between delete journal
  batches can leak them): free them on their workers and drop metadata.
- **UfsCleaner** — async persist writes ``.atpu_persist.*`` temp files
  that a worker crash can abandon; sweep mounted UFSes for temps older
  than a TTL.

A recovered file whose persist was pending goes back on the file
master's persist queue through its lock (``_request_persist``), as every
other producer of persist requests does in the port.
"""

from __future__ import annotations

import logging
import time
from typing import List

from alluxio_tpu_torch.journal.format import EntryType
from alluxio_tpu_torch.master.inode import PersistenceState
from alluxio_tpu_torch.utils import ids
from alluxio_tpu_torch.utils.exceptions import NotFoundError

LOG = logging.getLogger(__name__)

PERSIST_TEMP_PREFIX = ".atpu_persist."
#: every temp-file family the framework writes into UFSes: persist temps
#: plus the local-UFS atomic-create temps (underfs/local.py mkstemp)
INFRA_TEMP_PREFIXES = (PERSIST_TEMP_PREFIX, ".atpu_tmp_")


def is_infra_temp(name: str) -> bool:
    """True for framework-internal temp names that must never surface in
    the namespace (metadata sync) and are sweepable when stale."""
    return name.startswith(INFRA_TEMP_PREFIXES)


class LostFileDetector:
    """Reference: ``LostFileDetector.java`` (HeartbeatContext
    MASTER_LOST_FILES_DETECTION)."""

    def __init__(self, fs_master, block_master) -> None:
        self._fsm = fs_master
        self._bm = block_master

    def heartbeat(self) -> None:
        self._detect()
        self._recover()

    def _detect(self) -> None:
        lost_blocks = self._bm.lost_blocks()
        if not lost_blocks:
            return
        tree = self._fsm.inode_tree
        candidates = {ids.file_id_for_block(b) for b in lost_blocks}
        with tree.lock.write_locked():
            for fid in sorted(candidates):
                inode = tree.get_inode(fid)
                if inode is None or inode.is_directory or \
                        not inode.completed:
                    continue
                if inode.persistence_state in (PersistenceState.PERSISTED,
                                               PersistenceState.LOST):
                    # persisted: re-fetchable from the UFS, not lost
                    continue
                blocks = inode.block_ids
                if blocks and all(b in lost_blocks for b in blocks):
                    pending = inode.persistence_state == \
                        PersistenceState.TO_BE_PERSISTED
                    with self._fsm._journal.create_context() as ctx:
                        ctx.append(EntryType.SET_ATTRIBUTE, {
                            "id": inode.id,
                            "persistence_state": PersistenceState.LOST,
                            "lost_pending_persist": pending})
                    LOG.warning("file %s marked LOST (all %d blocks on "
                                "lost workers)", inode.name, len(blocks))

    def _recover(self) -> None:
        """Scan the tree's journaled LOST registry (survives restarts —
        the SET_ATTRIBUTE entries rebuild ``lost_file_ids`` on replay)."""
        tree = self._fsm.inode_tree
        if not tree.lost_file_ids:
            return
        with tree.lock.write_locked():
            for fid in sorted(tree.lost_file_ids):
                inode = tree.get_inode(fid)
                if inode is None or \
                        inode.persistence_state != PersistenceState.LOST:
                    tree.lost_file_ids.discard(fid)
                    continue
                # recover only when every block is actually available
                # again (a merely-unknown block after a restart is not
                # evidence of recovery)
                if inode.block_ids and all(
                        self._bm.has_locations(b)
                        for b in inode.block_ids):
                    # a durability request pending at loss time is
                    # restored, not dropped (ASYNC_THROUGH contract)
                    state = PersistenceState.TO_BE_PERSISTED if \
                        inode.lost_pending_persist else \
                        PersistenceState.NOT_PERSISTED
                    with self._fsm._journal.create_context() as ctx:
                        ctx.append(EntryType.SET_ATTRIBUTE, {
                            "id": inode.id,
                            "persistence_state": state,
                            "lost_pending_persist": False})
                    if state == PersistenceState.TO_BE_PERSISTED:
                        self._fsm._request_persist(inode.id)
                    LOG.info("file %s recovered from LOST (-> %s)",
                             inode.name, state)


class BlockIntegrityChecker:
    """Reference: ``BlockIntegrityChecker.java`` — delete orphaned
    blocks whose owning file is gone."""

    def __init__(self, fs_master, block_master) -> None:
        self._fsm = fs_master
        self._bm = block_master

    def heartbeat(self) -> None:
        tree = self._fsm.inode_tree
        orphans: List[int] = []
        for bid in self._bm.all_block_ids():
            inode = tree.get_inode(ids.file_id_for_block(bid))
            if inode is None or bid not in inode.block_ids:
                orphans.append(bid)
        if orphans:
            LOG.warning("freeing %d orphaned blocks with no owning file",
                        len(orphans))
            self._bm.remove_blocks(orphans, delete_metadata=True)


class UfsCleaner:
    """Reference: ``UfsCleaner.java`` — sweep abandoned persist temps.

    Cost note: temps live next to their final files (same-dir rename
    atomicity), so the sweep walks the whole mounted namespace — on
    object stores that is one listing per prefix per tick. Abandoned
    temps exist only after a worker crash, so the default interval is
    long (1h) and each tick is bounded by ``max_entries_per_tick``.
    """

    def __init__(self, mount_table, ufs_manager, *,
                 ttl_ms: int = 60 * 60 * 1000,
                 max_entries_per_tick: int = 100_000) -> None:
        self._mounts = mount_table
        self._ufs = ufs_manager
        self._ttl_ms = ttl_ms
        self._budget = max_entries_per_tick

    def heartbeat(self) -> int:
        """Returns the number of temps removed (for tests/metrics)."""
        removed = 0
        now_ms = int(time.time() * 1000)
        for mi in self._mounts.mount_points():
            try:
                ufs = self._ufs.get(mi.mount_id)
            except NotFoundError:
                continue  # unmounted mid-scan
            removed += self._sweep(ufs, mi.ufs_uri, now_ms, self._budget)
        return removed

    def _sweep(self, ufs, root: str, now_ms: int, budget: int) -> int:
        removed = 0
        stack = [root.rstrip("/")]
        seen = 0
        while stack and seen < budget:
            d = stack.pop()
            try:
                entries = ufs.list_status(d) or []
            except Exception:  # noqa: BLE001 racing deletes
                LOG.debug("UfsCleaner list of %s failed", d, exc_info=True)
                continue
            for st in entries:
                if seen >= budget:
                    LOG.debug("UfsCleaner tick budget exhausted at %s", d)
                    break
                seen += 1
                path = f"{d}/{st.name}"
                if st.is_directory:
                    stack.append(path)
                elif is_infra_temp(st.name):
                    age = now_ms - (st.last_modified_ms or 0)
                    if age > self._ttl_ms:
                        try:
                            if ufs.delete_file(path):
                                removed += 1
                                LOG.info("UfsCleaner removed abandoned "
                                         "persist temp %s", path)
                        except Exception:  # noqa: BLE001 next tick
                            LOG.debug("temp delete failed: %s", path,
                                      exc_info=True)
        return removed
