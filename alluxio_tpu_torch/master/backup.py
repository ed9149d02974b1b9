"""Scheduled metadata backups (a copy of ``alluxio_tpu/master/backup.py``).

Re-design of ``core/server/master/src/main/java/alluxio/master/meta/
DailyMetadataBackup.java:49`` (+ the delegated flavor in
``master/backup/BackupLeaderRole.java:62``): a master heartbeat that
periodically lands a full metadata backup in the configured backup
directory and prunes old copies down to a retention count.

Departures from the reference, on purpose:
* interval-based rather than fixed time-of-day (a training cluster has no
  natural "daily quiet hour"; the interval default is still 24h);
* runs on the primary — ``write_backup`` snapshots component state
  under the journal lock in one pass (Python dict snapshot, no
  stop-the-world serialization like the reference's rocks iteration),
  so the delegated-to-standby machinery (dedicated messaging transport,
  ``BackupWorkerRole``) is not worth its complexity here. The snapshot
  pause is the same one a periodic checkpoint already takes.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import List, Optional

LOG = logging.getLogger(__name__)

_BACKUP_RE = re.compile(r"^atpu-backup-.*\.bak$")


class ScheduledBackup:
    """Heartbeat executor: back up when due, then prune.

    ``clock``: monotonic-seconds fn (injectable for deterministic
    tests). The first tick after start does NOT back up (the reference
    waits for the first scheduled time too) unless the directory has no
    backup at all.
    """

    def __init__(self, journal, backup_dir: str, *,
                 interval_s: float = 24 * 3600.0, retention: int = 3,
                 clock=time.monotonic) -> None:
        self._journal = journal
        self._dir = backup_dir
        self._interval_s = interval_s
        self._retention = max(1, retention)
        self._clock = clock
        self._last: Optional[float] = None
        self.backups_taken = 0
        self.last_backup_path: Optional[str] = None
        self.last_error: Optional[str] = None

    # -- heartbeat ----------------------------------------------------------
    def heartbeat(self) -> Optional[str]:
        """One tick: returns the new backup path when one was taken."""
        now = self._clock()
        if self._last is None:
            # fresh process: take an immediate backup only if none exist
            # (a restart must not produce a backup storm)
            if self._existing():
                self._last = now
                return None
        elif now - self._last < self._interval_s:
            return None
        try:
            path = self._journal.write_backup(self._dir)
        except Exception as e:  # noqa: BLE001 keep the heartbeat alive
            self.last_error = f"{type(e).__name__}: {e}"
            LOG.warning("scheduled backup failed: %s", self.last_error)
            return None
        self._last = now
        self.backups_taken += 1
        self.last_backup_path = path
        self.last_error = None
        self._prune()
        return path

    # -- retention ----------------------------------------------------------
    @staticmethod
    def _age_key(name: str):
        # atpu-backup-<YYYYMMDD-HHMMSS>-<seq>[.<n>].bak — the sequence and
        # uniquifier are NOT zero-padded, so lexical order misranks two
        # backups in the same wall-clock second (seq 10 < seq 9 lexically)
        m = re.match(
            r"^atpu-backup-(\d{8}-\d{6})-(\d+)(?:\.(\d+))?\.bak$", name)
        if m is None:
            return (name, 0, 0)
        return (m.group(1), int(m.group(2)), int(m.group(3) or 0))

    def _existing(self) -> List[str]:
        try:
            return sorted((f for f in os.listdir(self._dir)
                           if _BACKUP_RE.match(f)), key=self._age_key)
        except FileNotFoundError:
            return []

    def _prune(self) -> None:
        """Keep the newest ``retention`` backups (names embed a sortable
        UTC stamp, reference ``DailyMetadataBackup.deleteStaleBackups``)."""
        names = self._existing()
        for name in names[:-self._retention]:
            try:
                os.unlink(os.path.join(self._dir, name))
            except OSError as e:
                LOG.warning("could not prune backup %s: %s", name, e)
