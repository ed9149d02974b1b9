"""Master integrity daemons: lost files, orphan blocks, abandoned temps —
of ``alluxio_tpu/master/integrity.py`` the port has only
:func:`is_infra_temp`, which metadata sync reads; the JAX module's
three daemons come with the master's checkers.

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
"""

from __future__ import annotations

PERSIST_TEMP_PREFIX = ".atpu_persist."
#: every temp-file family the framework writes into UFSes: persist temps
#: plus the local-UFS atomic-create temps (underfs/local.py mkstemp)
INFRA_TEMP_PREFIXES = (PERSIST_TEMP_PREFIX, ".atpu_tmp_")


def is_infra_temp(name: str) -> bool:
    """True for framework-internal temp names that must never surface in
    the namespace (metadata sync) and are sweepable when stale."""
    return name.startswith(INFRA_TEMP_PREFIXES)
