"""Async audit logging (a copy of ``alluxio_tpu/security/audit.py``, with
the same line format; the logger is the port's own,
``alluxio_tpu_torch.audit``). One addition: the writer also counts the
dropped entries of denied calls (``dropped_denied``), so a run can show
that every shed call was logged or counted.

Re-design of ``core/server/common/.../master/audit/
AsyncUserAccessAuditLogWriter.java:31`` + ``master/file/
FileSystemMasterAuditContext.java:27``: RPC handlers record an audit
context (user, command, src/dst, allowed, succeeded); entries drain to a
logger on a background thread so the RPC path never blocks on IO.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Optional

AUDIT_LOG = logging.getLogger("alluxio_tpu_torch.audit")


@dataclass
class AuditContext:
    command: str
    src_path: str = ""
    dst_path: str = ""
    user: str = ""
    ip: str = ""
    allowed: bool = True
    succeeded: bool = True

    def format(self) -> str:
        return (f"succeeded={str(self.succeeded).lower()} "
                f"allowed={str(self.allowed).lower()} "
                f"ugi={self.user} ip={self.ip} cmd={self.command} "
                f"src={self.src_path} dst={self.dst_path}")


class AsyncAuditLogWriter:
    """Bounded-queue writer; drops (and counts) entries when saturated
    rather than stalling RPCs (reference behavior)."""

    def __init__(self, capacity: int = 10_000) -> None:
        self._queue: "queue.Queue[Optional[AuditContext]]" = \
            queue.Queue(maxsize=capacity)
        self._thread: Optional[threading.Thread] = None
        self.dropped = 0
        #: of ``dropped``, the entries of denied calls (``allowed`` false:
        #: shed or refused), so every denial is either logged or counted
        self.dropped_denied = 0
        self._stopped = threading.Event()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._drain,
                                        name="audit-writer", daemon=True)
        self._thread.start()

    def append(self, ctx: AuditContext) -> None:
        try:
            self._queue.put_nowait(ctx)
        except queue.Full:
            self.dropped += 1
            if not ctx.allowed:
                self.dropped_denied += 1

    def _drain(self) -> None:
        while not self._stopped.is_set():
            try:
                ctx = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if ctx is None:
                break
            AUDIT_LOG.info("%s", ctx.format())

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout=2)
