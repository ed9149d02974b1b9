"""Async audit logging (a copy of ``alluxio_tpu/security/audit.py``, with
the same line format; the logger is the port's own,
``alluxio_tpu_torch.audit``). Two differences:

- the writer also counts the dropped entries of denied calls
  (``dropped_denied``), so a run can show that every shed call was logged
  or counted;
- ``stop()`` drains what was accepted before it. The JAX writer's loop
  leaves as soon as the stop flag is set, so the entries still queued
  then are neither logged nor counted; an HA master stops its writer on
  every demotion. Here the thread writes every queued entry before it
  ends, and an entry appended after ``stop()`` is counted in
  ``dropped``.

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
        if self._stopped.is_set():
            self._drop(ctx)
            return
        try:
            self._queue.put_nowait(ctx)
        except queue.Full:
            self._drop(ctx)

    def _drop(self, ctx: AuditContext) -> None:
        self.dropped += 1
        if not ctx.allowed:
            self.dropped_denied += 1

    def _drain(self) -> None:
        # ends at the stop sentinel, or on an empty queue once stopped
        # (the sentinel did not fit a full queue): every entry accepted
        # before stop() is written first
        while True:
            try:
                ctx = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stopped.is_set():
                    break
                continue
            if ctx is None:
                break
            AUDIT_LOG.info("%s", ctx.format())
        # an append that raced stop() may have landed behind the sentinel
        while True:
            try:
                ctx = self._queue.get_nowait()
            except queue.Empty:
                break
            if ctx is not None:
                AUDIT_LOG.info("%s", ctx.format())

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout=2)
