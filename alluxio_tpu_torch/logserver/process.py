"""Log server: one process aggregating every role's logs (a copy of
``alluxio_tpu/logserver/process.py``).

Re-design of ``logserver/src/main/java/alluxio/logserver/
{AlluxioLogServer,AlluxioLogServerProcess}.java``: cluster processes
attach a socket handler that ships log records to this server, which
writes one file per source under its logs dir — the reference's
log4j SocketAppender -> per-client file layout, on Python's stdlib
``logging.handlers.SocketHandler`` wire format (4-byte length prefix +
pickled record dict).
"""

from __future__ import annotations

import io
import logging
import logging.handlers
import os
import pickle
import socketserver
import struct
import threading
from typing import Dict, Optional

LOG = logging.getLogger(__name__)


class _RestrictedUnpickler(pickle.Unpickler):
    """Log records are dicts of primitives: refuse EVERY global
    lookup, so a crafted __reduce__ payload cannot execute code
    (pickle over a network port is otherwise an RCE primitive)."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"global {module}.{name} is forbidden in log records")


def _safe_loads(payload: bytes):
    return _RestrictedUnpickler(io.BytesIO(payload)).load()


class _RecordHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        src = self.client_address[0]
        while True:
            head = self.rfile.read(4)
            if len(head) < 4:
                return
            (n,) = struct.unpack(">L", head)
            payload = self.rfile.read(n)
            if len(payload) < n:
                return
            try:
                rec = logging.makeLogRecord(_safe_loads(payload))
            except Exception:  # noqa: BLE001 corrupt frame: drop conn
                LOG.warning("bad log frame from %s", src)
                return
            self.server.owner.write_record(src, rec)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    owner: "LogServerProcess" = None


class LogServerProcess:
    """Receives records, writes ``<dir>/<source-host>.log``."""

    def __init__(self, logs_dir: str, *, port: int = 0,
                 bind_host: str = "127.0.0.1") -> None:
        """Default bind is loopback: the record stream carries no
        authentication; bind wider only inside a trusted network
        (same stance as the S3 proxy)."""
        self._dir = logs_dir
        os.makedirs(logs_dir, exist_ok=True)
        self._server = _Server((bind_host, port), _RecordHandler)
        self._server.owner = self
        self.port = self._server.server_address[1]
        self._files: Dict[str, logging.Handler] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._fmt = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s [%(_src)s] %(message)s")

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="logserver",
            daemon=True)
        self._thread.start()
        LOG.info("log server on port %d -> %s", self.port, self._dir)
        return self.port

    def write_record(self, src: str, rec: logging.LogRecord) -> None:
        rec._src = src
        with self._lock:
            h = self._files.get(src)
            if h is None:
                h = logging.FileHandler(
                    os.path.join(self._dir, f"{src}.log"))
                h.setFormatter(self._fmt)
                self._files[src] = h
        h.handle(rec)  # handle() takes the handler's own I/O lock

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            for h in self._files.values():
                h.close()
            self._files.clear()


def enable_remote_logging(host: str, port: int, *,
                          level: int = logging.INFO,
                          logger_name: str = "") -> logging.Handler:
    """Attach a SocketHandler shipping this process's records to the log
    server (the reference's log4j RemoteAppender wiring). Returns the
    handler so callers can detach it."""
    handler = logging.handlers.SocketHandler(host, port)
    handler.setLevel(level)
    logging.getLogger(logger_name or None).addHandler(handler)
    return handler
