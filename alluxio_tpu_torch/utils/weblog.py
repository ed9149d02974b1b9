"""In-memory ring buffer of recent log records for the web UIs (a copy
of ``alluxio_tpu/utils/weblog.py``).

The reference's logs pages tail log4j files; this build logs wherever
the operator pointed ``logging`` (stderr, files, the logserver), so the
dashboards serve a bounded in-process ring instead of guessing at file
paths — same operator value (recent events, one click) with no
filesystem coupling.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, List

_LOCK = threading.Lock()
_HANDLER = None


class RingHandler(logging.Handler):
    def __init__(self, capacity: int = 2000) -> None:
        super().__init__(level=logging.INFO)
        self.records: deque = deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — never break logging
            msg = str(record.msg)
        self.records.append({
            "ts_ms": int(record.created * 1000),
            "level": record.levelname,
            "logger": record.name,
            "message": msg,
        })


def install() -> RingHandler:
    """Attach the ring to the root logger once; returns it."""
    global _HANDLER
    with _LOCK:
        if _HANDLER is None:
            _HANDLER = RingHandler()
            logging.getLogger().addHandler(_HANDLER)
        return _HANDLER


def tail(n: int = 200, level: str = "") -> List[Dict]:
    h = install()
    records = list(h.records)
    if level:
        want = level.upper()
        order = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40,
                 "CRITICAL": 50}
        floor = order.get(want, 0)
        records = [r for r in records
                   if order.get(r["level"], 0) >= floor]
    return records[-max(1, min(n, 2000)):]


def mark(msg: str) -> None:
    """Convenience for tests: land one record in the ring (warning
    level: the root logger's default level would drop INFO before any
    handler sees it)."""
    logging.getLogger("alluxio_tpu_torch.weblog").warning(msg)
