"""Update checker (reference: ``core/server/master/src/main/java/
alluxio/master/meta/UpdateChecker.java`` — the periodic "is a newer
version available" heartbeat).

A copy of ``alluxio_tpu/master/update_check.py``.

Departures, on purpose: OFF by default (phone-home from a storage
master is opt-in here, where the reference ships it enabled), and the
check endpoint is a plain JSON document (``{"latest": "x.y.z"}``) at a
configurable URL rather than a hardcoded vendor service — clusters can
point it at an internal mirror.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Optional, Tuple

from alluxio_tpu_torch import __version__
from alluxio_tpu_torch.heartbeat import HeartbeatExecutor

LOG = logging.getLogger(__name__)


def _parse_version(v: str, width: int = 4) -> Tuple[int, ...]:
    """Zero-padded to ``width`` components so "1.0" == "1.0.0"."""
    parts = []
    for tok in v.strip().split("."):
        num = ""
        for ch in tok:
            if not ch.isdigit():
                break
            num += ch
        parts.append(int(num) if num else 0)
    return tuple((parts + [0] * width)[:width])


class UpdateChecker(HeartbeatExecutor):
    """One tick = one version probe; failures are logged-and-ignored
    (a storage master must never degrade because a version endpoint
    is down)."""

    def __init__(self, check_url: str, *,
                 current_version: str = __version__,
                 timeout_s: float = 10.0) -> None:
        self._url = check_url
        self._timeout = timeout_s
        self.current_version = current_version
        self.latest_version: Optional[str] = None
        self.update_available = False

    def heartbeat(self) -> None:
        if not self._url:
            return
        try:
            with urllib.request.urlopen(self._url,
                                        timeout=self._timeout) as r:
                doc = json.loads(r.read() or b"{}")
            latest = str(doc.get("latest", "")).strip() \
                if isinstance(doc, dict) else ""
        except Exception as e:  # noqa: BLE001 advisory only
            LOG.debug("update check against %s failed: %s",
                      self._url, e)
            return
        if not latest:
            return
        self.latest_version = latest
        newer = _parse_version(latest) > _parse_version(
            self.current_version)
        if newer and not self.update_available:
            LOG.info("a newer alluxio-tpu release is available: "
                     "%s (running %s)", latest, self.current_version)
        self.update_available = newer
