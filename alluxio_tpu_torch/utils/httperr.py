"""Safe reading of HTTP error bodies (a copy of
``alluxio_tpu/utils/httperr.py``).

``HTTPError.read()`` performs real socket IO and can itself raise
(connection reset, timed-out file object) — an exception thrown inside
an ``except HTTPError`` handler escapes the caller's error translation
entirely, turning a well-typed connector error into a raw ``OSError``
(observed: Glue 403 under load surfacing as ``ConnectionResetError``).
Every connector's handler reads bodies through this helper instead.
"""

from __future__ import annotations

import urllib.error


def error_body(e: urllib.error.HTTPError, *, limit: int = 400) -> str:
    """Best-effort decode of an HTTP error response body; never
    raises."""
    try:
        return e.read().decode(errors="replace")[:limit]
    except Exception:  # noqa: BLE001 — body is diagnostic only
        return f"(body unreadable; status {e.code})"


def drain(e: urllib.error.HTTPError) -> None:
    """Consume an error body for connection reuse; never raises."""
    try:
        e.read()
    except Exception:  # noqa: BLE001
        pass
