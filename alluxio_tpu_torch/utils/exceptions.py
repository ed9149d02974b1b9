"""Typed exception hierarchy: a copy of ``alluxio_tpu/utils/exceptions.py``.

Re-design of the reference's exception hierarchy
(``core/base/src/main/java/alluxio/exception/``) plus its gRPC status
mapping (``exception/status/``). Each exception carries a wire-stable
``code``, and the class names are the JAX package's, so a typed error
crosses an RPC boundary between the two packages as the same class.
"""

from __future__ import annotations

import logging
from typing import Optional


class AlluxioTpuError(Exception):
    """Base class; ``code`` is the wire-stable status name.

    ``retry_after_s`` (optional, set by admission control when it sheds
    an RPC) survives the wire round trip so the client-side retry
    policy can honor the server's backoff hint instead of hammering."""

    code = "INTERNAL"
    retry_after_s: Optional[float] = None
    #: HA redirect hint: the current primary's client RPC address, set by
    #: a standby master shedding a non-read RPC (NotPrimaryError).  The
    #: multi-endpoint client follows it without consuming a retry attempt.
    leader: Optional[str] = None
    #: set on errors a STANDBY raised while serving a read: the answer
    #: reflects bounded-stale state (e.g. NOT_FOUND for a path the
    #: primary just acked).  A strong multi-endpoint client retries such
    #: errors on the primary instead of trusting them (docs/ha.md).
    standby: bool = False

    def to_wire(self) -> dict:
        d = {"code": self.code, "message": str(self),
             "type": type(self).__name__}
        if self.retry_after_s is not None:
            d["retry_after_s"] = float(self.retry_after_s)
        if self.leader is not None:
            d["leader"] = str(self.leader)
        if self.standby:
            d["standby"] = True
        return d

    @staticmethod
    def from_wire(d: dict) -> "AlluxioTpuError":
        cls = _BY_NAME.get(d.get("type"), None)
        if cls is None:
            cls = _BY_CODE.get(d.get("code"), AlluxioTpuError)
        e = cls(d.get("message", ""))
        ra = d.get("retry_after_s")
        if ra is not None:
            e.retry_after_s = float(ra)
        ld = d.get("leader")
        if ld is not None:
            e.leader = str(ld)
        if d.get("standby"):
            e.standby = True
        return e


class FileDoesNotExistError(AlluxioTpuError):
    code = "NOT_FOUND"


class BlockDoesNotExistError(AlluxioTpuError):
    code = "NOT_FOUND"


class FileAlreadyExistsError(AlluxioTpuError):
    code = "ALREADY_EXISTS"


class FileAlreadyCompletedError(AlluxioTpuError):
    code = "FAILED_PRECONDITION"


class FileIncompleteError(AlluxioTpuError):
    code = "FAILED_PRECONDITION"


class DirectoryNotEmptyError(AlluxioTpuError):
    code = "FAILED_PRECONDITION"


class InvalidPathError(AlluxioTpuError):
    code = "INVALID_ARGUMENT"


class InvalidArgumentError(AlluxioTpuError):
    code = "INVALID_ARGUMENT"


class PermissionDeniedError(AlluxioTpuError):
    code = "PERMISSION_DENIED"


class UnauthenticatedError(AlluxioTpuError):
    code = "UNAUTHENTICATED"


class NotFoundError(AlluxioTpuError):
    code = "NOT_FOUND"


class AlreadyExistsError(AlluxioTpuError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(AlluxioTpuError):
    code = "RESOURCE_EXHAUSTED"


class WorkerOutOfSpaceError(ResourceExhaustedError):
    pass


class FailedPreconditionError(AlluxioTpuError):
    code = "FAILED_PRECONDITION"


class UnavailableError(AlluxioTpuError):
    """Transient; retryable (master in safe mode, worker not registered...)."""

    code = "UNAVAILABLE"


class SafeModeError(UnavailableError):
    pass


class DeadlineExceededError(AlluxioTpuError):
    code = "DEADLINE_EXCEEDED"


class CancelledError(AlluxioTpuError):
    code = "CANCELLED"


class AbortedError(AlluxioTpuError):
    code = "ABORTED"


class NotSupportedError(AlluxioTpuError):
    code = "UNIMPLEMENTED"


class UfsError(AlluxioTpuError):
    code = "INTERNAL"


class JournalClosedError(UnavailableError):
    pass


class NotPrimaryError(UnavailableError):
    """A standby master refusing a write/non-idempotent RPC.  Carries
    ``leader`` (the current primary's client address, when known) so the
    multi-endpoint client can redirect instead of blind-rotating; code
    UNAVAILABLE keeps it transparently retryable for idempotent ops."""

    def __init__(self, message: str = "", *,
                 leader: Optional[str] = None) -> None:
        super().__init__(message or "this master is not the primary")
        if leader:
            self.leader = str(leader)


class BackupError(AlluxioTpuError):
    code = "INTERNAL"


class JobDoesNotExistError(NotFoundError):
    pass


class ConnectionFailedError(UnavailableError):
    pass


class RegisterLeaseNotFoundError(UnavailableError):
    pass


_ALL = [v for v in list(globals().values())
        if isinstance(v, type) and issubclass(v, AlluxioTpuError)]
_BY_NAME = {c.__name__: c for c in _ALL}
_BY_CODE = {c.code: c for c in reversed(_ALL)}


def register_wire_error(cls: type) -> type:
    """Register an :class:`AlluxioTpuError` subclass defined OUTSIDE this
    module in the wire-serialization map, so :meth:`AlluxioTpuError.
    from_wire` reconstructs the exact type instead of degrading to the
    nearest base class (which silently breaks client-side
    ``except SpecificError`` across RPC).  Usable as a decorator.
    The ``wire-error-unregistered`` lint rule enforces this."""
    _BY_NAME[cls.__name__] = cls
    return cls


#: Status codes that a retry policy should treat as transient.
RETRYABLE_CODES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED"})


def best_effort(what: str, fn, *args, log: Optional[logging.Logger] = None,
                **kwargs):
    """Run a cleanup/notification step that must never mask the primary
    error path: failures are logged at DEBUG and swallowed.  Replaces
    bare ``try: ... except Exception: pass`` blocks (which the
    ``except-swallow`` lint rule rejects on server paths) with one
    audited idiom."""
    try:
        return fn(*args, **kwargs)
    except Exception:  # noqa: BLE001 - by contract: log and move on
        (log or logging.getLogger(
            getattr(fn, "__module__", None) or __name__)).debug(
            "best-effort %s failed", what, exc_info=True)
        return None
