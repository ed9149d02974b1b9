"""Race/deadlock detection tooling — the TSAN analogue for this codebase.

The port of ``alluxio_tpu/utils/race.py``; its RWLock guard comes from
the port's own ``utils/locks.py``. Re-design of the reference's
sanitizer CI surface (SURVEY §5.2: TSAN builds + deadlock-prone
lock-order tests): Python's GIL removes data
races on plain attributes, so the remaining deadlock class worth
machine-checking is **lock-order inversion** (thread 1 holds A wants B,
thread 2 holds B wants A). ``LockOrderAuditor`` instruments chosen locks
and records the held-set every time another lock is acquired; any pair
observed in both orders — on any schedule, even one that didn't deadlock
this run — is reported with both acquisition stacks. ``Watchdog`` is the
companion hang-breaker: it dumps every thread's stack and aborts the
test instead of letting CI time out silently.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple


class _LockProxy:
    """Wraps a Lock/RLock/RWLock-ish object, reporting to the auditor."""

    def __init__(self, inner, name: str,
                 auditor: "LockOrderAuditor") -> None:
        self._inner = inner
        self._name = name
        self._auditor = auditor

    # context-manager protocol (the common usage in this codebase)
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def acquire(self, *a, **kw):
        blocking = bool(a[0] if a else kw.get("blocking", True))
        timeout = a[1] if len(a) > 1 else kw.get("timeout", -1)
        # a BOUNDED acquire (trylock or timed backoff) cannot deadlock:
        # its edge records on success only, like TSAN's try-lock rule
        bounded = (not blocking) or (
            timeout is not None and timeout >= 0)
        self._auditor._before_acquire(self._name, blocking=not bounded)
        got = self._inner.acquire(*a, **kw)
        if got:
            self._auditor._acquired(self._name, record=bounded)
        else:
            self._auditor._abandoned(self._name)
        return got

    def release(self):
        self._auditor._released(self._name)
        return self._inner.release()

    # RWLock surface (utils/locks.py): both sides audit as one node —
    # order inversions matter regardless of read/write mode
    def _rw_acquire(self, fn, *a, **kw):
        timeout = a[0] if a else kw.get("timeout")
        bounded = timeout is not None and timeout >= 0
        self._auditor._before_acquire(self._name, blocking=not bounded)
        got = fn(*a, **kw)
        if got:
            self._auditor._acquired(self._name, record=bounded)
        else:
            self._auditor._abandoned(self._name)
        return got

    def acquire_read(self, *a, **kw):
        return self._rw_acquire(self._inner.acquire_read, *a, **kw)

    def release_read(self):
        self._auditor._released(self._name)
        return self._inner.release_read()

    def acquire_write(self, *a, **kw):
        return self._rw_acquire(self._inner.acquire_write, *a, **kw)

    def release_write(self):
        self._auditor._released(self._name)
        return self._inner.release_write()

    def read_locked(self):
        from alluxio_tpu_torch.utils.locks import RWLock

        return RWLock._Guard(self.acquire_read, self.release_read)

    def write_locked(self):
        from alluxio_tpu_torch.utils.locks import RWLock

        return RWLock._Guard(self.acquire_write, self.release_write)

    def __getattr__(self, item):
        return getattr(self._inner, item)


class LockOrderAuditor:
    """Records lock-acquisition ORDER edges across threads.

    An edge ``A -> B`` means "some thread held A while acquiring B".
    Observing both ``A -> B`` and ``B -> A`` (from any threads, any
    time) proves a schedule exists that deadlocks — the same invariant
    TSAN's deadlock detector checks.
    """

    def __init__(self) -> None:
        self._held = threading.local()
        #: (held, acquiring) -> formatted stack of first observation
        self.edges: Dict[Tuple[str, str], str] = {}
        self._edges_lock = threading.Lock()

    # -- instrumentation -----------------------------------------------------
    def wrap(self, lock, name: str) -> _LockProxy:
        return _LockProxy(lock, name, self)

    def instrument_attr(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.<attr>`` with an audited proxy in place."""
        setattr(obj, attr, self.wrap(getattr(obj, attr), name))

    def _stack(self) -> List[str]:
        return getattr(self._held, "stack", None) or []

    def _record_edges(self, name: str) -> None:
        for held in self._stack():
            if held == name:
                continue  # reentrant
            key = (held, name)
            if key not in self.edges:
                with self._edges_lock:
                    self.edges.setdefault(
                        key, "".join(traceback.format_stack(limit=12)))

    def _before_acquire(self, name: str, blocking: bool = True) -> None:
        # BLOCKING acquires record their edge up front — in an actual
        # deadlock neither thread returns from acquire, and recording
        # only on success would make the auditor blind in exactly the
        # run that hangs. Non-blocking try-locks record on success only
        # (hold-A-trylock-B-backoff cannot deadlock; TSAN exempts
        # try-lock edges the same way).
        if blocking:
            self._record_edges(name)

    def _acquired(self, name: str, *, record: bool = False) -> None:
        if record:
            self._record_edges(name)
        stack = self._stack()
        stack.append(name)
        self._held.stack = stack

    def _abandoned(self, name: str) -> None:
        pass  # non-blocking acquire failed: nothing held

    def _released(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()

    # -- analysis ------------------------------------------------------------
    def inversions(self) -> List[Tuple[str, str]]:
        """Lock pairs observed in BOTH orders (a potential deadlock)."""
        seen: Set[Tuple[str, str]] = set(self.edges)
        out = []
        for a, b in seen:
            if (b, a) in seen and a < b:
                out.append((a, b))
        return sorted(out)

    def report(self) -> str:
        lines = []
        for a, b in self.inversions():
            lines.append(f"lock-order inversion: {a} <-> {b}")
            lines.append(f"-- {a} held while acquiring {b}:")
            lines.append(self.edges[(a, b)])
            lines.append(f"-- {b} held while acquiring {a}:")
            lines.append(self.edges[(b, a)])
        return "\n".join(lines)

    def assert_clean(self) -> None:
        inv = self.inversions()
        if inv:
            raise AssertionError(
                f"lock-order inversions detected: {inv}\n{self.report()}")


class Watchdog:
    """Hang-breaker: dump all thread stacks and raise after a deadline.

    Usage::

        with Watchdog(30):
            run_concurrent_workload()
    """

    def __init__(self, timeout_s: float,
                 stream=None) -> None:
        self._timeout = timeout_s
        self._stream = stream or sys.stderr
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self) -> None:
        self.fired = True
        self._stream.write(
            f"\n=== Watchdog: still running after {self._timeout}s — "
            f"thread dump ===\n")
        try:
            faulthandler.dump_traceback(file=self._stream)
        except Exception:  # noqa: BLE001
            # stream without a real fileno (StringIO): python fallback
            for tid, frame in sys._current_frames().items():
                self._stream.write(f"\n--- thread {tid} ---\n")
                self._stream.write(
                    "".join(traceback.format_stack(frame)))
        self._stream.flush()

    def __enter__(self) -> "Watchdog":
        self._timer = threading.Timer(self._timeout, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        if self.fired and exc[0] is None:
            raise TimeoutError(
                f"watchdog fired after {self._timeout}s (stacks dumped "
                f"to stderr)")
        return False
