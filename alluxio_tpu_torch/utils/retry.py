"""Retry policies: the part of ``alluxio_tpu/utils/retry.py`` the port's
RPC clients use — ``ExponentialTimeBoundedRetry`` and the functional
``retry()`` helper that understands the typed exception codes and the
master's leader hints."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from alluxio_tpu_torch.utils.exceptions import AlluxioTpuError, RETRYABLE_CODES

#: jitter source shared by all policies (random.Random methods are
#: atomic in CPython; contention is not a concern for backoff jitter)
_SHARED_RNG = random.Random()

T = TypeVar("T")


class RetryPolicy:
    """Iterator-style policy: call ``attempt()`` before each try."""

    def attempt(self) -> bool:
        raise NotImplementedError

    @property
    def attempt_count(self) -> int:
        raise NotImplementedError


class ExponentialTimeBoundedRetry(RetryPolicy):
    """Exponential backoff with full jitter, bounded by wall-clock
    duration (reference: ``ExponentialTimeBoundedRetry.java``)."""

    def __init__(self, max_duration_s: float, base_sleep_s: float,
                 max_sleep_s: float,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None) -> None:
        self._deadline = time_fn() + max_duration_s
        self._base = base_sleep_s
        self._max_sleep = max_sleep_s
        self._time_fn = time_fn
        self._sleep_fn = sleep_fn
        self._rng = rng or _SHARED_RNG
        self._count = 0
        self._retry_after_s = 0.0
        self._redirect = False
        self._free_redirects = 3

    def note_retry_after(self, hint_s: float) -> None:
        """Server-supplied backoff hint: the NEXT sleep is at least this
        long."""
        self._retry_after_s = max(0.0, float(hint_s))

    def note_redirect(self) -> None:
        """Leader-hint redirect: the failed attempt named the master to
        try, so the NEXT attempt runs at once, without sleeping or
        counting as an attempt. Three a policy: a loop between two
        masters that each name the other then backs off as usual."""
        if self._free_redirects > 0:
            self._free_redirects -= 1
            self._redirect = True

    def attempt(self) -> bool:
        now = self._time_fn()
        if self._count == 0:
            self._count = 1
            return True
        if now >= self._deadline:
            return False
        if self._redirect:
            self._redirect = False
            return True
        backoff = min(self._max_sleep, self._base * (2 ** (self._count - 1)))
        hint, self._retry_after_s = self._retry_after_s, 0.0
        sleep = min(max(hint, backoff * self._rng.random()),
                    max(0.0, self._deadline - now))
        self._sleep_fn(sleep)
        self._count += 1
        return True

    @property
    def attempt_count(self) -> int:
        return self._count


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, AlluxioTpuError):
        if exc.code in RETRYABLE_CODES:
            return True
        # an admission-shed RPC (RESOURCE_EXHAUSTED + retry-after hint)
        # is transient overload; a hint-less RESOURCE_EXHAUSTED (worker
        # out of space...) is a terminal answer
        return exc.retry_after_s is not None
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


def retry(fn: Callable[[], T], policy: RetryPolicy,
          retry_on: Callable[[BaseException], bool] = is_retryable) -> T:
    """Run ``fn`` under ``policy``; re-raise the last error when
    exhausted. A typed error carrying ``retry_after_s`` feeds the hint to
    policies that can honor it, and one naming the primary
    (``NotPrimaryError.leader``) is retried there at once (reference:
    ``retry/RetryUtils.java``)."""
    last: Optional[BaseException] = None
    note = getattr(policy, "note_retry_after", None)
    note_redirect = getattr(policy, "note_redirect", None)
    while policy.attempt():
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - filtered by retry_on
            if not retry_on(e):
                raise
            last = e
            hint = getattr(e, "retry_after_s", None)
            if hint and note is not None:
                note(hint)
            if getattr(e, "leader", None) and note_redirect is not None:
                note_redirect()
    if last is None:
        raise RuntimeError("retry policy allowed no attempt")
    raise last
