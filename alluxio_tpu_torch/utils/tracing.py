"""Span tracing for the device data plane, with a profiler bridge.

The subset of ``alluxio_tpu/utils/tracing.py`` that the loader uses: a
process ring of completed spans nested through a contextvar, typed phase
events inside a span (``Span.phase``), the live span (``current_span``),
and ``annotate``, which names a host region on the device timeline. Where
the JAX package used ``jax.profiler.TraceAnnotation``, ``annotate`` enters
``torch.profiler.record_function``, so loader stages line up with CUDA
kernels in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "atpu_torch_span", default=None)

_RING_CAP = 4096

_ids = random.Random()


class Span:
    __slots__ = ("name", "start_ms", "duration_ms", "parent", "span_id",
                 "trace_id", "tags", "thread", "error", "phases")

    def __init__(self, name: str, span_id: str, parent: Optional[str],
                 trace_id: str) -> None:
        self.name = name
        self.span_id = span_id
        self.parent = parent
        self.trace_id = trace_id
        self.start_ms = time.time() * 1000.0
        self.duration_ms: Optional[float] = None
        self.tags: Dict[str, str] = {}
        self.thread = threading.current_thread().name
        self.error: Optional[str] = None
        #: typed phase events [(name, duration_ms)], allocated lazily
        self.phases: Optional[list] = None

    def phase(self, name: str, duration_ms: float) -> None:
        """Record a typed phase event (the JAX package's phase names:
        the loader records ``device_put`` and ``drain``) inside this span.
        Call sites guard on ``current_span() is not None``, so the
        tracing-disabled path never reaches here."""
        p = self.phases
        if p is None:
            p = self.phases = []
        p.append((name, duration_ms))

    def to_dict(self) -> dict:
        d = {"name": self.name, "span_id": self.span_id,
             "parent": self.parent, "trace_id": self.trace_id,
             "start_ms": round(self.start_ms, 3),
             "duration_ms": None if self.duration_ms is None
             else round(self.duration_ms, 3),
             "thread": self.thread, "tags": self.tags, "error": self.error}
        if self.phases:
            d["phases"] = [[n, round(ms, 3)] for n, ms in self.phases]
        return d


class Tracer:
    """Process tracer: bounded ring of completed spans, off by default."""

    def __init__(self, capacity: int = _RING_CAP) -> None:
        self.enabled = False
        self._ring: deque = deque(maxlen=capacity)

    def span(self, name: str, **tags: str):
        """Context manager recording one span (yields None when disabled)."""
        return _SpanCtx(self, name, tags)

    def snapshot(self, limit: int = 500) -> List[dict]:
        """Most-recent-first dump of completed spans."""
        return [s.to_dict() for s in reversed(list(self._ring))][:limit]


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_tags", "_span", "_token", "_t0")

    def __init__(self, tracer: Tracer, name: str,
                 tags: Dict[str, str]) -> None:
        self._tracer = tracer
        self._name = name
        self._tags = tags
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Optional[Span]:
        if not self._tracer.enabled:
            return None
        parent = _current_span.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = f"{_ids.getrandbits(128):032x}", None
        self._span = Span(self._name, f"{_ids.getrandbits(64):016x}",
                          parent_id, trace_id)
        self._span.tags.update({k: str(v) for k, v in self._tags.items()})
        self._token = _current_span.set(self._span)
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None:
            self._span.duration_ms = \
                (time.perf_counter() - self._t0) * 1000.0
            if exc is not None:
                self._span.error = f"{type(exc).__name__}: {exc}"
            _current_span.reset(self._token)
            self._tracer._ring.append(self._span)
        return False


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def current_span() -> Optional[Span]:
    """The live span on this thread of execution; None when tracing is
    off or the caller is outside any span."""
    return _current_span.get()


def set_tracing_enabled(on: bool) -> None:
    _TRACER.enabled = bool(on)


def annotate(name: str):
    """Name a host region on the device timeline
    (``torch.profiler.record_function``: a no-op outside an active
    profile) and record a host span when tracing is enabled."""
    import torch

    @contextlib.contextmanager
    def both() -> Iterator[None]:
        with _TRACER.span(name):
            with torch.profiler.record_function(name):
                yield

    return both()
