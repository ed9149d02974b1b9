"""Span tracing with W3C trace context and sampling, and a profiler bridge.

A copy of ``alluxio_tpu/utils/tracing.py``: a process ring of completed
spans nested through a contextvar, typed phase events inside a span
(``Span.phase``), the live span (``current_span``), the drain the
metrics heartbeats ship to the master, the master's ``TraceStore`` that
keeps the shipped spans and ``stitch_spans``, which merges them with the
master's own ring into one view per trace, and ``annotate``, which names
a host region on the device timeline.

Cross-process context: every span carries a W3C-traceparent-style
context (``trace_id``, parent ``span_id``, sampled flag). Client stubs
send ``current_traceparent()`` in their RPC metadata (``rpc/core.py``)
or call frame (``rpc/fastpath.py``); servers ``bind_remote_parent()``
before opening their span, so a read that crosses client -> worker is
one trace. The sample decision is taken once, at a trace's root
(``atpu.trace.sample.rate``); every child, local or remote, inherits
it. ``atpu.trace.ring.capacity`` bounds the ring (``apply_trace_conf``).

Where the JAX package used ``jax.profiler``, ``annotate`` enters
``torch.profiler.record_function`` and ``device_trace`` runs a
``torch.profiler`` capture that it writes as a Chrome trace, so loader
stages line up with CUDA kernels.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, NamedTuple, Optional

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "atpu_torch_span", default=None)
#: inbound trace context (parsed from RPC metadata): the parent of the
#: next span opened on this thread of execution when no local span is live
_remote_parent: contextvars.ContextVar = contextvars.ContextVar(
    "atpu_torch_remote_parent", default=None)

_RING_CAP = 4096

#: RPC metadata key carrying the serialized context (gRPC metadata keys
#: must be lowercase); the JAX package's key, so the two interoperate
TRACEPARENT_KEY = "atpu-traceparent"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: The phase names a ``Span.phase()`` emit site may use (the JAX
#: package's registry): a phase is a typed slice of wall time inside one
#: span, and may overlap a child span's interval.
PHASES = (
    "queue_wait",   # waiting in an executor/dispatch queue before work ran
    "lock_wait",    # blocked acquiring a block/metadata lock
    "admission",    # QoS admission-control decision on the server
    "serialize",    # msgpack pack/unpack of RPC payloads
    "wire",         # client-observed RPC wait (network + remote service)
    "ufs_fetch",    # reading bytes out of the under-store
    "cache_fill",   # writing fetched bytes into the tiered store
    "tier_read",    # reading bytes out of a local tier
    "device_put",   # host->device transfer (shm staging / device copy)
    "drain",        # consumer draining/assembling delivered chunks
    "shm_map",      # mmap-ing a leased same-host SHM segment
    "lease_wait",   # client-observed shm_open/shm_renew lease RPC wait
    "batch_read",   # server-side scatter/gather assembly of a read_many
    "native_exec",  # GIL-free native execution of a packed read plan
    "table_plan",   # parquet footer fetch/parse + projection range planning
    "table_decode", # pyarrow decode of a planned row group's column chunks
)


class TraceContext(NamedTuple):
    """The propagated slice of a span: W3C trace-context fields."""

    trace_id: str  # 32 lowercase hex chars, not all-zero
    span_id: str   # 16 lowercase hex chars, not all-zero
    sampled: bool


#: id source: a PRNG seeded from the OS (ids need uniqueness, not
#: unpredictability), re-seeded on fork so children never mint
#: colliding ids
_ids = random.Random(int.from_bytes(os.urandom(16), "big"))
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _ids.seed(
        int.from_bytes(os.urandom(16), "big")))


def new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


def format_traceparent(ctx: TraceContext) -> str:
    """``00-<trace_id>-<span_id>-<flags>`` (W3C traceparent, version 00)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a traceparent header; None on anything malformed (a bad
    header degrades to 'new root trace', never to an error)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(str(value).strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, bool(int(flags, 16) & 1))


def current_trace_context() -> Optional[TraceContext]:
    """The context a child span (or outbound RPC) should join: the live
    local span first, else an inbound remote parent."""
    span = _current_span.get()
    if span is not None:
        return TraceContext(span.trace_id, span.span_id, span.sampled)
    return _remote_parent.get()


def current_traceparent() -> Optional[str]:
    """Serialized context for RPC injection; None when tracing is off or
    nothing is being traced (so the metadata stays untouched)."""
    if not _TRACER.enabled:
        return None
    ctx = current_trace_context()
    return None if ctx is None else format_traceparent(ctx)


def bind_remote_parent(header: Optional[str]):
    """Bind an inbound traceparent as this execution's parent context.
    Returns a reset token (None when the header is absent or invalid)."""
    ctx = parse_traceparent(header)
    if ctx is None:
        return None
    return _remote_parent.set(ctx)


def reset_remote_parent(token) -> None:
    if token is not None:
        _remote_parent.reset(token)


class Span:
    __slots__ = ("name", "start_ms", "duration_ms", "parent", "span_id",
                 "trace_id", "sampled", "tags", "thread", "error",
                 "phases")

    def __init__(self, name: str, span_id: str, parent: Optional[str],
                 trace_id: str, sampled: bool = True) -> None:
        self.name = name
        self.span_id = span_id
        self.parent = parent
        self.trace_id = trace_id
        self.sampled = sampled
        self.start_ms = time.time() * 1000.0
        self.duration_ms: Optional[float] = None
        self.tags: Dict[str, str] = {}
        self.thread = threading.current_thread().name
        self.error: Optional[str] = None
        #: typed phase events [(name, duration_ms)], allocated lazily
        self.phases: Optional[list] = None

    def phase(self, name: str, duration_ms: float) -> None:
        """Record a typed phase event (one of ``PHASES``) inside this
        span. Call sites guard on ``current_span() is not None``, so the
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
        #: probability a NEW ROOT trace is recorded; children (local and
        #: remote) inherit their parent's decision so traces never tear
        self.sample_rate = 1.0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def configure(self, *, capacity: Optional[int] = None,
                  sample_rate: Optional[float] = None) -> None:
        if sample_rate is not None:
            self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        if capacity is not None and capacity != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def _sample(self) -> bool:
        rate = self.sample_rate
        return rate >= 1.0 or (rate > 0.0 and random.random() < rate)

    def span(self, name: str, **tags: str):
        """Context manager recording one span (yields None when disabled)."""
        return _SpanCtx(self, name, tags)

    def record(self, span: Span) -> None:
        """Add a span finished outside the context manager."""
        self._ring.append(span)

    def snapshot(self, limit: int = 500,
                 prefix: str = "") -> List[dict]:
        """Most-recent-first dump of completed spans."""
        out = []
        # atomic copy first: iterating the live deque races concurrent
        # record() appends ("deque mutated during iteration")
        for s in reversed(list(self._ring)):
            if prefix and not s.name.startswith(prefix):
                continue
            out.append(s.to_dict())
            if len(out) >= limit:
                break
        return out

    def drain(self, limit: int = 500) -> List[dict]:
        """Pop up to ``limit`` completed spans, oldest first (the
        metrics heartbeat ships them to the master)."""
        out: List[dict] = []
        while len(out) < limit:
            try:
                out.append(self._ring.popleft().to_dict())
            except IndexError:
                break
        return out

    def clear(self) -> None:
        self._ring.clear()


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
        ctx = current_trace_context()
        if ctx is not None:
            trace_id, parent_id, sampled = ctx
        else:  # new root: this is where the sampling decision lands
            trace_id, parent_id = new_trace_id(), None
            sampled = self._tracer._sample()
        self._span = Span(self._name, new_span_id(), parent_id, trace_id,
                          sampled)
        if self._tags:
            self._span.tags.update(
                {k: str(v) for k, v in self._tags.items()})
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
            if self._span.sampled:
                self._tracer.record(self._span)
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


def apply_trace_conf(conf) -> None:
    """Apply ``atpu.trace.sample.rate`` / ``atpu.trace.ring.capacity``
    to the process tracer (the enabled flag stays with the caller: the
    client only ever turns tracing on, servers set it absolutely)."""
    from alluxio_tpu_torch.conf import Keys

    _TRACER.configure(
        capacity=conf.get_int(Keys.TRACE_RING_CAPACITY),
        sample_rate=conf.get_float(Keys.TRACE_SAMPLE_RATE))


# -- master-side stitching ---------------------------------------------------
class TraceStore:
    """Spans shipped from remote processes (workers/clients drain their
    rings on the metrics heartbeat), deduplicated by (trace_id, span_id)
    so an in-process cluster — where every role shares one ring — never
    double-serves a span the reporter also shipped."""

    def __init__(self, capacity: int = 8192) -> None:
        self._ring: deque = deque(maxlen=capacity)
        self._seen: "OrderedDict[tuple, bool]" = OrderedDict()
        self._seen_cap = capacity * 2
        self._lock = threading.Lock()

    def ingest(self, source: str, spans: Optional[List[dict]]) -> int:
        n = 0
        with self._lock:
            for s in spans or ():
                if not isinstance(s, dict):
                    continue
                key = (s.get("trace_id"), s.get("span_id"))
                if key in self._seen:
                    continue
                self._seen[key] = True
                while len(self._seen) > self._seen_cap:
                    self._seen.popitem(last=False)
                d = dict(s)
                d.setdefault("source", source)
                self._ring.append(d)
                n += 1
        return n

    def snapshot(self, limit: int = 500, prefix: str = "",
                 trace_id: str = "") -> List[dict]:
        with self._lock:
            items = list(self._ring)
        out = []
        for s in reversed(items):
            if prefix and not str(s.get("name", "")).startswith(prefix):
                continue
            if trace_id and s.get("trace_id") != trace_id:
                continue
            out.append(s)
            if len(out) >= limit:
                break
        return out

    def span_count(self) -> int:
        with self._lock:
            return len(self._ring)


def stitch_spans(store: Optional[TraceStore], *, limit: int = 500,
                 prefix: str = "", trace_id: str = "",
                 local_source: str = "local") -> dict:
    """Merge the process-local ring with remotely-shipped spans into one
    view: a flat most-recent-first span list plus a per-trace summary
    (what ``/api/v1/master/trace`` and ``fsadmin trace`` serve)."""
    spans: List[dict] = []
    seen = set()
    # a trace_id filter scans the whole ring: the wanted trace's spans
    # may sit past the first `limit` recent spans of OTHER traces
    # (the ACTUAL configured capacity, not the default constant)
    scan = max(limit, _TRACER._ring.maxlen or _RING_CAP) \
        if trace_id else limit
    local = _TRACER.snapshot(limit=scan, prefix=prefix)
    for s in local:
        if trace_id and s.get("trace_id") != trace_id:
            continue
        s = dict(s)
        s.setdefault("source", local_source)
        seen.add((s.get("trace_id"), s.get("span_id")))
        spans.append(s)
    if store is not None:
        for s in store.snapshot(limit=limit, prefix=prefix,
                                trace_id=trace_id):
            key = (s.get("trace_id"), s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            spans.append(s)
    spans.sort(key=lambda s: s.get("start_ms") or 0.0, reverse=True)
    del spans[limit:]
    return {"spans": spans, "traces": summarize_traces(spans)}


def summarize_traces(spans: List[dict]) -> List[dict]:
    """Per-trace rollup of a most-recent-first span list (span count,
    contributing sources, root name, wall duration). Shared by
    :func:`stitch_spans` and the HA fan-out merge."""
    traces: "OrderedDict[str, dict]" = OrderedDict()
    for s in spans:
        tid = s.get("trace_id")
        if not tid:
            continue
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = {"trace_id": tid, "spans": 0,
                               "sources": [], "root": None,
                               "start_ms": None, "end_ms": None}
        t["spans"] += 1
        src = s.get("source")
        if src and src not in t["sources"]:
            t["sources"].append(src)
        if s.get("parent") is None:
            t["root"] = s.get("name")
        start = s.get("start_ms")
        if start is not None:
            end = start + (s.get("duration_ms") or 0.0)
            t["start_ms"] = start if t["start_ms"] is None \
                else min(t["start_ms"], start)
            t["end_ms"] = end if t["end_ms"] is None \
                else max(t["end_ms"], end)
    for t in traces.values():
        t["duration_ms"] = None if t["start_ms"] is None \
            else round(t["end_ms"] - t["start_ms"], 3)
        t.pop("end_ms", None)
    return list(traces.values())


# -- device-side bridge -------------------------------------------------------
class device_trace:
    """Capture a ``torch.profiler`` trace of what the host and, when a
    card is present, the card do inside the block, written as a Chrome
    trace file into ``log_dir`` on exit (``path``). Usage::

        with device_trace("traces") as t:
            train_step(...)
            torch.cuda.synchronize()
        print(t.path)

    ``profile`` is the finished ``torch.profiler.profile`` (its
    ``key_averages()`` splits host and device time by kernel)."""

    def __init__(self, log_dir: str) -> None:
        self._dir = log_dir
        self.profile = None
        self.path: Optional[str] = None

    def __enter__(self) -> "device_trace":
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.profile.__exit__(*exc)
        os.makedirs(self._dir, exist_ok=True)
        self.path = os.path.join(
            self._dir, f"atpu-trace-{os.getpid()}-{time.time_ns()}.json")
        self.profile.export_chrome_trace(self.path)
        return False


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
