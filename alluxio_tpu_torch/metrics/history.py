"""Bounded metrics-history store: the time dimension of observability (a
copy of ``alluxio_tpu/metrics/history.py``).

The master's :class:`~alluxio_tpu_torch.master.metrics_master.MetricsStore`
keeps only the *latest* snapshot per source, so "when did the stall
fraction spike" / "is the hit ratio degrading" are unanswerable.  This
module keeps per-``(source, metric)`` rings of ``(ts, value)`` samples
fed from the existing metrics heartbeat, with tiered downsampling
(raw -> 1m -> 10m rollups), counter->rate derivation at query time, and
hard memory bounds (capacity per ring, a series cap, and a name-prefix
allowlist against cardinality floods).

Ingestion is **two-phase** so the heartbeat RPC path stays O(1): the
handler calls :meth:`MetricsHistory.offer` (one deque append — the
snapshot dict is reused, never copied), and the actual ring/rollup work
happens in :meth:`drain`, invoked from the master's health heartbeat
and from every query surface.  ``make bench-health`` gates the offer
path at <5% heartbeat-handling overhead.

Reference vocabulary: the Java master's ``MetricsTimeSeriesStore`` kept
a small fixed set of cluster series; this store generalizes it to every
allowlisted metric, per source, because time-resolved per-tier
telemetry is what diagnosing DL input pipelines actually needs
(arXiv:2301.01494).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: rollup tiers: (label, bucket width seconds, retention multiple of
#: the raw retention) — coarser tiers survive longer so a day of 10m
#: buckets outlives an hour of raw points under the same capacity cap
ROLLUPS: Tuple[Tuple[str, float, float], ...] = (
    ("1m", 60.0, 10.0),
    ("10m", 600.0, 60.0),
)

RESOLUTIONS = ("raw",) + tuple(label for label, _, _ in ROLLUPS)


class _Bucket:
    """One rollup bucket: running count/sum/min/max plus the last raw
    value (the counter-rate path reads ``last``, the gauge path reads
    ``mean``)."""

    __slots__ = ("start", "count", "sum", "min", "max", "last")

    def __init__(self, start: float, value: float) -> None:
        self.start = start
        self.count = 1
        self.sum = value
        self.min = value
        self.max = value
        self.last = value

    def add(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.last = value

    def to_dict(self) -> dict:
        return {"ts": self.start, "count": self.count,
                "sum": self.sum, "mean": self.sum / self.count,
                "min": self.min, "max": self.max, "last": self.last}


class _Series:
    """One (source, metric) series.  The raw ring is a pair of packed
    ``array('d')`` circular buffers, NOT a deque of tuples: at the
    cardinality this store is bounded for (thousands of series x
    hundreds of points) per-point tuple objects made every Python GC
    pass measurably slower — which billed the history's cost to the
    heartbeat hot path.  Packed doubles are invisible to the GC and 4x
    smaller."""

    __slots__ = ("_ts", "_v", "_head", "_n", "_cap", "rollups",
                 "ended_at", "last_ts")

    def __init__(self, capacity: int) -> None:
        from array import array

        self._cap = capacity
        self._ts = array("d")
        self._v = array("d")
        self._head = 0  # index of the oldest live sample
        self._n = 0     # live sample count
        self.rollups: Dict[str, deque] = {
            label: deque(maxlen=capacity) for label, _, _ in ROLLUPS}
        #: set when the source was declared dead (worker lost) — an
        #: explicit end marker instead of silent staleness; cleared
        #: only by revive_source (block-master re-registration), never
        #: by metrics arrival: a lost worker whose metrics heartbeat
        #: outlives its block-sync thread is still dead to the cluster
        self.ended_at: Optional[float] = None
        #: newest sample timestamp ever ingested — drives reclamation
        #: of series whose source silently vanished (clients have no
        #: lost-worker event, so idleness is their only death signal)
        self.last_ts = 0.0

    def add(self, ts: float, value: float) -> None:
        if ts > self.last_ts:
            self.last_ts = ts
        if len(self._ts) < self._cap:
            # growing phase: the ring has never wrapped, so appending
            # keeps time order even after left-prunes advanced head
            self._ts.append(ts)
            self._v.append(value)
            self._n += 1
        else:
            i = (self._head + self._n) % self._cap
            self._ts[i] = ts
            self._v[i] = value
            if self._n == self._cap:
                self._head = (self._head + 1) % self._cap
            else:
                self._n += 1
        for label, width, _ in ROLLUPS:
            ring = self.rollups[label]
            start = ts - (ts % width)
            if ring and ring[-1].start == start:
                ring[-1].add(value)
            elif ring and ring[-1].start > start:
                pass  # out-of-order past a bucket boundary: drop
            else:
                ring.append(_Bucket(start, value))

    def raw_points(self) -> List[Tuple[float, float]]:
        """Live samples oldest-first as (ts, value) pairs."""
        ts, v, head, n = self._ts, self._v, self._head, self._n
        size = len(ts)
        if n == 0:
            return []
        if head + n <= size:
            return list(zip(ts[head:head + n], v[head:head + n]))
        k = size - head
        return list(zip(ts[head:], v[head:])) + \
            list(zip(ts[:n - k], v[:n - k]))

    def raw_len(self) -> int:
        return self._n

    def prune(self, now: float, retention_s: float) -> None:
        size = len(self._ts)
        while self._n and now - self._ts[self._head] > retention_s:
            self._head = (self._head + 1) % size if size == self._cap \
                else self._head + 1
            self._n -= 1
        for label, _, keep_mult in ROLLUPS:
            ring = self.rollups[label]
            horizon = retention_s * keep_mult
            while ring and now - ring[0].start > horizon:
                ring.popleft()

    def points(self) -> int:
        return self._n + sum(len(r) for r in self.rollups.values())


def derive_rate(points: List[Tuple[float, float]]
                ) -> List[Tuple[float, float]]:
    """Counter series -> per-second rate between consecutive samples.
    A negative delta is a counter reset (process restart): clamp to 0
    rather than emitting a huge negative spike."""
    out: List[Tuple[float, float]] = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        dt = t1 - t0
        if dt <= 0:
            continue
        out.append((t1, max(0.0, v1 - v0) / dt))
    return out


class MetricsHistory:
    """Bounded per-(source, metric) time series with tiered rollups."""

    def __init__(self, *, capacity: int = 360,
                 retention_s: float = 3600.0,
                 max_series: int = 4096,
                 allow_prefixes: Tuple[str, ...] = (
                     "Cluster.", "Master.", "Worker.", "Client.",
                     "JobMaster.", "JobWorker.", "Process."),
                 pending_max: int = 1024,
                 clock: Callable[[], float] = time.time) -> None:
        self.capacity = max(2, int(capacity))
        self.retention_s = float(retention_s)
        self.max_series = max(1, int(max_series))
        self.allow_prefixes = tuple(allow_prefixes)
        self._clock = clock
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._lock = threading.Lock()
        #: heartbeat hot path appends here (O(1), no lock beyond the
        #: deque's own); drain() does the real work off the RPC path
        self._pending: deque = deque()
        self._pending_max = max(1, int(pending_max))
        self._pending_lock = threading.Lock()
        self.dropped_samples = 0  # series-cap / allowlist rejections
        self.dropped_ticks = 0    # pending-queue overflow
        self._last_prune = 0.0
        self._evict_scan_ts = float("-inf")
        #: source -> end-marker ts (worker declared lost); cleared only
        #: by revive_source on block-master re-registration (NOT by
        #: metrics arrival — a worker whose metrics heartbeat outlives
        #: its wedged block-sync thread is lost-but-chatty and must
        #: keep alerting), aged out with retention — feeds the
        #: worker-lost health rule so a death outlives the TTL'd
        #: snapshot instead of silently resolving back to OK
        self._ended_sources: Dict[str, float] = {}

    # ------------------------------------------------------------ ingest
    def offer(self, source: str, metrics: Dict[str, float],
              now: Optional[float] = None) -> None:
        """O(1) hand-off from the heartbeat path.  The caller's dict is
        referenced, not copied — heartbeat snapshots are never mutated
        after shipping.  Kept to two attribute loads + one append: this
        is the only history cost the RPC path pays (bench-health gates
        it at <5% of heartbeat handling)."""
        pending = self._pending
        pending.append((source, metrics,
                        self._clock() if now is None else now))
        # bound enforced append-then-trim so the common path stays
        # lock-free (deque ops are atomic): only the rare overflow
        # path locks, and every evicted tick is counted — a maxlen
        # deque would evict silently under concurrent offers
        if len(pending) > self._pending_max:
            with self._pending_lock:
                try:
                    pending.popleft()
                except IndexError:
                    pass  # drain emptied it under us
                else:
                    self.dropped_ticks += 1

    def drain(self) -> int:
        """Fold every pending heartbeat into the rings; returns samples
        ingested.  Runs on the health heartbeat and on query paths —
        never on the RPC hot path."""
        ingested = 0
        while True:
            try:
                source, metrics, ts = self._pending.popleft()
            except IndexError:
                break
            ingested += self.ingest(source, metrics, now=ts)
        return ingested

    def ingest(self, source: str, metrics: Dict[str, float],
               now: Optional[float] = None) -> int:
        """Synchronous ingestion (drain path and tests)."""
        ts = self._clock() if now is None else now
        allow = self.allow_prefixes
        n = 0
        with self._lock:
            series_map = self._series
            for name, value in metrics.items():
                if allow and not name.startswith(allow):
                    self.dropped_samples += 1
                    continue
                key = (source, name)
                s = series_map.get(key)
                if s is None:
                    if len(series_map) >= self.max_series and \
                            not self._evict_one(ts):
                        self.dropped_samples += 1
                        continue
                    s = series_map[key] = _Series(self.capacity)
                    ended = self._ended_sources.get(source)
                    if ended is not None:
                        # a series minted for an already-ended source
                        # (new metric name from a lost-but-chatty
                        # worker, or recreated after the sweep) must
                        # carry the marker, not read as live
                        s.ended_at = ended
                try:
                    s.add(ts, float(value))
                except (TypeError, ValueError):
                    continue
                n += 1
            # amortized retention sweep: at most once per minute of
            # series time, so drain cost stays O(new samples)
            if ts - self._last_prune >= 60.0:
                self._last_prune = ts
                dead = []
                for key, s in series_map.items():
                    s.prune(ts, self.retention_s)
                    if s.points() == 0 or self._departed(s, ts):
                        dead.append(key)
                for key in dead:
                    del series_map[key]
                self._ended_sources = {
                    s: t for s, t in self._ended_sources.items()
                    if ts - t <= self.retention_s}
        return n

    def _departed(self, s: _Series, now: float) -> bool:
        """A series whose source is gone must release its slot long
        before its 10m rollups would expire (retention x 60 — 60 hours
        at defaults), or a parade of short-lived client sources pins
        the whole ``max_series`` budget on dead data.  Gone means:
        explicitly ended (worker lost) for a full raw retention, or —
        for clients, which have no lost event — idle for two."""
        if s.ended_at is not None and now - s.ended_at > self.retention_s:
            return True
        return now - s.last_ts > 2.0 * self.retention_s

    def _evict_one(self, now: float) -> bool:
        """Series-cap pressure: evict the stalest ended-or-idle series
        so dead sources never lock live ones out between retention
        sweeps.  Caller holds ``_lock``.  A fruitless scan is cached
        for a few seconds of series time so a cardinality flood of
        live allowlisted names costs O(1) per rejected sample, not an
        O(series) sweep each."""
        if now - self._evict_scan_ts < 5.0:
            return False
        victim = None
        victim_ts = now
        for key, s in self._series.items():
            if s.ended_at is None and now - s.last_ts <= self.retention_s:
                continue
            if s.last_ts < victim_ts:
                victim_ts = s.last_ts
                victim = key
        if victim is None:
            self._evict_scan_ts = now
            return False
        del self._series[victim]
        return True

    def end_source(self, source: str,
                   now: Optional[float] = None) -> int:
        """Mark every series of ``source`` ended (worker declared lost):
        queries show ``ended_at`` instead of silently-stale points.
        Only :meth:`revive_source` (block-master re-registration)
        clears the marker — metrics arrival does not, so a worker whose
        metrics heartbeat outlives its wedged block-sync thread keeps
        the worker-lost alert firing instead of laundering itself back
        to OK."""
        ts = self._clock() if now is None else now
        n = 0
        with self._lock:
            self._ended_sources[source] = ts
            for (src, _name), s in self._series.items():
                if src == source:
                    s.ended_at = ts
                    n += 1
        return n

    def revive_source(self, source: str) -> int:
        """Clear ``source``'s end marker: the worker completed a full
        block-master re-registration, the one signal that it is
        genuinely back serving blocks."""
        n = 0
        with self._lock:
            self._ended_sources.pop(source, None)
            for (src, _name), s in self._series.items():
                if src == source and s.ended_at is not None:
                    s.ended_at = None
                    n += 1
        return n

    def ended_sources(self, now: Optional[float] = None) -> Dict[str, float]:
        """Sources explicitly end-marked (worker lost) and not since
        revived, with their end timestamps; entries age out after
        ``retention_s`` — the worker-lost health alert's lifetime."""
        ts = self._clock() if now is None else now
        with self._lock:
            return {s: t for s, t in self._ended_sources.items()
                    if ts - t <= self.retention_s}

    # ------------------------------------------------------------- query
    def query(self, name: str, *, source: str = "",
              resolution: str = "raw", since: float = 0.0,
              rate: bool = False, limit: int = 0) -> List[dict]:
        """Series matching ``name`` (and ``source`` when given), one
        dict per (source, metric): raw points as ``[ts, value]`` pairs,
        rollups as bucket dicts; ``rate=True`` derives a per-second
        rate from consecutive values (counter resets clamp to 0)."""
        if resolution not in RESOLUTIONS:
            raise ValueError(
                f"resolution must be one of {RESOLUTIONS}, "
                f"got {resolution!r}")
        out: List[dict] = []
        with self._lock:
            for (src, metric), s in self._series.items():
                if metric != name or (source and src != source):
                    continue
                if resolution == "raw":
                    pts = [(t, v) for t, v in s.raw_points()
                           if t >= since]
                else:
                    pts = [b.to_dict() for b in s.rollups[resolution]
                           if b.start >= since]
                entry = {"source": src, "name": metric,
                         "resolution": resolution,
                         "ended_at": s.ended_at}
                if rate:
                    base = pts if resolution == "raw" else \
                        [(b["ts"], b["last"]) for b in pts]
                    entry["points"] = [list(p) for p in derive_rate(base)]
                    entry["rate"] = True
                elif resolution == "raw":
                    entry["points"] = [list(p) for p in pts]
                else:
                    entry["points"] = pts
                if limit and len(entry["points"]) > limit:
                    entry["points"] = entry["points"][-limit:]
                out.append(entry)
        out.sort(key=lambda e: e["source"])
        return out

    def latest(self, name: str, source: str) -> Optional[float]:
        with self._lock:
            s = self._series.get((source, name))
            if s is None or not s.raw_len():
                return None
            return s._v[(s._head + s._n - 1) % len(s._v)]

    def window(self, name: str, source: str,
               window_s: float, now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Raw points of one series inside ``[now - window_s, now]``."""
        ts = self._clock() if now is None else now
        with self._lock:
            s = self._series.get((source, name))
            if s is None:
                return []
            return [(t, v) for t, v in s.raw_points()
                    if ts - t <= window_s]

    def names(self, prefix: str = "") -> List[str]:
        with self._lock:
            seen = {metric for (_src, metric) in self._series}
        return sorted(n for n in seen if n.startswith(prefix))

    def sources_for(self, name: str) -> List[str]:
        with self._lock:
            return sorted(src for (src, metric) in self._series
                          if metric == name)

    # ------------------------------------------------------------- admin
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def stats(self) -> dict:
        with self._lock:
            points = sum(s.points() for s in self._series.values())
            n = len(self._series)
        return {"series": n, "points": points,
                "max_series": self.max_series,
                "capacity": self.capacity,
                "retention_s": self.retention_s,
                "pending": len(self._pending),
                "dropped_samples": self.dropped_samples,
                "dropped_ticks": self.dropped_ticks}
