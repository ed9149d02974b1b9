"""Critical-path analysis over stitched traces (a copy of
``alluxio_tpu/utils/critical_path.py``).

The read-path microscope's second half (docs/observability.md): given
the spans of one trace — client, worker and master spans stitched by
``trace_id`` — reconstruct the *blocking chain*: the single walk from
the root span's start to its end where, at every instant, the segment
on the chain is whatever the operation was actually blocked on. The
model follows phase-attributed I/O analysis (arxiv 2301.01494): a
parent is blocked on its **last-finishing overlapping child** (hedged
fan-outs: the winner that gated completion, not the cancelled loser),
and time not covered by any child is the span's own *self-time*.

Self-time is then attributed to the span's typed phase events
(``Span.phase``, names from ``tracing.PHASES``). Phases are measured
wall-time slices and may legitimately overlap a child span (the
client's ``wire`` wait contains the server's whole span), so each
span's phases are scaled down proportionally to fit its critical
self-time — nothing double-counts, and the chain still partitions the
root's wall-clock exactly. Self-time not covered by any phase stays on
the span as ``<name>/self`` and counts as *unattributed*: the
``attributed_pct`` figure (gated ≥90% in ``make bench-obs``) is the
share of root wall-clock landing in **named phases**.

``analyze_trace`` handles one trace (``fsadmin trace --critical-path``)
and ``profile`` aggregates many sampled traces into the ranked
per-phase table behind ``get_trace_profile`` /
``/api/v1/master/trace/profile`` / ``fsadmin report readpath``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: float slop for interval arithmetic on wall-clock milliseconds
_EPS = 1e-6


def _end_ms(s: dict) -> float:
    return (s.get("start_ms") or 0.0) + (s.get("duration_ms") or 0.0)


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def analyze_trace(spans: List[dict]) -> Optional[dict]:
    """Blocking-chain breakdown of one trace's spans.

    Returns None when no span carries a usable interval. Spans whose
    parent was never shipped (unsampled hop, ring eviction) become
    extra roots; the root whose interval is longest anchors the walk —
    on the read path that is the client op span — and the other roots'
    time is simply not part of this trace's wall-clock.
    """
    usable = [s for s in spans
              if s.get("start_ms") is not None
              and s.get("duration_ms") is not None
              and s.get("span_id")]
    if not usable:
        return None
    by_id = {s["span_id"]: s for s in usable}
    kids: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in usable:
        p = s.get("parent")
        if p and p in by_id and p != s["span_id"]:
            kids.setdefault(p, []).append(s)
        else:
            roots.append(s)
    root = max(roots, key=lambda s: s.get("duration_ms") or 0.0)

    # span_id -> critical self-time; chain segments (span, start, end)
    self_ms: Dict[str, float] = {}
    segments: List[Tuple[dict, float, float]] = []
    on_path: List[dict] = []

    def walk(s: dict, wstart: float, wend: float) -> None:
        # clip to the parent's window: cross-process clock skew must
        # never let a child inflate the chain past its parent
        ws = max(wstart, s["start_ms"])
        we = min(wend, _end_ms(s))
        if we - ws <= _EPS:
            return
        on_path.append(s)
        cursor = we
        for k in sorted(kids.get(s["span_id"], ()),
                        key=_end_ms, reverse=True):
            ke = min(_end_ms(k), cursor)
            ks = max(k.get("start_ms") or 0.0, ws)
            if ke - ks <= _EPS or ke - ws <= _EPS:
                continue  # outside the still-unexplained window
            if cursor - ke > _EPS:
                # gap after this child closed and before the later
                # blocker began: the parent itself was running
                segments.append((s, ke, cursor))
                self_ms[s["span_id"]] = \
                    self_ms.get(s["span_id"], 0.0) + (cursor - ke)
            walk(k, ks, ke)
            cursor = min(cursor, ks)
            if cursor - ws <= _EPS:
                break
        if cursor - ws > _EPS:
            segments.append((s, ws, cursor))
            self_ms[s["span_id"]] = \
                self_ms.get(s["span_id"], 0.0) + (cursor - ws)

    walk(root, root["start_ms"], _end_ms(root))
    wall_ms = _end_ms(root) - root["start_ms"]

    # distribute each span's critical self-time over its phases,
    # scaled so overlapping phase measurements cannot double-count
    seg_ms: Dict[str, float] = {}
    attributed = 0.0
    span_rows: List[dict] = []
    seen_ids = set()
    for s in on_path:
        sid = s["span_id"]
        if sid in seen_ids:
            continue
        seen_ids.add(sid)
        self_t = self_ms.get(sid, 0.0)
        phases = [(str(n), float(ms)) for n, ms in (s.get("phases") or ())
                  if ms is not None and float(ms) > 0.0]
        total_phase = sum(ms for _, ms in phases)
        scale = min(1.0, self_t / total_phase) if total_phase > 0 else 0.0
        row_phases: Dict[str, float] = {}
        for pname, pms in phases:
            got = pms * scale
            row_phases[pname] = row_phases.get(pname, 0.0) + got
            key = f"{s.get('name')}/{pname}"
            seg_ms[key] = seg_ms.get(key, 0.0) + got
            attributed += got
        rest = self_t - sum(row_phases.values())
        if rest > _EPS:
            key = f"{s.get('name')}/self"
            seg_ms[key] = seg_ms.get(key, 0.0) + rest
        span_rows.append({
            "span": s.get("name"), "span_id": sid,
            "source": s.get("source"),
            "start_off_ms": round(s["start_ms"] - root["start_ms"], 3),
            "self_ms": round(self_t, 3),
            "phases": {k: round(v, 3) for k, v in row_phases.items()},
        })
    span_rows.sort(key=lambda r: r["start_off_ms"])
    segments.sort(key=lambda seg: seg[1])
    return {
        "trace_id": root.get("trace_id"),
        "root": root.get("name"),
        "wall_ms": round(wall_ms, 3),
        "spans_on_path": span_rows,
        "chain": [{"span": s.get("name"),
                   "start_off_ms": round(a - root["start_ms"], 3),
                   "ms": round(b - a, 3)}
                  for s, a, b in segments],
        "segments": {k: round(v, 3) for k, v in seg_ms.items()},
        "attributed_ms": round(attributed, 3),
        "attributed_pct": round(100.0 * attributed / wall_ms, 2)
        if wall_ms > _EPS else 0.0,
    }


def profile(spans: List[dict], *, root_prefix: str = "",
            max_traces: int = 256, top: int = 40) -> dict:
    """Ranked per-phase profile over many traces' blocking chains.

    ``spans`` is a flat stitched span list (any order, many traces
    mixed). Traces are analyzed independently; per ``span/phase`` key
    we report count, total/mean self-ms and p50/p99 of the per-trace
    self-ms samples, ranked by total — the table that answers "what is
    the small-read path actually blocked on". ``root_prefix`` keeps
    only traces whose root span name matches (e.g.
    ``atpu.client.remote_read``)."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(s)
    rows: Dict[str, List[float]] = {}
    wall_total = 0.0
    attributed_total = 0.0
    walls: List[float] = []
    analyzed = 0
    for tid, tspans in by_trace.items():
        if analyzed >= max_traces:
            break
        res = analyze_trace(tspans)
        if res is None:
            continue
        if root_prefix and not str(res.get("root") or "").startswith(
                root_prefix):
            continue
        analyzed += 1
        wall_total += res["wall_ms"]
        walls.append(res["wall_ms"])
        attributed_total += res["attributed_ms"]
        for key, ms in res["segments"].items():
            rows.setdefault(key, []).append(ms)
    out_rows = []
    for key, samples in rows.items():
        samples.sort()
        total = sum(samples)
        out_rows.append({
            "key": key,
            "count": len(samples),
            "total_ms": round(total, 3),
            "mean_ms": round(total / len(samples), 3),
            "p50_ms": round(_quantile(samples, 0.50), 3),
            "p99_ms": round(_quantile(samples, 0.99), 3),
            "pct": round(100.0 * total / wall_total, 2)
            if wall_total > _EPS else 0.0,
        })
    out_rows.sort(key=lambda r: -r["total_ms"])
    walls.sort()
    return {
        "traces_analyzed": analyzed,
        "wall_ms_total": round(wall_total, 3),
        "wall_ms_p50": round(_quantile(walls, 0.50), 3),
        "wall_ms_p99": round(_quantile(walls, 0.99), 3),
        "attributed_pct": round(
            100.0 * attributed_total / wall_total, 2)
        if wall_total > _EPS else 0.0,
        "phases": out_rows[:top],
    }
