"""The traced slice of a window: ``torch.profiler`` over the slice, its
Chrome trace read back as plain event dicts, and the arithmetic every
reader shares (device intervals, host ranges, launches under a range).

Events keep ``name``, ``cat``, ``ts`` and ``dur`` (microseconds),
``pid``, ``tid`` and the launch ``correlation``. Device work is the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories; host ranges
are ``user_annotation`` (``record_function``); launches are the CUDA API
calls, the ``cuda_*`` categories.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the category prefix of CUDA API calls (runtime and lower level)
LAUNCH_PREFIX = "cuda_"
RANGE_CAT = "user_annotation"
#: the range that marks the traced slice itself
SLICE = "bench.slice"
#: host ranges that name an idle gap: the benchmark's and the port's
GAP_PREFIXES = ("bench.", "atpu.")


class Slice:
    """Profiles from :meth:`start` to :meth:`stop` and returns the
    slice's events; the exported trace goes under ``workdir`` and is
    deleted once read."""

    def __init__(self, workdir: str) -> None:
        self._dir = workdir
        self._prof = None
        self._range = None

    @staticmethod
    def warm_up(device) -> None:
        """One short profile, so that the window's start does not pay
        the profiler's first initialisation."""
        import torch

        with torch.profiler.profile(activities=_activities(device),
                                    experimental_config=_all_threads()):
            torch.zeros(1, device=device).add_(1)
            _sync(device)

    def start(self, device) -> None:
        import torch

        self._prof = torch.profiler.profile(
            activities=_activities(device), experimental_config=_all_threads())
        self._prof.start()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self, device) -> List[dict]:
        _sync(device)
        self._range.__exit__(None, None, None)
        self._prof.stop()
        path = os.path.join(self._dir, "slice.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as f:
                return events_of(json.load(f))
        finally:
            os.unlink(path)


def _activities(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads():
    """Record the ranges of every thread (the loader's producer and the
    prefetch loop's adopt thread, not only the consumer's)."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def events_of(trace: dict) -> List[dict]:
    """The complete (``ph == "X"``) events of a Chrome trace."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        args = ev.get("args") or {}
        out.append({"name": ev.get("name", ""), "cat": ev.get("cat", ""),
                    "ts": float(ev["ts"]), "dur": float(ev["dur"]),
                    "pid": ev.get("pid"), "tid": ev.get("tid"),
                    "correlation": args.get("correlation")})
    return out


def bounds(events: List[dict]) -> Optional[Tuple[float, float]]:
    """The traced slice as ``(start, end)`` microseconds."""
    for ev in events:
        if ev["cat"] == RANGE_CAT and ev["name"] == SLICE:
            return ev["ts"], ev["ts"] + ev["dur"]
    return None


def device_events(events: List[dict]) -> List[dict]:
    return [ev for ev in events if ev["cat"] in DEVICE_CATS]


def ranges(events: List[dict], name: str) -> List[dict]:
    """Host ranges called ``name``."""
    return [ev for ev in events if ev["cat"] == RANGE_CAT
            and ev["name"] == name]


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def busy_us(events: List[dict], lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi]`` in which some device operation ran."""
    spans = merged((max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi))
                   for ev in device_events(events))
    return sum(b - a for a, b in spans if b > a)


class _Covering:
    """Ranges sorted by start, asked which are open at an instant."""

    def __init__(self, rs: List[dict]) -> None:
        self._rs = sorted(rs, key=lambda r: r["ts"])
        self._starts = [r["ts"] for r in self._rs]
        self._longest = max((r["dur"] for r in self._rs), default=0.0)

    def at(self, t: float) -> List[dict]:
        out = []
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self._starts[i] >= t - self._longest:
            r = self._rs[i]
            if t <= r["ts"] + r["dur"]:
                out.append(r)
            i -= 1
        return out


def launched_under(events: List[dict], host_ranges: List[dict]
                   ) -> Dict[int, dict]:
    """Correlation id -> the host range that contains the launch (same
    thread, inside the range's interval)."""
    by_tid: Dict[object, List[dict]] = {}
    for r in host_ranges:
        by_tid.setdefault(r["tid"], []).append(r)
    covering = {tid: _Covering(rs) for tid, rs in by_tid.items()}
    out: Dict[int, dict] = {}
    for ev in events:
        if not ev["cat"].startswith(LAUNCH_PREFIX) or \
                ev["correlation"] is None:
            continue
        cov = covering.get(ev["tid"])
        hit = cov.at(ev["ts"]) if cov is not None else []
        if hit:
            out[ev["correlation"]] = hit[0]
    return out


def breakdown(events: List[dict], top: int = 10) -> Optional[dict]:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (the benchmark's and the port's
    ranges open at each gap's middle), in seconds."""
    b = bounds(events)
    if b is None:
        return None
    lo, hi = b
    ops: Dict[str, float] = {}
    for ev in device_events(events):
        ops[ev["name"][:160]] = ops.get(ev["name"][:160], 0.0) + ev["dur"]
    spans = merged((max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi))
                   for ev in device_events(events))
    gaps, t = [], lo
    for a, z in spans:
        if a > t:
            gaps.append((t, a))
        t = max(t, z)
    if hi > t:
        gaps.append((t, hi))
    host = _Covering([ev for ev in events if ev["cat"] == RANGE_CAT
                      and ev["name"] != SLICE
                      and ev["name"].startswith(GAP_PREFIXES)])
    idle: Dict[str, float] = {}
    for a, z in gaps:
        names = sorted({ev["name"] for ev in host.at((a + z) / 2)})
        key = "+".join(names) or "other"
        idle[key] = idle.get(key, 0.0) + (z - a)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in rank(ops)],
            "idle_gaps": [[k, v / 1e6] for k, v in rank(idle)]}
