"""CUDA API calls that launch a kernel, a copy or a memset
(``cudaLaunch*``, ``cudaMemcpy*``, ``cudaMemset*``) made under each
``atpu.decode.images`` range (its thread, inside its interval), over the
number of such ranges, traced slice."""

import bisect

from benchmark import devtrace

DECODE = "atpu.decode.images"
LAUNCHES = ("cudaLaunch", "cudaMemcpy", "cudaMemset")


def calls_under(events, name):
    """``(ranges, calls)``: the host ranges called ``name`` and the CUDA
    API calls made on a range's thread inside its interval; None when
    the slice holds no CUDA API call at all (no card traced)."""
    if events is None or not any(
            ev["cat"].startswith(devtrace.LAUNCH_PREFIX) for ev in events):
        return None
    rs = devtrace.ranges(events, name)
    by_tid = {}
    for r in rs:
        by_tid.setdefault(r["tid"], []).append((r["ts"], r["ts"] + r["dur"]))
    for spans in by_tid.values():
        spans.sort()
    calls = []
    for ev in events:
        spans = by_tid.get(ev["tid"])
        if not spans or not ev["cat"].startswith(devtrace.LAUNCH_PREFIX):
            continue
        i = bisect.bisect_right(spans, (ev["ts"], float("inf"))) - 1
        if i >= 0 and ev["ts"] <= spans[i][1]:
            calls.append(ev)
    return rs, calls


def read(run):
    found = calls_under(run.events, DECODE)
    if found is None or not found[0]:
        return None
    rs, calls = found
    return sum(1 for ev in calls if ev["name"].startswith(LAUNCHES)) / len(rs)
