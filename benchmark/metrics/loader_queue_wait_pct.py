"""Share of the traced slice the consumer spent in the loader's
``atpu.loader.queue_wait`` ranges, waiting for the producer's next
item."""

from benchmark import devtrace


def slice_share_pct(run, name):
    """Percent of the traced slice covered by ``name``'s ranges, each
    clipped to the slice; None without a slice or without such a
    range."""
    if run.events is None:
        return None
    b = devtrace.bounds(run.events)
    rs = devtrace.ranges(run.events, name)
    if b is None or b[1] <= b[0] or not rs:
        return None
    lo, hi = b
    inside = sum(max(0.0, min(r["ts"] + r["dur"], hi) - max(r["ts"], lo))
                 for r in rs)
    return 100.0 * inside / (hi - lo)


def read(run):
    return slice_share_pct(run, "atpu.loader.queue_wait")
