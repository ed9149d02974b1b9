"""Mean host time of a port range in the traced slice."""

from benchmark import devtrace


def mean_ms(run, name):
    if run.events is None:
        return None
    rs = devtrace.ranges(run.events, name)
    if not rs:
        return None
    return sum(r["dur"] for r in rs) / len(rs) / 1e3
