"""The share of the traced slice in which no kernel, copy or memset ran
on the device."""

from benchmark import devtrace


def read(run):
    if run.events is None:
        return None
    b = devtrace.bounds(run.events)
    if b is None or b[1] <= b[0]:
        return None
    busy = devtrace.busy_us(run.events, *b)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (b[1] - b[0]))
