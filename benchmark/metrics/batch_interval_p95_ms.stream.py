"""95th percentile of the interval between consecutive step completions,
each a CUDA event recorded on the consumer's stream after the batch's
consumer work (the device's own clock), over the steps of the window
before the traced slice, so the profiler's cost on the host is not in
it. In a cell whose host paces the loader, it is the host's pace."""

import numpy as np


def read(run):
    if len(run.intervals_ms) < 20:
        return None
    return float(np.percentile(np.asarray(run.intervals_ms), 95))
