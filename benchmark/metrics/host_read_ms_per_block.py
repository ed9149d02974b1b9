"""Host ms a block in the producer's ``atpu.loader.host_read`` range
(the stream open, the SHM view and the native pre-fault), traced
slice."""

from benchmark.metrics._range import mean_ms


def read(run):
    return mean_ms(run, "atpu.loader.host_read")
