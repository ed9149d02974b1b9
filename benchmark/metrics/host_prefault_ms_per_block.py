"""Host ms a block in the producer's ``atpu.loader.prefault`` range (the
native pre-fault of the block's pages), inside ``atpu.loader.host_read``,
traced slice."""

from benchmark.metrics._range import mean_ms


def read(run):
    return mean_ms(run, "atpu.loader.prefault")
