"""Host ms a block in the producer's ``atpu.loader.view`` range (the
stream's open when it is not cached, ``block_stream`` and the SHM view
or the streamed read), inside ``atpu.loader.host_read``, traced slice."""

from benchmark.metrics._range import mean_ms


def read(run):
    return mean_ms(run, "atpu.loader.view")
