"""Host ms a copy in the ``atpu.h2d.stage_alloc`` range (the pinned
staging buffer's allocation), inside ``atpu.loader.h2d`` on the consumer
and ``atpu.prefetch.hbm_adopt`` on the adopt thread, traced slice."""

from benchmark.metrics._range import mean_ms


def read(run):
    return mean_ms(run, "atpu.h2d.stage_alloc")
