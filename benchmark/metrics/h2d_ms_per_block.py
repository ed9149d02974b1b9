"""Host ms a block in the consumer's ``atpu.loader.h2d`` range (pinned
staging, the copy into it and the launch of the host-to-device copy),
traced slice."""

from benchmark.metrics._range import mean_ms


def read(run):
    return mean_ms(run, "atpu.loader.h2d")
