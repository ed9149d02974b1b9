"""Share of the window the consumer spent blocked in ``next()`` of the
loader's iterator (the benchmark's own host timer)."""


def read(run):
    return 100.0 * run.wait_s / run.window_s if run.window_s > 0 else None
