"""Metric readers, one file a metric, named as the metric is in
``BENCHMARK.json``: ``read(run) -> float | None``. ``run`` is the
harness's record of one window (``benchmark.harness.Run``). A reader
that finds nothing to read returns None and the metric is left out of
the result line."""
