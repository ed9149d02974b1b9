"""Stress benches (a copy of part of ``alluxio_tpu/stress/``): the shared
driver, the bench cluster, the write-through bench and the device suite
of BASELINE configs #2, #3 and #5. The other benches come with their
slices."""
