"""The benchmark of the PyTorch port (``alluxio_tpu_torch``): one cell a
run, driven by ``BENCHMARK.json`` and the data files beside this module.
See ``README.md``."""
