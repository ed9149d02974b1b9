"""The flagship model the data plane feeds, its train step and its
checkpoints (the port of ``alluxio_tpu/models``)."""
