"""msgpack-over-gRPC transport, the worker's data-server service and its
client (a copy of the worker's part of ``alluxio_tpu/rpc``)."""
