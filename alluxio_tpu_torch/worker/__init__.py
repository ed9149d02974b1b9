"""The block worker: tiered block store, master sync, UFS cold reads and
the data-plane API the RPC server calls (a copy of the part of
``alluxio_tpu/worker`` that serves blocks)."""
