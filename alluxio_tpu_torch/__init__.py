"""alluxio_tpu_torch: the warm-tier device data plane on PyTorch and CUDA.

The PyTorch port of ``alluxio_tpu``'s device layer, for an NVIDIA Hopper
card (sm_90a). Module paths mirror the JAX package so each counterpart is
easy to find:

- ``client/block_streams.py``: the short-circuit mmap block stream;
- ``client/torch_io.py``: ``DeviceBlockLoader`` (host -> device with
  prefetch) and ``batched_device_iterator``;
- ``client/cache/hbm_store.py``: the device page store (pin leases,
  ``adopt()`` with no second transfer, evict-drops-reference);
- ``ops/reduce_kernel.py``: ``scaled_sum``, a hand-written CUDA kernel
  (``ops/csrc/reduce_kernel.cu``) with its plain PyTorch version;
- ``ops/decode.py``: record decode in plain PyTorch;
- ``convert.py``: device-tier state carried over from numpy pages.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``alluxio_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Importing this package imports no torch; submodules load
on demand.
"""

__version__ = "0.1.0"

_LAZY = {
    "DeviceBlockLoader": "alluxio_tpu_torch.client.torch_io",
    "batched_device_iterator": "alluxio_tpu_torch.client.torch_io",
    "HbmPageStore": "alluxio_tpu_torch.client.cache.hbm_store",
    "scaled_sum": "alluxio_tpu_torch.ops.reduce_kernel",
    "decode_image_records": "alluxio_tpu_torch.ops.decode",
    "hbm_store_from_numpy": "alluxio_tpu_torch.convert",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
