"""alluxio_tpu_torch: the device data plane and its model on PyTorch + CUDA.

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
- ``parallel/mesh.py``: the mesh on ``torch.distributed`` (one process
  per card; NCCL on cards, gloo for CPU tensors), layouts,
  ``shard_host_batch``; ``parallel/tensor_parallel.py``: the Megatron
  copy-to/reduce-from autograd Functions;
- ``parallel/ici_store.py``: ``MeshBlockCache``, warm blocks sharded
  over a mesh axis and read by collectives;
- ``parallel/{ring_attention,moe,pipeline}.py``: attention on one card
  and ring attention across ranks, the top-1 mixture-of-experts FFN
  (expert-parallel under a mesh), the GPipe pipeline;
- ``models/transformer.py``: the flagship ViT (``nn.Module`` with the JAX
  tree's parameter names, sharded dp x tp under a mesh) and
  ``images_to_tokens``;
- ``models/train.py``: the train step, on one card or dp x tp, with an
  AdamW that follows ``optax.adamw``, and ``sgd``;
- ``models/checkpoint.py``: train-state checkpoints in the JAX layout,
  whole on disk whatever the mesh;
- ``convert.py``: device-tier pages and the model's train state carried
  over from numpy.

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
    "TransformerConfig": "alluxio_tpu_torch.models.transformer",
    "Transformer": "alluxio_tpu_torch.models.transformer",
    "images_to_tokens": "alluxio_tpu_torch.models.transformer",
    "make_train_state": "alluxio_tpu_torch.models.train",
    "make_train_step": "alluxio_tpu_torch.models.train",
    "make_sharded_train_state": "alluxio_tpu_torch.models.train",
    "make_mesh": "alluxio_tpu_torch.parallel.mesh",
    "MeshBlockCache": "alluxio_tpu_torch.parallel.ici_store",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
