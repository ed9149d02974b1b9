"""alluxio_tpu_torch: the device data plane and its model on PyTorch + CUDA.

The PyTorch port of ``alluxio_tpu``'s device layer, for an NVIDIA Hopper
card (sm_90a). Module paths mirror the JAX package so each counterpart is
easy to find:

- ``master/``, ``journal/``: the single master (journal with native
  frame scanning, inode tree on the heap metastore, block and file
  masters, ``MasterProcess`` serving ``rpc/master_service.py`` over gRPC
  and the ``rpc/fastpath.py`` Unix socket);
- ``client/file_system.py``, ``client/streams.py``: ``FileSystem``, the
  user-facing client over the master clients and the block ladder;
- ``minicluster/local_cluster.py``: ``LocalCluster``, a master and its
  workers in one process;
- ``client/block_store.py``: ``BlockStoreClient``, the ladder that opens
  a block's stream (the SHM plane of ``client/shm_transport.py``, the
  short-circuit lease, the striped remote read of
  ``client/remote_read.py``, the UFS read-through);
- ``client/block_streams.py``: the short-circuit mmap, remote and write
  block streams;
- ``worker/``, ``rpc/``: the block worker (tiered store, SHM leases) and
  its gRPC data server and client;
- ``native/``: the host C++ runtime (the page pre-fault, the small-read
  plan executor), built with g++ at first use;
- ``client/torch_io.py``: ``DeviceBlockLoader`` (host -> device with
  prefetch) and ``batched_device_iterator``;
- ``client/cache/hbm_store.py``: the device page store (pin leases,
  ``adopt()`` with no second transfer, evict-drops-reference, pages
  filled on a side stream carry their copy's event);
- ``client/cache/{meta,page_store,manager,stream}.py``: the client page
  cache, ``LocalCacheManager`` with the device store above its host tier
  (``get_device``), the JAX package's on-disk page layout, and
  ``CachingFileInStream``;
- ``prefetch/``: the clairvoyant prefetch loop (``PrefetchService``: a
  seeded oracle, a budgeted scheduler and an agent that fills the
  loader's device tier ahead of the consumer), on ``heartbeat/``;
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
    "FileSystem": "alluxio_tpu_torch.client.file_system",
    "LocalCluster": "alluxio_tpu_torch.minicluster.local_cluster",
    "DeviceBlockLoader": "alluxio_tpu_torch.client.torch_io",
    "batched_device_iterator": "alluxio_tpu_torch.client.torch_io",
    "HbmPageStore": "alluxio_tpu_torch.client.cache.hbm_store",
    "LocalCacheManager": "alluxio_tpu_torch.client.cache.manager",
    "PrefetchService": "alluxio_tpu_torch.prefetch.service",
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
