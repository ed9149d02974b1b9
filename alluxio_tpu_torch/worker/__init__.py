"""The block worker: tiered block store, master sync, UFS cold reads and
the data-plane API the RPC server calls (a copy of ``alluxio_tpu/worker``;
reference: ``core/server/worker``).

The package re-exports the JAX package's names; each submodule loads on
first use of its name (PEP 562).
"""

_LAZY = {
    "BlockMeta": "alluxio_tpu_torch.worker.meta",
    "BlockMetadataManager": "alluxio_tpu_torch.worker.meta",
    "StorageDir": "alluxio_tpu_torch.worker.meta",
    "StorageTier": "alluxio_tpu_torch.worker.meta",
    "TempBlockMeta": "alluxio_tpu_torch.worker.meta",
    "BlockWorker": "alluxio_tpu_torch.worker.process",
    "build_store_from_conf": "alluxio_tpu_torch.worker.process",
    "TieredBlockStore": "alluxio_tpu_torch.worker.tiered_store",
    "BlockFetch": "alluxio_tpu_torch.worker.ufs_fetch",
    "FetchConf": "alluxio_tpu_torch.worker.ufs_fetch",
    "UfsBlockFetcher": "alluxio_tpu_torch.worker.ufs_fetch",
    "UfsBlockDescriptor": "alluxio_tpu_torch.worker.ufs_io",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
