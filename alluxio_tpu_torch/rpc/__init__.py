"""msgpack-over-gRPC transport, the master, worker and job services and
their clients (a copy of ``alluxio_tpu/rpc``; reference:
``core/common/.../grpc`` + proto services).

The package re-exports the JAX package's names; each submodule loads on
first use of its name (PEP 562).
"""

_LAZY = {
    "RpcChannel": "alluxio_tpu_torch.rpc.core",
    "RpcServer": "alluxio_tpu_torch.rpc.core",
    "ServiceDefinition": "alluxio_tpu_torch.rpc.core",
    "BlockMasterClient": "alluxio_tpu_torch.rpc.clients",
    "FsMasterClient": "alluxio_tpu_torch.rpc.clients",
    "MetaMasterClient": "alluxio_tpu_torch.rpc.clients",
    "WorkerClient": "alluxio_tpu_torch.rpc.clients",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
