"""Filesystem client (a copy of ``alluxio_tpu/client``; reference:
``core/client``).

The package re-exports the JAX package's names; each submodule loads on
first use of its name (PEP 562), so importing the package loads nothing
else.
"""

_LAZY = {
    "FileSystem": "alluxio_tpu_torch.client.file_system",
    "FileInStream": "alluxio_tpu_torch.client.streams",
    "FileOutStream": "alluxio_tpu_torch.client.streams",
    "ReadType": "alluxio_tpu_torch.client.streams",
    "WriteType": "alluxio_tpu_torch.client.streams",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
