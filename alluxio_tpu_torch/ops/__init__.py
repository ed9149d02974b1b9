"""On-device data ops: the ``scaled_sum`` kernel and record decode (the
port of ``alluxio_tpu/ops``).

Submodules import torch; this package file imports nothing, so the
package stays importable where torch is absent. It re-exports the JAX
package's names, each loaded on first use (PEP 562).
"""

_LAZY = {
    "decode_image_records": "alluxio_tpu_torch.ops.decode",
    "encode_image_records": "alluxio_tpu_torch.ops.decode",
    "image_record_bytes": "alluxio_tpu_torch.ops.decode",
    "sum_bytes": "alluxio_tpu_torch.ops.decode",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
