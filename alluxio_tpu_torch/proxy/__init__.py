"""REST/S3 proxy: S3-compatible HTTP access to the namespace (a copy
of ``alluxio_tpu/proxy/__init__.py``)."""

from alluxio_tpu_torch.proxy.process import ProxyProcess

__all__ = ["ProxyProcess"]
