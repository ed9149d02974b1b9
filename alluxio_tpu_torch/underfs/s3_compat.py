"""S3-compatible connectors for the other cloud object stores (a copy of
``alluxio_tpu/underfs/s3_compat.py``).

The reference ships per-vendor SDK connectors (``underfs/{oss,cos,kodo,
swift}`` — Alibaba OSS, Tencent COS, Qiniu Kodo, OpenStack Swift). All four
services expose S3-compatible REST gateways, so this build serves them
through the SigV4 client with vendor-specific endpoint defaults instead of
four SDK dependencies. Properties mirror the s3 connector with a vendor
prefix (e.g. ``oss.endpoint``, ``cos.access.key``) and fall back to the
``s3.*`` names.
"""

from __future__ import annotations

from typing import Dict, Optional

from alluxio_tpu_torch.underfs.s3 import S3Client, S3UnderFileSystem


def _remap(prefix: str, properties: Optional[Dict[str, str]],
           default_endpoint: str = "") -> Dict[str, str]:
    props = dict(properties or {})
    for suffix in ("endpoint", "access.key", "secret.key", "region",
                   "path.style", "multipart.size"):
        v = props.get(f"{prefix}.{suffix}", props.get(f"s3.{suffix}"))
        if v is not None:
            props[f"s3.{suffix}"] = v
    if "s3.endpoint" not in props and default_endpoint:
        props["s3.endpoint"] = default_endpoint
    return props


class _CompatUfs(S3UnderFileSystem):
    vendor_prefix = "s3"
    default_endpoint = ""

    def _make_client(self, bucket: str,
                     properties: Optional[Dict[str, str]]) -> S3Client:
        return S3Client(bucket, _remap(self.vendor_prefix, properties,
                                       self.default_endpoint))


class OssUnderFileSystem(_CompatUfs):
    """``oss://bucket/...`` via Alibaba OSS's S3-compatible API
    (reference: ``underfs/oss``); ``oss.dialect=native`` switches to
    the vendor's own header signing — see :func:`create_oss_ufs`."""

    schemes = ("oss",)
    vendor_prefix = "oss"
    default_endpoint = "https://oss-cn-hangzhou.aliyuncs.com"


class CosUnderFileSystem(_CompatUfs):
    """``cos://bucket/...`` via Tencent COS's S3-compatible API
    (reference: ``underfs/cos``); ``cos.dialect=native`` switches to
    q-signature auth — see :func:`create_cos_ufs`."""

    schemes = ("cos", "cosn")
    vendor_prefix = "cos"
    default_endpoint = "https://cos.ap-guangzhou.myqcloud.com"


class KodoUnderFileSystem(_CompatUfs):
    """``kodo://bucket/...`` via Qiniu Kodo's S3-compatible API
    (reference: ``underfs/kodo``); ``kodo.dialect=native`` switches to
    QBox tokens + private download URLs — see :func:`create_kodo_ufs`."""

    schemes = ("kodo",)
    vendor_prefix = "kodo"
    default_endpoint = "https://s3-cn-east-1.qiniucs.com"


def _native_requested(prefix: str,
                      properties: Optional[Dict[str, str]]) -> bool:
    return (properties or {}).get(f"{prefix}.dialect", "").lower() == \
        "native"


def _bucket_of(uri: str) -> str:
    rest = uri.split("://", 1)[1] if "://" in uri else uri
    return rest.partition("/")[0]


def _vendor_prop(props: Dict[str, str], prefix: str, suffix: str,
                 default: str = "") -> str:
    """Same fallback contract as the gateway path's ``_remap``: the
    vendor-prefixed name wins, the documented ``s3.*`` name backs it."""
    return props.get(f"{prefix}.{suffix}",
                     props.get(f"s3.{suffix}", default))


def _native_creds(props: Dict[str, str],
                  prefix: str) -> "tuple[str, str]":
    ak = _vendor_prop(props, prefix, "access.key")
    sk = _vendor_prop(props, prefix, "secret.key")
    if not ak or not sk:
        raise ValueError(
            f"{prefix}.dialect=native needs {prefix}.access.key + "
            f"{prefix}.secret.key (or the s3.* fallbacks) — refusing "
            f"to sign with empty credentials")
    return ak, sk


def create_oss_ufs(root_uri: str,
                   properties: Optional[Dict[str, str]] = None):
    """Dialect dispatch (the swift-connector pattern): the S3 gateway
    by default; ``oss.dialect=native`` signs with Alibaba's own
    "OSS ak:sig" scheme (reference ``OSSUnderFileSystem.java``)."""
    if not _native_requested("oss", properties):
        return OssUnderFileSystem(root_uri, properties)
    from alluxio_tpu_torch.underfs.object_base import ObjectUnderFileSystem
    from alluxio_tpu_torch.underfs.vendor_native import OssNativeClient

    p = properties or {}
    ak, sk = _native_creds(p, "oss")
    client = OssNativeClient(
        _bucket_of(root_uri),
        _vendor_prop(p, "oss", "endpoint",
                     OssUnderFileSystem.default_endpoint),
        ak, sk,
        _vendor_prop(p, "oss", "path.style", "false") == "true",
        multipart_size=int(
            _vendor_prop(p, "oss", "multipart.size", str(8 << 20))))
    return ObjectUnderFileSystem(root_uri, client, properties)


create_oss_ufs.schemes = OssUnderFileSystem.schemes


def create_cos_ufs(root_uri: str,
                   properties: Optional[Dict[str, str]] = None):
    """``cos.dialect=native`` -> Tencent q-signature auth (reference
    ``COSUnderFileSystem.java``); default stays the S3 gateway."""
    if not _native_requested("cos", properties):
        return CosUnderFileSystem(root_uri, properties)
    from alluxio_tpu_torch.underfs.object_base import ObjectUnderFileSystem
    from alluxio_tpu_torch.underfs.vendor_native import CosNativeClient

    p = properties or {}
    ak, sk = _native_creds(p, "cos")
    client = CosNativeClient(
        _bucket_of(root_uri),
        _vendor_prop(p, "cos", "endpoint",
                     CosUnderFileSystem.default_endpoint),
        ak, sk,
        _vendor_prop(p, "cos", "path.style", "false") == "true",
        multipart_size=int(
            _vendor_prop(p, "cos", "multipart.size", str(8 << 20))))
    return ObjectUnderFileSystem(root_uri, client, properties)


create_cos_ufs.schemes = CosUnderFileSystem.schemes


def create_kodo_ufs(root_uri: str,
                    properties: Optional[Dict[str, str]] = None):
    """``kodo.dialect=native`` -> Qiniu QBox tokens + private download
    URLs (reference ``KodoUnderFileSystem.java``); default stays the
    S3 gateway."""
    if not _native_requested("kodo", properties):
        return KodoUnderFileSystem(root_uri, properties)
    from alluxio_tpu_torch.underfs.object_base import ObjectUnderFileSystem
    from alluxio_tpu_torch.underfs.vendor_native import KodoNativeClient

    p = properties or {}
    ak, sk = _native_creds(p, "kodo")
    client = KodoNativeClient(
        _bucket_of(root_uri), ak, sk,
        rs_host=p.get("kodo.rs.host", "https://rs.qiniuapi.com"),
        rsf_host=p.get("kodo.rsf.host", "https://rsf.qiniuapi.com"),
        up_host=p.get("kodo.up.host", "https://upload.qiniup.com"),
        download_host=p.get("kodo.download.host", ""))
    return ObjectUnderFileSystem(root_uri, client, properties)


create_kodo_ufs.schemes = KodoUnderFileSystem.schemes


class SwiftUnderFileSystem(_CompatUfs):
    """``swift://container/...`` via an OpenStack Swift S3-middleware
    endpoint (reference: ``underfs/swift``)."""

    schemes = ("swift",)
    vendor_prefix = "swift"


class ObsUnderFileSystem(_CompatUfs):
    """``obs://bucket/...`` via Huawei OBS's S3-compatible API."""

    schemes = ("obs",)
    vendor_prefix = "obs"
    default_endpoint = "https://obs.cn-north-1.myhuaweicloud.com"
