"""S3 UFS connector (a copy of ``alluxio_tpu/underfs/s3.py``).

Re-design of ``underfs/s3a/src/main/java/alluxio/underfs/s3a/
S3AUnderFileSystem.java:79`` + ``S3ALowLevelOutputStream.java`` (low-level
multipart upload) without an SDK: hand-rolled SigV4 REST over ``requests``,
endpoint-overridable so it serves AWS S3, GCS-interop, MinIO and the
in-process fake used in tests. Also the S3-compatible face of the other
object-store connectors (OSS/COS/Kodo/Swift expose S3-compatible gateways;
see ``s3_compat.py``).

Properties (mount ``--option``):
  s3.endpoint        override endpoint url (default AWS virtual-host style)
  s3.access.key / s3.secret.key
  s3.region          default us-east-1
  s3.path.style      "true" to force path-style addressing (auto-on when an
                     endpoint override is set)
  s3.multipart.size  part size for streaming uploads (default 8MB)
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import BinaryIO, Dict, List, Optional, Tuple

import requests

from alluxio_tpu_torch.underfs.base import CreateOptions
from alluxio_tpu_torch.underfs.object_base import (
    ObjectStoreClient, ObjectUnderFileSystem,
)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "" if encode_slash else "/"
    return urllib.parse.quote(s, safe=safe + "-_.~")


class SigV4Signer:
    """AWS Signature Version 4 request signing."""

    def __init__(self, access_key: str, secret_key: str, region: str,
                 service: str = "s3") -> None:
        self._ak = access_key
        self._sk = secret_key
        self._region = region
        self._service = service

    def sign(self, method: str, url: str, headers: Dict[str, str],
             payload_sha256: str) -> Dict[str, str]:
        parsed = urllib.parse.urlsplit(url)
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {k.lower(): v for k, v in headers.items()}
        headers["host"] = parsed.netloc
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_sha256
        canonical_qs = "&".join(
            sorted(f"{_uri_encode(k)}={_uri_encode(v)}"
                   for k, v in urllib.parse.parse_qsl(
                       parsed.query, keep_blank_values=True)))
        signed_names = sorted(h.lower() for h in headers)
        canonical_headers = "".join(
            f"{h}:{str(headers[h]).strip()}\n" for h in signed_names)
        signed_headers = ";".join(signed_names)
        # the request path is already percent-encoded once by the caller;
        # re-encoding here would double-encode and break the signature for
        # keys with spaces/':'/non-ASCII
        canonical = "\n".join([
            method, parsed.path or "/",
            canonical_qs, canonical_headers, signed_headers, payload_sha256])
        scope = f"{datestamp}/{self._region}/{self._service}/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(b"AWS4" + self._sk.encode(), datestamp)
        k = _hmac(k, self._region)
        k = _hmac(k, self._service)
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(),
                             hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self._ak}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")
        return headers


class S3Client(ObjectStoreClient):
    """REST client over one bucket (reference: the jets3t/AWS-SDK calls in
    ``S3AUnderFileSystem``); speaks SigV4 when keys are configured and
    anonymous otherwise (fake servers / public buckets)."""

    supports_multipart = True

    def __init__(self, bucket: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        props = properties or {}
        self._bucket = bucket
        endpoint = props.get("s3.endpoint",
                             os.environ.get("ATPU_S3_ENDPOINT", ""))
        self._region = props.get("s3.region", "us-east-1")
        path_style = props.get(
            "s3.path.style", "true" if endpoint else "false") == "true"
        if not endpoint:
            endpoint = f"https://s3.{self._region}.amazonaws.com"
        endpoint = endpoint.rstrip("/")
        self._base = (f"{endpoint}/{bucket}" if path_style else
                      endpoint.replace("://", f"://{bucket}."))
        ak = props.get("s3.access.key", os.environ.get("AWS_ACCESS_KEY_ID", ""))
        sk = props.get("s3.secret.key",
                       os.environ.get("AWS_SECRET_ACCESS_KEY", ""))
        self._signer = SigV4Signer(ak, sk, self._region) if ak else None
        self._session = requests.Session()
        self.multipart_size = int(props.get("s3.multipart.size", 8 << 20))

    # -- plumbing ------------------------------------------------------------
    def _request(self, method: str, key: str = "", *, params=None,
                 data: bytes = b"", headers=None,
                 stream: bool = False) -> requests.Response:
        url = f"{self._base}/{_uri_encode(key, encode_slash=False)}"
        if params:
            url += "?" + urllib.parse.urlencode(sorted(params.items()))
        headers = dict(headers or {})
        if self._signer is not None:
            sha = hashlib.sha256(data).hexdigest() if data else _EMPTY_SHA256
            headers = self._signer.sign(method, url, headers, sha)
        return self._session.request(method, url, data=data or None,
                                     headers=headers, stream=stream,
                                     timeout=60)

    # -- ObjectStoreClient ---------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        r = self._request("PUT", key, data=data)
        r.raise_for_status()

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._request("GET", key, headers=headers)
        if r.status_code == 404:
            return None
        if r.status_code == 416:  # zero-length range past EOF
            return b""
        r.raise_for_status()
        return r.content

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        r = self._request("HEAD", key)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        from alluxio_tpu_torch.underfs.web import _parse_http_date

        length = int(r.headers.get("Content-Length", 0))
        mtime = _parse_http_date(r.headers.get("Last-Modified")) or 0
        return (length, mtime, r.headers.get("ETag", "").strip('"'))

    def delete(self, key: str) -> bool:
        r = self._request("DELETE", key)
        return r.status_code in (200, 204)

    def copy(self, src_key: str, dst_key: str) -> bool:
        r = self._request(
            "PUT", dst_key,
            headers={"x-amz-copy-source":
                     f"/{self._bucket}/{_uri_encode(src_key, False)}"})
        return r.ok

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        token = None
        while True:
            params = {"list-type": "2", "prefix": prefix,
                      "max-keys": "1000"}
            if token:
                params["continuation-token"] = token
            r = self._request("GET", "", params=params)
            r.raise_for_status()
            root = ET.fromstring(r.content)
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for el in root.iter(f"{ns}Contents"):
                k = el.find(f"{ns}Key")
                if k is not None and k.text:
                    keys.append(k.text)
            truncated = root.find(f"{ns}IsTruncated")
            if truncated is None or truncated.text != "true":
                break
            tok = root.find(f"{ns}NextContinuationToken")
            token = tok.text if tok is not None else None
            if not token:
                break
        return keys

    # -- multipart (reference: S3ALowLevelOutputStream) ----------------------
    def initiate_multipart(self, key: str) -> str:
        r = self._request("POST", key, params={"uploads": ""})
        r.raise_for_status()
        root = ET.fromstring(r.content)
        ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
        upload_id = root.find(f"{ns}UploadId")
        if upload_id is None or not upload_id.text:
            raise IOError(f"multipart initiate for {key!r}: response "
                          "carried no UploadId")
        return upload_id.text

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes) -> str:
        r = self._request("PUT", key, params={
            "partNumber": str(part_number), "uploadId": upload_id},
            data=data)
        r.raise_for_status()
        return r.headers.get("ETag", "").strip('"')

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[Tuple[int, str]]) -> None:
        body = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
            for n, e in etags) + "</CompleteMultipartUpload>"
        r = self._request("POST", key, params={"uploadId": upload_id},
                          data=body.encode())
        r.raise_for_status()

    def abort_multipart(self, key: str, upload_id: str) -> None:
        self._request("DELETE", key, params={"uploadId": upload_id})


class S3UnderFileSystem(ObjectUnderFileSystem):
    """``s3://bucket/...`` (reference: S3AUnderFileSystem)."""

    schemes = ("s3", "s3a")

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        rest = root_uri.split("://", 1)[1] if "://" in root_uri else root_uri
        bucket = rest.partition("/")[0]
        super().__init__(root_uri, self._make_client(bucket, properties),
                         properties)

    def _make_client(self, bucket: str,
                     properties: Optional[Dict[str, str]]) -> S3Client:
        return S3Client(bucket, properties)

    # create() comes from ObjectUnderFileSystem: S3Client advertises
    # supports_multipart, so large writes stream via the shared
    # MultipartWriter
