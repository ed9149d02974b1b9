"""Azure storage UFS connectors: wasb (Blob REST) and abfs/adl (ADLS Gen2)
(a copy of ``alluxio_tpu/underfs/azure.py``).

Re-designs of ``underfs/wasb/src/main/java/alluxio/underfs/wasb/
WasbUnderFileSystem.java`` and ``underfs/adl`` / ``underfs/abfs`` (the
reference delegates to hadoop-azure's SDK clients): this build speaks
the two Azure REST dialects directly —

* **wasb** — the Blob service REST API (``PUT Blob`` / ``Get Blob`` with
  Range / ``List Blobs``), SharedKey- or SAS-authenticated.
* **abfs / adl** — the ADLS Gen2 "DFS" paths API (create + append +
  flush, JSON listings).

URI forms (matching hadoop-azure):
  ``wasb://container@account.blob.core.windows.net/path``
  ``abfs://filesystem@account.dfs.core.windows.net/path``

Properties (also accepted without the vendor prefix via ``azure.*``):
  azure.endpoint     endpoint override (tests / azurite / private clouds)
  azure.account.key  base64 SharedKey; absent + no SAS -> anonymous
  azure.sas.token    SAS query string (``sv=...&sig=...``)
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import xml.etree.ElementTree as ET
from email.utils import formatdate, parsedate_to_datetime
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, unquote_plus, urlsplit

import requests

from alluxio_tpu_torch.underfs.object_base import (
    ObjectStoreClient, ObjectUnderFileSystem,
)

_API_VERSION = "2021-08-06"


def _parse_authority(root_uri: str) -> Tuple[str, str, str]:
    """``scheme://container@account.suffix/...`` ->
    (container, account, default_endpoint)."""
    rest = root_uri.split("://", 1)[1] if "://" in root_uri else root_uri
    authority = rest.partition("/")[0]
    if "@" in authority:
        container, _, host = authority.partition("@")
        account = host.partition(".")[0]
        return container, account, f"https://{host}"
    # bare ``scheme://container/...`` (endpoint must come from properties)
    return authority, "", ""


def _http_date_ms(value: str) -> int:
    try:
        return int(parsedate_to_datetime(value).timestamp() * 1000)
    except Exception:  # noqa: BLE001
        return int(time.time() * 1000)


class _SharedKey:
    """SharedKey request signer (Blob/DFS string-to-sign, 2021 dialect)."""

    def __init__(self, account: str, key_b64: str) -> None:
        self.account = account
        self._key = base64.b64decode(key_b64)

    def sign(self, method: str, url: str,
             headers: Dict[str, str]) -> str:
        parts = urlsplit(url)
        canon_headers = "".join(
            f"{k}:{v}\n" for k, v in sorted(headers.items())
            if k.startswith("x-ms-"))
        canon_res = f"/{self.account}{parts.path}"
        if parts.query:
            # Azure computes the string-to-sign over URL-DECODED query
            # names/values (SharedKey spec "Constructing the canonicalized
            # resource string"): a prefix containing %2F or a continuation
            # token with '+'/'=' must be decoded here or the service
            # rejects the signature with 403 AuthenticationFailed.
            q: Dict[str, List[str]] = {}
            for kv in parts.query.split("&"):
                k, _, v = kv.partition("=")
                q.setdefault(unquote_plus(k).lower(), []).append(
                    unquote_plus(v))
            for k in sorted(q):
                canon_res += f"\n{k}:{','.join(sorted(q[k]))}"
        to_sign = "\n".join([
            method,
            headers.get("Content-Encoding", ""),
            headers.get("Content-Language", ""),
            headers.get("Content-Length", "") or "",
            headers.get("Content-MD5", ""),
            headers.get("Content-Type", ""),
            "",  # Date: always sent via x-ms-date instead
            headers.get("If-Modified-Since", ""),
            headers.get("If-Match", ""),
            headers.get("If-None-Match", ""),
            headers.get("If-Unmodified-Since", ""),
            headers.get("Range", ""),
            canon_headers + canon_res,
        ])
        sig = base64.b64encode(
            hmac.new(self._key, to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"


class _AzureRestBase(ObjectStoreClient):
    """Shared endpoint/auth plumbing for the two dialects."""

    def __init__(self, container: str, account: str,
                 default_endpoint: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        props = properties or {}
        self._container = container
        self._endpoint = (props.get("azure.endpoint") or default_endpoint
                          or "").rstrip("/")
        if not self._endpoint:
            raise ValueError(
                "no Azure endpoint: use the "
                "container@account.host URI form or set azure.endpoint")
        account = props.get("azure.account", account) or "devaccount"
        key = props.get("azure.account.key", "")
        self._sas = props.get("azure.sas.token", "").lstrip("?")
        self._signer = _SharedKey(account, key) if key else None
        self._session = requests.Session()

    def _url(self, key: str, query: str = "") -> str:
        url = f"{self._endpoint}/{self._container}"
        if key:
            url += "/" + quote(key, safe="/")
        qs = [q for q in (query, self._sas) if q]
        if qs:
            url += "?" + "&".join(qs)
        return url

    def _request(self, method: str, url: str, *, data: bytes = b"",
                 headers: Optional[Dict[str, str]] = None):
        hdrs = dict(headers or {})
        hdrs["x-ms-version"] = _API_VERSION
        hdrs["x-ms-date"] = formatdate(usegmt=True)
        if self._signer is not None:
            # Content-Length participates in the string-to-sign but the
            # transport sets the actual header from the body
            sign_hdrs = dict(hdrs)
            if data:
                sign_hdrs["Content-Length"] = str(len(data))
            hdrs["Authorization"] = self._signer.sign(
                method, url, sign_hdrs)
        return self._session.request(method, url, data=data,
                                     headers=hdrs, timeout=60)

    # shared across both dialects: ranged read and delete are identical
    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._request("GET", self._url(key), headers=headers)
        if r.status_code == 404:
            return None
        if r.status_code == 416:
            return b""
        r.raise_for_status()
        return r.content

    def delete(self, key: str) -> bool:
        r = self._request("DELETE", self._url(key))
        return r.status_code in (200, 202, 204)


class AzureBlobClient(_AzureRestBase):
    """Blob service dialect (wasb)."""

    def put(self, key: str, data: bytes) -> None:
        r = self._request("PUT", self._url(key), data=data,
                          headers={"x-ms-blob-type": "BlockBlob"})
        r.raise_for_status()

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        r = self._request("HEAD", self._url(key))
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return (int(r.headers.get("Content-Length", 0)),
                _http_date_ms(r.headers.get("Last-Modified", "")),
                r.headers.get("ETag", ""))

    def copy(self, src_key: str, dst_key: str) -> bool:
        r = self._request(
            "PUT", self._url(dst_key),
            headers={"x-ms-copy-source": self._url(src_key)})
        if r.status_code not in (200, 201, 202):
            return False
        # poll async copies to completion (tests/azurite complete sync)
        for _ in range(60):
            status = r.headers.get("x-ms-copy-status", "success")
            if status == "success":
                return True
            if status in ("failed", "aborted"):
                return False
            time.sleep(0.5)
            h = self._request("HEAD", self._url(dst_key))
            r = h
        return False

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        marker = ""
        while True:
            q = (f"restype=container&comp=list"
                 f"&prefix={quote(prefix, safe='')}")
            if marker:
                q += f"&marker={quote(marker, safe='')}"
            r = self._request("GET", self._url("", q))
            r.raise_for_status()
            root = ET.fromstring(r.content)
            for b in root.iter("Blob"):
                name = b.findtext("Name")
                if name:
                    keys.append(name)
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return keys


class AdlsGen2Client(_AzureRestBase):
    """ADLS Gen2 "DFS" paths dialect (abfs/adl): writes are
    create + append + flush; listings are JSON."""

    def put(self, key: str, data: bytes) -> None:
        r = self._request("PUT", self._url(key, "resource=file"))
        r.raise_for_status()
        if data:
            r = self._request(
                "PATCH", self._url(key, "action=append&position=0"),
                data=data)
            r.raise_for_status()
        r = self._request(
            "PATCH", self._url(key, f"action=flush&position={len(data)}"))
        r.raise_for_status()

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        r = self._request("HEAD", self._url(key))
        if r.status_code == 404:
            return None
        r.raise_for_status()
        if r.headers.get("x-ms-resource-type") == "directory":
            return None  # object contract: directories are not blobs
        return (int(r.headers.get("Content-Length", 0)),
                _http_date_ms(r.headers.get("Last-Modified", "")),
                r.headers.get("ETag", ""))

    def copy(self, src_key: str, dst_key: str) -> bool:
        # the DFS dialect has rename but no server-side copy: stream
        data = self.get(src_key)
        if data is None:
            return False
        self.put(dst_key, data)
        return True

    def rename(self, src_key: str, dst_key: str) -> bool:
        """Native HNS rename (atomic server-side; no copy+delete)."""
        r = self._request(
            "PUT", self._url(dst_key),
            headers={"x-ms-rename-source":
                     f"/{self._container}/{quote(src_key, safe='/')}"})
        return r.status_code in (200, 201)

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        token = ""
        while True:
            q = "resource=filesystem&recursive=true"
            if prefix:
                q += f"&directory={quote(prefix, safe='')}"
            if token:
                q += f"&continuation={quote(token, safe='')}"
            r = self._request("GET", self._url("", q))
            if r.status_code == 404:
                return keys
            r.raise_for_status()
            for p in r.json().get("paths", []):
                if not p.get("isDirectory") in (True, "true"):
                    keys.append(p["name"])
            token = r.headers.get("x-ms-continuation", "")
            if not token:
                return keys


class WasbUnderFileSystem(ObjectUnderFileSystem):
    """``wasb://container@account.blob.core.windows.net/...``."""

    schemes = ("wasb", "wasbs")

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        container, account, endpoint = _parse_authority(root_uri)
        client = AzureBlobClient(container, account, endpoint, properties)
        super().__init__(root_uri, client, properties)
        self._bucket = container

    def get_underfs_type(self) -> str:
        return "wasb"


class AdlsUnderFileSystem(ObjectUnderFileSystem):
    """``abfs://filesystem@account.dfs.core.windows.net/...`` (also
    registered for the legacy ``adl`` scheme)."""

    schemes = ("abfs", "abfss", "adl")

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        container, account, endpoint = _parse_authority(root_uri)
        client = AdlsGen2Client(container, account, endpoint, properties)
        super().__init__(root_uri, client, properties)
        self._bucket = container

    def get_underfs_type(self) -> str:
        return "abfs"

    def rename_file(self, src: str, dst: str) -> bool:
        # HNS gives real rename: one call, atomic, no copy+delete
        return self._client.rename(self._key(src), self._key(dst))
