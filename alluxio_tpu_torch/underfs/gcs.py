"""GCS UFS connector over the JSON API (a copy of
``alluxio_tpu/underfs/gcs.py``).

Re-design of ``underfs/gcs/src/main/java/alluxio/underfs/gcs/
GCSUnderFileSystem.java`` (jets3t-based in the reference): this build
speaks the GCS JSON API directly (``storage/v1``), which is what TPU-VM
metadata-server tokens authorize. Endpoint-overridable for the in-process
fake server in tests.

Properties:
  gcs.endpoint  override (default https://storage.googleapis.com)
  gcs.token     static bearer token; when absent, tries the GCE metadata
                server (TPU VMs), then falls back to anonymous
"""

from __future__ import annotations

import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

import requests

from alluxio_tpu_torch.underfs.object_base import (
    ObjectStoreClient, ObjectUnderFileSystem,
)

_METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                       "instance/service-accounts/default/token")


class GcsJsonClient(ObjectStoreClient):
    def __init__(self, bucket: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        props = properties or {}
        self._bucket = bucket
        self._base = props.get(
            "gcs.endpoint", os.environ.get("ATPU_GCS_ENDPOINT",
                                           "https://storage.googleapis.com")
        ).rstrip("/")
        self._static_token = props.get("gcs.token", "")
        self._session = requests.Session()
        self._cached_token = ""
        self._token_expiry = 0.0

    def _headers(self) -> Dict[str, str]:
        import time

        tok = self._static_token
        if not tok and "googleapis.com" in self._base:
            if self._cached_token and time.monotonic() < self._token_expiry:
                tok = self._cached_token
            else:
                try:  # TPU-VM / GCE metadata token, cached until expiry
                    r = self._session.get(
                        _METADATA_TOKEN_URL,
                        headers={"Metadata-Flavor": "Google"}, timeout=2)
                    if r.ok:
                        body = r.json()
                        tok = body.get("access_token", "")
                        self._cached_token = tok
                        self._token_expiry = time.monotonic() + max(
                            30.0, float(body.get("expires_in", 300)) - 60.0)
                except requests.RequestException:
                    pass
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def _obj_url(self, key: str, alt_media: bool = False) -> str:
        u = (f"{self._base}/storage/v1/b/{self._bucket}/o/"
             f"{urllib.parse.quote(key, safe='')}")
        return u + "?alt=media" if alt_media else u

    def put(self, key: str, data: bytes) -> None:
        r = self._session.post(
            f"{self._base}/upload/storage/v1/b/{self._bucket}/o",
            params={"uploadType": "media", "name": key}, data=data,
            headers=self._headers(), timeout=60)
        r.raise_for_status()

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        headers = self._headers()
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._session.get(self._obj_url(key, alt_media=True),
                              headers=headers, timeout=60)
        if r.status_code == 404:
            return None
        if r.status_code == 416:
            return b""
        r.raise_for_status()
        return r.content

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        r = self._session.get(self._obj_url(key), headers=self._headers(),
                              timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        meta = r.json()
        import datetime

        mtime = 0
        if meta.get("updated"):
            try:
                mtime = int(datetime.datetime.fromisoformat(
                    meta["updated"].replace("Z", "+00:00")
                ).timestamp() * 1000)
            except ValueError:
                pass
        return (int(meta.get("size", 0)), mtime, meta.get("etag", ""))

    def delete(self, key: str) -> bool:
        r = self._session.delete(self._obj_url(key),
                                 headers=self._headers(), timeout=30)
        return r.status_code in (200, 204)

    def copy(self, src_key: str, dst_key: str) -> bool:
        # rewriteTo may return done=false + rewriteToken for large objects;
        # loop until the rewrite completes or deletion of the source after a
        # half-finished copy would lose data
        url = (f"{self._base}/storage/v1/b/{self._bucket}/o/"
               f"{urllib.parse.quote(src_key, safe='')}/rewriteTo/b/"
               f"{self._bucket}/o/{urllib.parse.quote(dst_key, safe='')}")
        token = None
        for _ in range(64):
            params = {"rewriteToken": token} if token else {}
            r = self._session.post(url, params=params,
                                   headers=self._headers(), timeout=60)
            if not r.ok:
                return False
            body = r.json()
            if body.get("done", True):
                return True
            token = body.get("rewriteToken")
            if not token:
                return False
        return False

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        page_token = None
        while True:
            params = {"prefix": prefix, "maxResults": "1000"}
            if page_token:
                params["pageToken"] = page_token
            r = self._session.get(
                f"{self._base}/storage/v1/b/{self._bucket}/o",
                params=params, headers=self._headers(), timeout=30)
            r.raise_for_status()
            body = r.json()
            keys.extend(item["name"] for item in body.get("items", []))
            page_token = body.get("nextPageToken")
            if not page_token:
                break
        return keys


class GcsUnderFileSystem(ObjectUnderFileSystem):
    """``gs://bucket/...`` (reference: GCSUnderFileSystem)."""

    schemes = ("gs", "gcs")

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        rest = root_uri.split("://", 1)[1] if "://" in root_uri else root_uri
        bucket = rest.partition("/")[0]
        super().__init__(root_uri, GcsJsonClient(bucket, properties),
                         properties)
