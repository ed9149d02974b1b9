"""OpenStack Swift UFS connector — NATIVE dialect (a copy of
``alluxio_tpu/underfs/swift.py``).

Re-design of ``underfs/swift/src/main/java/alluxio/underfs/swift/
SwiftUnderFileSystem.java:59`` (which delegates auth to JOSS): this
build speaks Keystone v3 and the Swift object API directly —

* **auth**: ``POST {auth_url}/auth/tokens`` with password credentials
  scoped to a project; the ``X-Subject-Token`` header carries the token
  and the response catalog carries the object-store endpoint. Tokens
  refresh automatically on expiry/401 (JOSS does the same re-auth).
* **objects**: ``PUT/GET(+Range)/HEAD/DELETE {storage}/{container}/
  {key}``; listings are ``?format=json&prefix=&marker=`` pages; server-
  side copy via the ``X-Copy-From`` header.

Properties:
  swift.auth.url        Keystone v3 base (``https://ks:5000/v3``).
                        ABSENT -> the connector falls back to the S3-
                        middleware gateway dialect (s3_compat), keeping
                        old configs working.
  swift.user / swift.password / swift.project
  swift.domain          user+project domain name (default "Default")
  swift.region          pick this region's endpoint from the catalog
"""

from __future__ import annotations

import json
import threading
import time
from email.utils import parsedate_to_datetime
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

import requests

from alluxio_tpu_torch.underfs.object_base import (
    ObjectStoreClient, ObjectUnderFileSystem,
)


class KeystoneSession:
    """Keystone v3 password auth + catalog endpoint resolution, with
    lazy (re)authentication shared by all requests of one connector."""

    def __init__(self, auth_url: str, user: str, password: str,
                 project: str, domain: str = "Default",
                 region: str = "") -> None:
        self._auth_url = auth_url.rstrip("/")
        self._user = user
        self._password = password
        self._project = project
        self._domain = domain or "Default"
        self._region = region
        self._lock = threading.Lock()
        self._token: Optional[str] = None
        self._storage_url: Optional[str] = None
        self.http = requests.Session()

    def _authenticate_locked(self) -> None:
        body = {"auth": {
            "identity": {"methods": ["password"], "password": {"user": {
                "name": self._user,
                "domain": {"name": self._domain},
                "password": self._password}}},
            "scope": {"project": {"name": self._project,
                                  "domain": {"name": self._domain}}},
        }}
        r = self.http.post(f"{self._auth_url}/auth/tokens", json=body,
                           timeout=30)
        r.raise_for_status()
        self._token = r.headers["X-Subject-Token"]
        catalog = (r.json().get("token") or {}).get("catalog") or []
        url = None
        for svc in catalog:
            if svc.get("type") != "object-store":
                continue
            for ep in svc.get("endpoints", []):
                if ep.get("interface") != "public":
                    continue
                if self._region and ep.get("region") != self._region:
                    continue
                url = ep.get("url")
                break
        if url is None:
            raise IOError(
                "keystone catalog has no public object-store endpoint"
                + (f" in region {self._region!r}" if self._region else ""))
        self._storage_url = url.rstrip("/")

    def credentials(self) -> Tuple[str, str]:
        with self._lock:
            if self._token is None:
                self._authenticate_locked()
            return self._token, self._storage_url

    def invalidate(self) -> None:
        with self._lock:
            self._token = None


class SwiftClient(ObjectStoreClient):
    """Swift object API over a KeystoneSession."""

    def __init__(self, container: str, session: KeystoneSession) -> None:
        self._container = container
        self._ks = session

    def _request(self, method: str, key: str = "", *, params=None,
                 data=None, headers=None, retry_auth: bool = True):
        token, storage = self._ks.credentials()
        url = f"{storage}/{quote(self._container)}"
        if key:
            url += "/" + quote(key, safe="/")
        hdrs = dict(headers or {})
        hdrs["X-Auth-Token"] = token
        r = self._ks.http.request(method, url, params=params, data=data,
                                  headers=hdrs, timeout=60)
        if r.status_code == 401 and retry_auth:
            # expired token: re-auth once (JOSS re-auth behavior)
            self._ks.invalidate()
            return self._request(method, key, params=params, data=data,
                                 headers=headers, retry_auth=False)
        return r

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
        if r.status_code == 416:
            return b""
        r.raise_for_status()
        return r.content

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        r = self._request("HEAD", key)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        mtime = 0
        lm = r.headers.get("Last-Modified") or r.headers.get(
            "X-Timestamp")
        if lm:
            try:
                mtime = int(float(lm) * 1000)
            except ValueError:
                try:
                    mtime = int(
                        parsedate_to_datetime(lm).timestamp() * 1000)
                except Exception:  # noqa: BLE001
                    mtime = int(time.time() * 1000)
        return (int(r.headers.get("Content-Length", 0)), mtime,
                r.headers.get("Etag", ""))

    def delete(self, key: str) -> bool:
        r = self._request("DELETE", key)
        return r.status_code in (200, 204)

    def copy(self, src_key: str, dst_key: str) -> bool:
        r = self._request(
            "PUT", dst_key,
            headers={"X-Copy-From":
                     f"/{self._container}/{quote(src_key, safe='/')}"})
        return r.status_code in (200, 201, 202)

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        marker = ""
        while True:
            params = {"format": "json", "prefix": prefix}
            if marker:
                params["marker"] = marker
            r = self._request("GET", params=params)
            if r.status_code == 404:
                return keys
            r.raise_for_status()
            page = json.loads(r.content or b"[]")
            if not page:
                return keys
            for obj in page:
                name = obj.get("name")
                if name:
                    keys.append(name)
            marker = page[-1].get("name", "")
            if not marker:
                return keys


class SwiftNativeUnderFileSystem(ObjectUnderFileSystem):
    """``swift://container/...`` over Keystone v3 + the Swift API."""

    schemes = ("swift",)

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        props = properties or {}
        rest = root_uri.split("://", 1)[1] if "://" in root_uri else root_uri
        container = rest.partition("/")[0]
        session = KeystoneSession(
            props["swift.auth.url"],
            props.get("swift.user", ""),
            props.get("swift.password", ""),
            props.get("swift.project", ""),
            domain=props.get("swift.domain", "Default"),
            region=props.get("swift.region", ""))
        super().__init__(root_uri, SwiftClient(container, session),
                         properties=props)

    def get_underfs_type(self) -> str:
        return "swift"


def create_swift_ufs(root_uri: str,
                     properties: Optional[Dict[str, str]] = None):
    """Dialect dispatch: Keystone native when ``swift.auth.url`` is
    configured, S3-middleware gateway otherwise (old configs keep
    working; reference ``SwiftUnderFileSystem`` likewise speaks either
    Keystone v2/v3 via JOSS or tempauth)."""
    props = properties or {}
    if props.get("swift.auth.url"):
        return SwiftNativeUnderFileSystem(root_uri, props)
    from alluxio_tpu_torch.underfs.s3_compat import SwiftUnderFileSystem

    return SwiftUnderFileSystem(root_uri, props)
