"""Native auth dialects for the Chinese-cloud object stores (a copy of
``alluxio_tpu/underfs/vendor_native.py``).

The reference ships SDK connectors per vendor —
``underfs/oss/.../OSSUnderFileSystem.java`` (Alibaba SDK, "OSS ak:sig"
header auth), ``underfs/cos/.../COSUnderFileSystem.java`` (Tencent SDK,
``q-sign-algorithm`` auth string), ``underfs/kodo/.../
KodoUnderFileSystem.java`` (Qiniu SDK, QBox tokens + private download
URLs). This build already serves all three through their
S3-compatible gateways (``s3_compat.py``); these clients add the
vendors' NATIVE wire auth for deployments where the gateway is
unavailable or feature-gapped, selected with ``<vendor>.dialect =
native`` (the gateway remains the default, so existing configs keep
working).

Auth schemes implemented from the public API docs:
  OSS   Authorization: ``OSS <ak>:<b64(hmac-sha1(sk, VERB\\n MD5\\n
        Type\\n Date\\n CanonicalizedOSSHeaders CanonicalizedResource))>``
  COS   Authorization: ``q-sign-algorithm=sha1&q-ak=..&q-sign-time=a;b&
        q-key-time=a;b&q-header-list=..&q-url-param-list=..&
        q-signature=<hmac-sha1 chain>``
  Kodo  management (rs/rsf): ``QBox <ak>:<urlsafe-b64(hmac-sha1(sk,
        path?query\\n body))>``; uploads: form upload with a signed
        PutPolicy uptoken; downloads: private-URL ``e=<deadline>&
        token=<ak>:<sig>`` against the bucket's download host.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, List, Optional, Tuple

import requests

from alluxio_tpu_torch.underfs.object_base import ObjectStoreClient


def _hmac_sha1(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha1).digest()


def _parse_http_date(value: Optional[str]) -> int:
    from alluxio_tpu_torch.underfs.web import _parse_http_date as p

    return p(value) or 0


def _xml_keys(content: bytes) -> Tuple[List[str], bool, str]:
    """V1-style bucket listing XML -> (keys, truncated, next_marker)."""
    root = ET.fromstring(content)
    ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
    keys = [k.text for el in root.iter(f"{ns}Contents")
            for k in [el.find(f"{ns}Key")]
            if k is not None and k.text]
    trunc = root.find(f"{ns}IsTruncated")
    truncated = trunc is not None and trunc.text == "true"
    nm = root.find(f"{ns}NextMarker")
    next_marker = nm.text if nm is not None and nm.text else \
        (keys[-1] if truncated and keys else "")
    return keys, truncated, next_marker


class _XmlVendorClient(ObjectStoreClient):
    """Shared REST surface for the XML-API vendors (OSS, COS): the ops
    match S3's shapes; only auth and the copy header differ."""

    copy_header = ""
    supports_multipart = True

    def __init__(self, bucket: str, endpoint: str, ak: str, sk: str,
                 path_style: bool, multipart_size: int = 8 << 20) -> None:
        self._bucket = bucket
        self._ak, self._sk = ak, sk
        self._path_style = path_style
        self.multipart_size = multipart_size
        endpoint = endpoint.rstrip("/")
        self._base = (f"{endpoint}/{bucket}" if path_style else
                      endpoint.replace("://", f"://{bucket}."))
        self._host = urllib.parse.urlsplit(self._base).netloc
        self._session = requests.Session()

    def _uri_path(self, key: str) -> str:
        """The path as it appears ON THE WIRE — what signatures must
        cover (path-style requests carry the bucket segment)."""
        return (f"/{self._bucket}/{key}" if self._path_style
                else f"/{key}")

    # subclasses implement --------------------------------------------------
    def _auth(self, method: str, key: str, params: Dict[str, str],
              headers: Dict[str, str], data: bytes) -> None:
        raise NotImplementedError

    # -- plumbing ------------------------------------------------------------
    def _request(self, method: str, key: str = "", *, params=None,
                 data: bytes = b"", headers=None) -> requests.Response:
        params = dict(params or {})
        headers = dict(headers or {})
        self._auth(method, key, params, headers, data)
        url = self._base + "/" + urllib.parse.quote(key)
        if params:
            url += "?" + urllib.parse.urlencode(sorted(params.items()))
        return self._session.request(method, url, data=data or None,
                                     headers=headers, timeout=60)

    # -- ObjectStoreClient ---------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        self._request("PUT", key, data=data).raise_for_status()

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
        return (int(r.headers.get("Content-Length", 0)),
                _parse_http_date(r.headers.get("Last-Modified")),
                r.headers.get("ETag", "").strip('"'))

    def delete(self, key: str) -> bool:
        return self._request("DELETE", key).status_code in (200, 204)

    def copy(self, src_key: str, dst_key: str) -> bool:
        src = f"/{self._bucket}/{urllib.parse.quote(src_key)}"
        return self._request("PUT", dst_key,
                             headers={self.copy_header: src}).ok

    def list_prefix(self, prefix: str) -> List[str]:
        # V1 marker paging — the native XML APIs have no V2
        # continuation tokens
        keys: List[str] = []
        marker = ""
        while True:
            params = {"prefix": prefix, "max-keys": "1000"}
            if marker:
                params["marker"] = marker
            r = self._request("GET", "", params=params)
            r.raise_for_status()
            page, truncated, marker = _xml_keys(r.content)
            keys.extend(page)
            if not truncated or not marker:
                return keys

    # -- multipart (both vendors' native multipart APIs are S3-shaped;
    # feeds the shared object_base.MultipartWriter) ----------------------
    def initiate_multipart(self, key: str) -> str:
        r = self._request("POST", key, params={"uploads": ""})
        r.raise_for_status()
        root = ET.fromstring(r.content)
        ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
        upload_id = root.find(f"{ns}UploadId")
        if upload_id is None or not upload_id.text:
            # fail HERE, not with an opaque 404 on the first part (or a
            # nonsense abort with an empty id)
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


class OssNativeClient(_XmlVendorClient):
    """Alibaba OSS header signing (SDK analogue:
    ``OSSUnderFileSystem.java``)."""

    copy_header = "x-oss-copy-source"
    #: query params that are SIGNED subresources per the OSS spec
    #: (prefix/marker/max-keys are NOT — they stay out of the
    #: CanonicalizedResource)
    _SIGNED_SUBRESOURCES = ("partNumber", "uploadId", "uploads")

    def _auth(self, method, key, params, headers, data) -> None:
        date = formatdate(usegmt=True)
        headers["Date"] = date
        headers["Host"] = self._host
        if data:
            headers["Content-MD5"] = base64.b64encode(
                hashlib.md5(data).digest()).decode()
        oss_headers = "".join(
            f"{k.lower()}:{v}\n" for k, v in sorted(headers.items())
            if k.lower().startswith("x-oss-"))
        resource = f"/{self._bucket}/{key}"
        sub = sorted((k, v) for k, v in params.items()
                     if k in self._SIGNED_SUBRESOURCES)
        if sub:
            # OSS V1 canonicalization: valueless subresources render
            # BARE ("?uploads", no '='), values unencoded — urlencode
            # here would sign a string the server never sees
            resource += "?" + "&".join(
                k if v == "" else f"{k}={v}" for k, v in sub)
        canonical = "\n".join([
            method, headers.get("Content-MD5", ""),
            headers.get("Content-Type", ""), date,
            oss_headers + resource])
        sig = base64.b64encode(_hmac_sha1(
            self._sk.encode(), canonical.encode())).decode()
        headers["Authorization"] = f"OSS {self._ak}:{sig}"


class CosNativeClient(_XmlVendorClient):
    """Tencent COS request signing (SDK analogue:
    ``COSUnderFileSystem.java``)."""

    copy_header = "x-cos-copy-source"

    def _auth(self, method, key, params, headers, data) -> None:
        headers["Host"] = self._host
        now = int(time.time())
        key_time = f"{now - 60};{now + 3600}"
        sign_key = hmac.new(self._sk.encode(), key_time.encode(),
                            hashlib.sha1).hexdigest()
        # canonical params/headers: lowercased, url-encoded, sorted
        p_items = sorted((k.lower(), urllib.parse.quote(str(v), safe=""))
                         for k, v in params.items())
        h_items = sorted((k.lower(), urllib.parse.quote(str(v), safe=""))
                         for k, v in headers.items())
        url_param_list = ";".join(k for k, _ in p_items)
        header_list = ";".join(k for k, _ in h_items)
        http_string = "\n".join([
            method.lower(), self._uri_path(key),
            "&".join(f"{k}={v}" for k, v in p_items),
            "&".join(f"{k}={v}" for k, v in h_items), ""])
        string_to_sign = "\n".join([
            "sha1", key_time,
            hashlib.sha1(http_string.encode()).hexdigest(), ""])
        signature = hmac.new(sign_key.encode(),
                             string_to_sign.encode(),
                             hashlib.sha1).hexdigest()
        headers["Authorization"] = "&".join([
            "q-sign-algorithm=sha1",
            f"q-ak={self._ak}",
            f"q-sign-time={key_time}",
            f"q-key-time={key_time}",
            f"q-header-list={header_list}",
            f"q-url-param-list={url_param_list}",
            f"q-signature={signature}"])


class KodoNativeClient(ObjectStoreClient):
    """Qiniu Kodo native protocol (SDK analogue:
    ``KodoUnderFileSystem.java`` + ``KodoClient.java``): management ops
    against the rs/rsf hosts with QBox tokens, uploads via a signed
    PutPolicy uptoken, reads via private download URLs."""

    def __init__(self, bucket: str, ak: str, sk: str, *,
                 rs_host: str = "https://rs.qiniuapi.com",
                 rsf_host: str = "https://rsf.qiniuapi.com",
                 up_host: str = "https://upload.qiniup.com",
                 download_host: str = "") -> None:
        self._bucket = bucket
        self._ak, self._sk = ak, sk
        self._rs = rs_host.rstrip("/")
        self._rsf = rsf_host.rstrip("/")
        self._up = up_host.rstrip("/")
        if not download_host:
            raise ValueError(
                "kodo needs kodo.download.host (the bucket's bound "
                "domain — Kodo serves data via domains, not the API "
                "hosts; reference KodoUnderFileSystem.java)")
        self._dl = download_host.rstrip("/")
        if "://" not in self._dl:
            self._dl = "http://" + self._dl
        self._session = requests.Session()

    # -- tokens --------------------------------------------------------------
    def _qbox_token(self, path_and_query: str, body: bytes = b"") -> str:
        data = path_and_query.encode() + b"\n" + body
        sig = base64.urlsafe_b64encode(
            _hmac_sha1(self._sk.encode(), data)).decode()
        return f"QBox {self._ak}:{sig}"

    def _uptoken(self, key: str) -> str:
        policy = base64.urlsafe_b64encode(json.dumps({
            "scope": f"{self._bucket}:{key}",
            "deadline": int(time.time()) + 3600,
            "insertOnly": 0,
        }).encode()).decode()
        sig = base64.urlsafe_b64encode(_hmac_sha1(
            self._sk.encode(), policy.encode())).decode()
        return f"{self._ak}:{sig}:{policy}"

    def _entry(self, key: str) -> str:
        return base64.urlsafe_b64encode(
            f"{self._bucket}:{key}".encode()).decode()

    def _rs_post(self, path: str) -> requests.Response:
        return self._session.post(
            self._rs + path,
            headers={"Authorization": self._qbox_token(path),
                     "Content-Type":
                         "application/x-www-form-urlencoded"},
            timeout=60)

    # -- ObjectStoreClient ---------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        r = self._session.post(self._up + "/", files={
            "file": (key, data)}, data={
            "token": self._uptoken(key), "key": key}, timeout=60)
        r.raise_for_status()

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        # private download URL: e=<deadline>&token=ak:sign(url)
        url = f"{self._dl}/{urllib.parse.quote(key)}" \
              f"?e={int(time.time()) + 3600}"
        sig = base64.urlsafe_b64encode(_hmac_sha1(
            self._sk.encode(), url.encode())).decode()
        url += f"&token={self._ak}:{sig}"
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._session.get(url, headers=headers, timeout=60)
        if r.status_code == 404:
            return None
        if r.status_code == 416:
            return b""
        r.raise_for_status()
        return r.content

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        path = f"/stat/{self._entry(key)}"
        r = self._rs_post(path)
        if r.status_code == 404 or (
                r.status_code == 612):  # 612: no such entry
            return None
        r.raise_for_status()
        st = r.json()
        # putTime is in 100ns units (Qiniu convention)
        return (int(st.get("fsize", 0)),
                int(st.get("putTime", 0)) // 10_000,
                st.get("hash", ""))

    def delete(self, key: str) -> bool:
        r = self._rs_post(f"/delete/{self._entry(key)}")
        return r.ok

    def copy(self, src_key: str, dst_key: str) -> bool:
        r = self._rs_post(
            f"/copy/{self._entry(src_key)}/{self._entry(dst_key)}"
            f"/force/true")
        return r.ok

    def list_prefix(self, prefix: str) -> List[str]:
        keys: List[str] = []
        marker = ""
        while True:
            q = {"bucket": self._bucket, "prefix": prefix,
                 "limit": "1000"}
            if marker:
                q["marker"] = marker
            path = "/list?" + urllib.parse.urlencode(sorted(q.items()))
            r = self._session.post(
                self._rsf + path,
                headers={"Authorization": self._qbox_token(path),
                         "Content-Type":
                             "application/x-www-form-urlencoded"},
                timeout=60)
            r.raise_for_status()
            body = r.json()
            keys.extend(it["key"] for it in body.get("items", []))
            marker = body.get("marker", "")
            if not marker:
                return keys
