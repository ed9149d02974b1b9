"""Read-only HTTP(S) UFS (a copy of ``alluxio_tpu/underfs/web.py``).

Re-design of ``underfs/web/src/main/java/alluxio/underfs/web/
WebUnderFileSystem.java``: files are served with GET/HEAD (Range-capable),
directories are HTML index pages whose ``<a href>`` entries become the
listing — same directory-page parsing approach as the reference's Jsoup
scraper, with a stdlib HTMLParser.
"""

from __future__ import annotations

import html.parser
import io
import urllib.parse
from typing import BinaryIO, Dict, List, Optional

import requests

from alluxio_tpu_torch.underfs.base import (
    CreateOptions, DeleteOptions, UfsStatus, UnderFileSystem,
)


class _HrefParser(html.parser.HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.hrefs: List[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for k, v in attrs:
                if k == "href" and v:
                    self.hrefs.append(v)


def _parse_http_date(value: Optional[str]) -> Optional[int]:
    """RFC 7231 date -> epoch ms; locale-independent (unlike strptime %a/%b)."""
    if not value:
        return None
    try:
        import email.utils

        dt = email.utils.parsedate_to_datetime(value)
        return int(dt.timestamp() * 1000) if dt else None
    except (TypeError, ValueError):
        return None


class WebUnderFileSystem(UnderFileSystem):
    """``http(s)://host/...`` read-only UFS."""

    schemes = ("http", "https")

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        super().__init__(root_uri, properties)
        self._session = requests.Session()
        self._timeout = float((properties or {}).get("web.timeout", "30"))

    def get_underfs_type(self) -> str:
        return "web"

    # -- read path -----------------------------------------------------------
    def open(self, path: str, offset: int = 0) -> BinaryIO:
        headers = {"Range": f"bytes={offset}-"} if offset else {}
        r = self._session.get(path, headers=headers, timeout=self._timeout)
        if r.status_code == 404:
            raise FileNotFoundError(path)
        r.raise_for_status()
        data = r.content
        if offset and r.status_code == 200:  # server ignored Range
            data = data[offset:]
        return io.BytesIO(data)

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        r = self._session.get(
            path, headers={"Range": f"bytes={offset}-{offset + length - 1}"},
            timeout=self._timeout)
        if r.status_code == 404:
            raise FileNotFoundError(path)
        if r.status_code == 416:
            return b""
        r.raise_for_status()
        if r.status_code == 200:  # server ignored Range: slice locally
            return r.content[offset:offset + length]
        return r.content

    # -- status --------------------------------------------------------------
    def _head(self, path: str) -> Optional[requests.Response]:
        r = self._session.head(path, timeout=self._timeout,
                               allow_redirects=True)
        if r.status_code == 404:
            return None
        if not r.ok:  # some servers reject HEAD; retry tiny GET
            r = self._session.get(path, headers={"Range": "bytes=0-0"},
                                  timeout=self._timeout)
            if r.status_code == 404:
                return None
            # transient server errors must NOT read as "exists, empty" —
            # a fabricated zero-length status would poison sync fingerprints
            r.raise_for_status()
        return r

    def _looks_dir(self, path: str, resp: requests.Response) -> bool:
        # a directory is a path the server redirects to a trailing slash
        # (index servers 301 /a -> /a/); an .html FILE stays at its own URL
        # and must not be misclassified by its text/html content type
        final = getattr(resp, "url", path) or path
        return path.endswith("/") or final.endswith("/")

    def get_status(self, path: str) -> Optional[UfsStatus]:
        r = self._head(path)
        if r is None:
            return None
        if self._looks_dir(path, r):
            return UfsStatus(name=path, is_directory=True)
        length = int(r.headers.get("Content-Length", 0) or 0)
        if r.headers.get("Content-Range"):  # ranged fallback GET
            total = r.headers["Content-Range"].rpartition("/")[2]
            if total.isdigit():
                length = int(total)
        return UfsStatus(
            name=path, is_directory=False, length=length,
            last_modified_ms=_parse_http_date(r.headers.get("Last-Modified")),
            content_hash=r.headers.get("ETag", "").strip('"'))

    def list_status(self, path: str) -> Optional[List[UfsStatus]]:
        url = path if path.endswith("/") else path + "/"
        r = self._session.get(url, timeout=self._timeout)
        if r.status_code == 404 or "text/html" not in \
                r.headers.get("Content-Type", ""):
            return None
        parser = _HrefParser()
        parser.feed(r.text)
        out: List[UfsStatus] = []
        seen = set()
        for href in parser.hrefs:
            if href.startswith(("?", "#", "..", "/")) or "://" in href:
                continue
            name = urllib.parse.unquote(href)
            is_dir = name.endswith("/")
            name = name.rstrip("/")
            if not name or "/" in name or name in seen:
                continue
            seen.add(name)
            if is_dir:
                out.append(UfsStatus(name=name, is_directory=True))
            else:
                child = self.get_status(url + href)
                out.append(UfsStatus(
                    name=name, is_directory=False,
                    length=child.length if child else 0,
                    last_modified_ms=(child.last_modified_ms
                                      if child else None),
                    content_hash=child.content_hash if child else ""))
        return out

    # -- writes are unsupported (read-only UFS) ------------------------------
    def create(self, path: str, options: Optional[CreateOptions] = None):
        raise OSError("WebUnderFileSystem is read-only")

    def delete_file(self, path: str) -> bool:
        raise OSError("WebUnderFileSystem is read-only")

    def delete_directory(self, path: str,
                         options: Optional[DeleteOptions] = None) -> bool:
        raise OSError("WebUnderFileSystem is read-only")

    def rename_file(self, src: str, dst: str) -> bool:
        raise OSError("WebUnderFileSystem is read-only")

    def rename_directory(self, src: str, dst: str) -> bool:
        raise OSError("WebUnderFileSystem is read-only")

    def mkdirs(self, path: str, create_parent: bool = True) -> bool:
        raise OSError("WebUnderFileSystem is read-only")
