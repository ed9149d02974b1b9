"""Object-store UFS base: flat key space presented as a filesystem (a copy
of ``alluxio_tpu/underfs/object_base.py``).

Re-design of ``core/common/src/main/java/alluxio/underfs/ObjectUnderFileSystem.java``:
directories are emulated with zero-byte breadcrumb markers (``dir/`` keys),
listing uses delimiter-style prefix scans, renames are copy+delete, and
multipart-style uploads stream through a buffer. Concrete stores implement
the small ``ObjectStoreClient`` protocol; ``MemObjectStore`` is the in-memory
test double (reference analogue: the mock object UFS used across tests),
and S3/GCS adapters layer HTTP clients over the same protocol.
"""

from __future__ import annotations

import io
import threading
import time
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

from alluxio_tpu_torch.underfs.base import (
    CreateOptions, DeleteOptions, UfsStatus, UnderFileSystem,
)

SEP = "/"
FOLDER_SUFFIX = "/"  # breadcrumb marker key suffix


class ObjectStoreClient:
    #: True when the client implements the multipart quartet
    #: (initiate_multipart / upload_part / complete_multipart /
    #: abort_multipart) + ``multipart_size`` — ``create()`` then
    #: streams large writes via :class:`MultipartWriter`. An explicit
    #: capability flag, not hasattr duck-guessing: a stray attribute
    #: must not route writes to a half-implemented surface.
    supports_multipart = False
    """Minimal blob-store protocol concrete stores implement."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        raise NotImplementedError

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        """(length, last_modified_ms, etag) or None."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def copy(self, src_key: str, dst_key: str) -> bool:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        """All keys with the prefix (recursive)."""
        raise NotImplementedError


class MemObjectStore(ObjectStoreClient):
    """In-memory blob store; process-wide buckets so master and workers in
    one test process see the same data."""

    _BUCKETS: Dict[str, "MemObjectStore"] = {}
    _GLOBAL_LOCK = threading.Lock()

    @classmethod
    def bucket(cls, name: str) -> "MemObjectStore":
        with cls._GLOBAL_LOCK:
            if name not in cls._BUCKETS:
                cls._BUCKETS[name] = MemObjectStore()
            return cls._BUCKETS[name]

    @classmethod
    def reset_all(cls) -> None:
        with cls._GLOBAL_LOCK:
            cls._BUCKETS.clear()

    def __init__(self) -> None:
        self._objs: Dict[str, Tuple[bytes, int]] = {}
        self._lock = threading.RLock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objs[key] = (bytes(data), int(time.time() * 1000))

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> Optional[bytes]:
        with self._lock:
            entry = self._objs.get(key)
        if entry is None:
            return None
        data = entry[0]
        end = len(data) if length is None else min(len(data), offset + length)
        return data[offset:end]

    def head(self, key: str) -> Optional[Tuple[int, int, str]]:
        with self._lock:
            entry = self._objs.get(key)
        if entry is None:
            return None
        data, mtime = entry
        return (len(data), mtime, f"etag-{hash(data) & 0xFFFFFFFF:x}")

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._objs.pop(key, None) is not None

    def copy(self, src_key: str, dst_key: str) -> bool:
        with self._lock:
            entry = self._objs.get(src_key)
            if entry is None:
                return False
            self._objs[dst_key] = (entry[0], int(time.time() * 1000))
            return True

    def list_prefix(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._objs if k.startswith(prefix))


class _ObjectWriter(io.BytesIO):
    def __init__(self, client: ObjectStoreClient, key: str) -> None:
        super().__init__()
        self._client = client
        self._key = key
        self.closed_ok = False

    def close(self) -> None:
        if not self.closed_ok:
            self._client.put(self._key, self.getvalue())
            self.closed_ok = True
        super().close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        return False


class MultipartWriter(io.RawIOBase):
    """Streaming writer over any client exposing the multipart quartet
    (``initiate_multipart``/``upload_part``/``complete_multipart``/
    ``abort_multipart`` + ``multipart_size``): buffers one part then
    ships; small files fall back to a single PUT (reference:
    S3ALowLevelOutputStream's short-circuit). Shared by the s3 client
    and the native OSS/COS dialects — their multipart wire protocols
    are S3-shaped."""

    def __init__(self, client, key: str) -> None:
        super().__init__()
        self._client = client
        self._key = key
        self._buf = bytearray()
        self._upload_id = None
        self._etags: List[tuple] = []
        self._part = 0
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf.extend(b)
        while len(self._buf) >= self._client.multipart_size:
            self._ship(self._client.multipart_size)
        return len(b)

    def _ship(self, n: int) -> None:
        if self._upload_id is None:
            self._upload_id = self._client.initiate_multipart(self._key)
        self._part += 1
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        self._etags.append(
            (self._part,
             self._client.upload_part(self._key, self._upload_id,
                                      self._part, chunk)))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._upload_id is None:
                self._client.put(self._key, bytes(self._buf))
            else:
                if self._buf:
                    self._ship(len(self._buf))
                self._client.complete_multipart(self._key,
                                                self._upload_id,
                                                self._etags)
        except Exception:
            if self._upload_id is not None:
                self._client.abort_multipart(self._key, self._upload_id)
            raise
        finally:
            super().close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            if self._upload_id is not None:
                self._client.abort_multipart(self._key, self._upload_id)
            self._closed = True
        return False


class ObjectUnderFileSystem(UnderFileSystem):
    """Filesystem semantics over an ObjectStoreClient."""

    def __init__(self, root_uri: str, client: ObjectStoreClient,
                 properties: Optional[Dict[str, str]] = None) -> None:
        super().__init__(root_uri, properties)
        self._client = client
        scheme_sep = root_uri.find("://")
        rest = root_uri[scheme_sep + 3:] if scheme_sep >= 0 else root_uri
        bucket, _, prefix = rest.partition(SEP)
        self._bucket = bucket
        self._scheme = root_uri[:scheme_sep] if scheme_sep >= 0 else "mem"

    def _key(self, path: str) -> str:
        """Full UFS uri -> object key (strip scheme+bucket)."""
        p = path
        if "://" in p:
            p = p.split("://", 1)[1]
            p = p.partition(SEP)[2]
        return p.strip(SEP)

    def get_underfs_type(self) -> str:
        return self._scheme

    # -- IO -----------------------------------------------------------------
    def create(self, path: str, options: Optional[CreateOptions] = None) -> BinaryIO:
        if getattr(self._client, "supports_multipart", False):
            # large writes stream in parts instead of buffering whole
            return MultipartWriter(self._client, self._key(path))
        return _ObjectWriter(self._client, self._key(path))

    def open(self, path: str, offset: int = 0) -> BinaryIO:
        data = self._client.get(self._key(path), offset)
        if data is None:
            raise FileNotFoundError(path)
        return io.BytesIO(data)

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self._client.get(self._key(path), offset, length)
        if data is None:
            raise FileNotFoundError(path)
        return data

    # -- namespace ----------------------------------------------------------
    def delete_file(self, path: str) -> bool:
        return self._client.delete(self._key(path))

    def delete_directory(self, path: str,
                         options: Optional[DeleteOptions] = None) -> bool:
        opts = options or DeleteOptions()
        key = self._key(path)
        marker = key + FOLDER_SUFFIX if key else ""
        children = [k for k in self._client.list_prefix(marker)
                    if k != marker] if key else self._client.list_prefix("")
        if children and not opts.recursive:
            return False
        for k in children:
            self._client.delete(k)
        if key:
            return self._client.delete(marker) or not children
        return True

    def rename_file(self, src: str, dst: str) -> bool:
        s, d = self._key(src), self._key(dst)
        if not self._client.copy(s, d):
            return False
        self._client.delete(s)
        return True

    def rename_directory(self, src: str, dst: str) -> bool:
        s, d = self._key(src), self._key(dst)
        keys = self._client.list_prefix(s + FOLDER_SUFFIX)
        marker = s + FOLDER_SUFFIX
        ok = True
        for k in keys:
            nk = d + FOLDER_SUFFIX + k[len(marker):] if k != marker else d + FOLDER_SUFFIX
            ok = self._client.copy(k, nk) and ok
            self._client.delete(k)
        if self._client.head(marker) is not None:
            self._client.copy(marker, d + FOLDER_SUFFIX)
            self._client.delete(marker)
        else:
            self._client.put(d + FOLDER_SUFFIX, b"")
        return ok

    def mkdirs(self, path: str, create_parent: bool = True) -> bool:
        key = self._key(path)
        if not key:
            return False
        if self._client.head(key + FOLDER_SUFFIX) is not None:
            return False
        parts = key.split(SEP)
        if create_parent:
            for i in range(1, len(parts)):
                self._client.put(SEP.join(parts[:i]) + FOLDER_SUFFIX, b"")
        self._client.put(key + FOLDER_SUFFIX, b"")
        return True

    # -- status -------------------------------------------------------------
    def get_status(self, path: str) -> Optional[UfsStatus]:
        key = self._key(path)
        if not key:
            return UfsStatus(name=path, is_directory=True)
        head = self._client.head(key)
        if head is not None:
            length, mtime, etag = head
            return UfsStatus(name=path, is_directory=False, length=length,
                             last_modified_ms=mtime, content_hash=etag)
        # directory: breadcrumb or implicit (any key under prefix)
        if self._client.head(key + FOLDER_SUFFIX) is not None or \
                self._client.list_prefix(key + SEP):
            return UfsStatus(name=path, is_directory=True)
        return None

    def list_status(self, path: str) -> Optional[List[UfsStatus]]:
        key = self._key(path)
        prefix = key + SEP if key else ""
        status = self.get_status(path)
        if status is None or not status.is_directory:
            return None
        names: Dict[str, UfsStatus] = {}
        for k in self._client.list_prefix(prefix):
            rest = k[len(prefix):]
            if not rest:
                continue  # the breadcrumb itself
            first, sep, _ = rest.partition(SEP)
            if sep:  # nested -> show the directory
                if first not in names:
                    names[first] = UfsStatus(name=first, is_directory=True)
            elif rest.endswith(FOLDER_SUFFIX):
                d = rest.rstrip(SEP)
                if d and d not in names:
                    names[d] = UfsStatus(name=d, is_directory=True)
            else:
                head = self._client.head(k)
                if head:
                    length, mtime, etag = head
                    names[rest] = UfsStatus(name=rest, length=length,
                                            last_modified_ms=mtime,
                                            content_hash=etag)
        return [names[n] for n in sorted(names)]


class MemUnderFileSystem(ObjectUnderFileSystem):
    """``mem://bucket/...`` — in-process object store for tests and the
    SleepingUFS-style fault injection wrapper."""

    schemes = ("mem",)

    def __init__(self, root_uri: str,
                 properties: Optional[Dict[str, str]] = None) -> None:
        rest = root_uri.split("://", 1)[1] if "://" in root_uri else root_uri
        bucket = rest.partition(SEP)[0]
        super().__init__(root_uri, MemObjectStore.bucket(bucket), properties)
