"""S3-compatible REST proxy over the FileSystem client (a copy of
``alluxio_tpu/proxy/process.py``).

Re-design of ``core/server/proxy/src/main/java/alluxio/proxy/
{AlluxioProxy.java:37,s3/S3RestServiceHandler.java:75}``: a standalone
process exposing buckets/objects over the S3 REST dialect so any S3
client/SDK (awscli, boto3, s3fs, spark-s3a) can read and write the
namespace. Buckets are the children of ``atpu.proxy.s3.root``; object
keys map to paths below their bucket.

Supported (the surface the reference handler implements):
  GET    /                      ListBuckets
  PUT    /{bucket}              CreateBucket
  DELETE /{bucket}              DeleteBucket (must be empty)
  GET    /{bucket}?list-type=2  ListObjectsV2 (prefix, delimiter,
                                max-keys, continuation via start-after)
  HEAD   /{bucket}/{key}        HeadObject
  GET    /{bucket}/{key}        GetObject (Range: bytes=a-b)
  PUT    /{bucket}/{key}        PutObject (and CopyObject via
                                x-amz-copy-source)
  DELETE /{bucket}/{key}        DeleteObject
  POST   /{bucket}/{key}?uploads                 CreateMultipartUpload
  PUT    /{bucket}/{key}?partNumber=N&uploadId=  UploadPart
  POST   /{bucket}/{key}?uploadId=               CompleteMultipartUpload
  DELETE /{bucket}/{key}?uploadId=               AbortMultipartUpload
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlsplit
from xml.sax.saxutils import escape

from alluxio_tpu_torch.utils.exceptions import (
    DirectoryNotEmptyError, FileDoesNotExistError, InvalidArgumentError,
    InvalidPathError,
)

LOG = logging.getLogger(__name__)

_MULTIPART_DIR = "_atpu_multipart"


def _xml(body: str) -> bytes:
    return ('<?xml version="1.0" encoding="UTF-8"?>' + body).encode()


def _error(code: str, message: str, resource: str) -> bytes:
    return _xml(f"<Error><Code>{escape(code)}</Code>"
                f"<Message>{escape(message)}</Message>"
                f"<Resource>{escape(resource)}</Resource></Error>")


def _iso(ms: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ms / 1000))


class _S3State:
    """Shared across handler instances (one per request thread)."""

    def __init__(self, fs, root: str) -> None:
        self.fs = fs
        self.root = root.rstrip("/") or "/s3"
        #: uploadId -> (bucket, key); parts live in the namespace under
        #: root/_atpu_multipart/<uploadId>/ so aborted uploads are
        #: visible/sweepable, matching the reference's temp-dir scheme
        self.uploads: Dict[str, tuple] = {}
        self.lock = threading.Lock()


class ProxyProcess:
    """The proxy role (reference: ``AlluxioProxy.java:37``)."""

    def __init__(self, conf, fs=None) -> None:
        from alluxio_tpu_torch.conf import Keys

        self._conf = conf
        self._owns_fs = fs is None
        if fs is None:
            from alluxio_tpu_torch.client.file_system import FileSystem

            master = (f"{conf.get(Keys.MASTER_HOSTNAME)}:"
                      f"{conf.get_int(Keys.MASTER_RPC_PORT)}")
            fs = FileSystem(master, conf=conf)
        self._fs = fs
        self._state = _S3State(fs, conf.get(Keys.PROXY_S3_ROOT))
        self._port_conf = conf.get_int(Keys.PROXY_WEB_PORT)
        self._server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    def start(self) -> int:
        state = self._state
        if not state.fs.exists(state.root):
            state.fs.create_directory(state.root, recursive=True,
                                     allow_exists=True)

        class Handler(_S3Handler):
            s3 = state

        from alluxio_tpu_torch.conf import Keys

        bind = self._conf.get(Keys.PROXY_BIND_HOST)
        self._server = ThreadingHTTPServer((bind, self._port_conf),
                                           Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever,
                             name="s3-proxy", daemon=True)
        t.start()
        LOG.info("S3 proxy serving on port %d (root %s)", self.port,
                 state.root)
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._owns_fs:
            self._fs.close()


class _S3Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    s3: _S3State = None  # bound by ProxyProcess.start

    def log_message(self, fmt, *args):
        LOG.debug("s3: " + fmt, *args)

    # -- plumbing ------------------------------------------------------------
    def _send(self, code: int, body: bytes = b"",
              headers: Optional[Dict[str, str]] = None,
              ctype: str = "application/xml") -> None:
        drop = getattr(self, "_unread", 0) > 0
        if drop:
            # responding before the request body was consumed (error
            # path): the unread bytes would desync the next request on
            # a keep-alive connection — close it instead of buffering,
            # and ADVERTISE the close so the client doesn't reuse a
            # dead socket
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if drop:
            self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _fail(self, code: int, s3code: str, msg: str) -> None:
        self._send(code, _error(s3code, msg, self.path))

    def _parse(self):
        # request-body accounting for the keep-alive guard in _send
        self._unread = int(self.headers.get("Content-Length") or 0)
        parts = urlsplit(self.path)
        segs = [unquote(s) for s in parts.path.split("/") if s]
        q = {k: v[0] for k, v in parse_qs(parts.query,
                                          keep_blank_values=True).items()}
        bucket = segs[0] if segs else ""
        key = "/".join(segs[1:]) if len(segs) > 1 else ""
        return bucket, key, q

    def _bpath(self, bucket: str) -> str:
        return f"{self.s3.root}/{bucket}"

    def _kpath(self, bucket: str, key: str) -> str:
        return f"{self.s3.root}/{bucket}/{key}"

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(n) if n else b""
        self._unread = 0
        return data

    def _stream_request_body(self, write, md5=None) -> int:
        """Chunk-copy the request body into ``write`` without buffering
        it whole (parts/objects can be GBs)."""
        total = 0
        while self._unread > 0:
            chunk = self.rfile.read(min(self._CHUNK, self._unread))
            if not chunk:
                break
            self._unread -= len(chunk)
            if md5 is not None:
                md5.update(chunk)
            write(chunk)
            total += len(chunk)
        return total

    # -- verbs ---------------------------------------------------------------
    def do_GET(self):  # noqa: N802
        if self.path.startswith("/api/v1/"):
            return self._rest("GET")
        bucket, key, q = self._parse()
        try:
            if not bucket:
                return self._list_buckets()
            if not key:
                return self._list_objects(bucket, q)
            return self._get_object(bucket, key)
        except FileDoesNotExistError as e:
            self._fail(404, "NoSuchKey", str(e))
        except Exception as e:  # noqa: BLE001
            LOG.warning("s3 GET failed", exc_info=True)
            self._fail(500, "InternalError", str(e))

    def do_HEAD(self):  # noqa: N802
        if self.path.startswith("/api/v1/"):
            # /api/v1/ is reserved for the REST dialect on EVERY verb —
            # a half-hijacked namespace (GET rest, PUT s3) would let an
            # S3 client write objects it can never read back
            return self._rest("HEAD")
        bucket, key, _ = self._parse()
        try:
            info = self.s3.fs.get_status(self._kpath(bucket, key))
            # HEAD: advertise the object's real length; no body is
            # ever written for HEAD so this is protocol-legal
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/octet-stream")
            self.send_header("Content-Length", str(info.length))
            self.send_header("Last-Modified",
                             _iso(info.last_modification_time_ms))
            self.send_header("ETag", f'"{info.file_id:x}"')
            self.end_headers()
        except FileDoesNotExistError:
            self._send(404, b"")
        except Exception:  # noqa: BLE001
            self._send(500, b"")

    def do_PUT(self):  # noqa: N802
        if self.path.startswith("/api/v1/"):
            return self._rest("PUT")
        bucket, key, q = self._parse()
        try:
            if not key:
                self.s3.fs.create_directory(self._bpath(bucket),
                                            recursive=True,
                                            allow_exists=True)
                return self._send(200, b"", {"Location": f"/{bucket}"})
            if "partNumber" in q and "uploadId" in q:
                return self._upload_part(q["uploadId"],
                                         int(q["partNumber"]))
            if not self.s3.fs.exists(self._bpath(bucket)):
                # create_file would recursively materialize the missing
                # bucket as a plain directory — a typo'd bucket must 404
                return self._fail(404, "NoSuchBucket", bucket)
            src = self.headers.get("x-amz-copy-source")
            if src:
                return self._copy_object(bucket, key, unquote(src))
            md5 = hashlib.md5()
            out = self.s3.fs.create_file(self._kpath(bucket, key),
                                         overwrite=True)
            with out:
                self._stream_request_body(out.write, md5)
            self._send(200, b"", {"ETag": f'"{md5.hexdigest()}"'})
        except FileDoesNotExistError as e:
            self._fail(404, "NoSuchBucket", str(e))
        except Exception as e:  # noqa: BLE001
            LOG.warning("s3 PUT failed", exc_info=True)
            self._fail(500, "InternalError", str(e))

    def do_DELETE(self):  # noqa: N802
        if self.path.startswith("/api/v1/"):
            return self._rest("DELETE")
        bucket, key, q = self._parse()
        try:
            if key and "uploadId" in q:
                return self._abort_multipart(q["uploadId"])
            if not key:
                self.s3.fs.delete(self._bpath(bucket))
                return self._send(204)
            self.s3.fs.delete(self._kpath(bucket, key))
            self._send(204)
        except FileDoesNotExistError as e:
            self._fail(404, "NoSuchKey", str(e))
        except DirectoryNotEmptyError as e:
            self._fail(409, "BucketNotEmpty", str(e))
        except Exception as e:  # noqa: BLE001
            self._fail(500, "InternalError", str(e))

    def do_POST(self):  # noqa: N802
        if self.path.startswith("/api/v1/"):
            return self._rest("POST")
        bucket, key, q = self._parse()
        try:
            if "uploads" in q:
                return self._initiate_multipart(bucket, key)
            if "uploadId" in q:
                return self._complete_multipart(bucket, key,
                                                q["uploadId"])
            self._fail(400, "InvalidRequest", "unsupported POST")
        except Exception as e:  # noqa: BLE001
            LOG.warning("s3 POST failed", exc_info=True)
            self._fail(500, "InternalError", str(e))

    # -- native REST paths/streams API ---------------------------------------
    # (reference: ``proxy/{PathsRestServiceHandler,
    # StreamsRestServiceHandler}.java`` — the non-S3 half of the proxy.
    # Streams here are stateless download/upload verbs rather than the
    # reference's stream-id sessions: same coverage, no session table.)
    def _rest(self, verb: str) -> None:
        import json as _json

        # body accounting (the S3 verbs set this in _parse)
        self._unread = int(self.headers.get("Content-Length") or 0)
        parts = urlsplit(self.path)
        q = {k: v[0] for k, v in parse_qs(parts.query,
                                          keep_blank_values=True).items()}
        rest = parts.path[len("/api/v1/"):]
        kind, _, tail = rest.partition("/")
        if kind != "paths" or "/" not in tail:
            return self._rest_err(404, f"no route {parts.path}")
        raw_path, _, op = tail.rpartition("/")
        path = "/" + unquote(raw_path).strip("/")
        fs = self.s3.fs

        def send_json(obj, code=200):
            self._send(code, _json.dumps(obj, default=str).encode(),
                       ctype="application/json")

        streaming = False

        def fail(code: int, msg: str) -> None:
            if streaming:
                # headers already flushed: a second response would be
                # counted as body bytes — abort the connection instead
                self.close_connection = True
            else:
                self._rest_err(code, msg)

        try:
            if verb == "GET" and op == "get-status":
                return send_json(self._rest_info(fs.get_status(path)))
            if verb == "GET" and op == "list-status":
                return send_json([self._rest_info(i)
                                  for i in fs.list_status(path)])
            if verb == "GET" and op == "download":
                info = fs.get_status(path)
                f = fs.open_file(path, info=info)
                try:
                    # from here a failure happens mid-response: the
                    # except handlers must abort, not answer twice
                    streaming = True
                    return self._stream_body(f, 0, info.length, 200, {})
                finally:
                    f.close()
            if verb == "POST" and op == "exists":
                return send_json(fs.exists(path))
            if verb == "POST" and op == "create-directory":
                fs.create_directory(
                    path, recursive=q.get("recursive") == "true",
                    allow_exists=q.get("allowExists") == "true")
                return send_json({})
            if verb == "POST" and op == "delete":
                fs.delete(path, recursive=q.get("recursive") == "true")
                return send_json({})
            if verb == "POST" and op == "rename":
                dst = q.get("dst")
                if not dst:
                    return self._rest_err(
                        400, "rename requires ?dst=<path>")
                fs.rename(path, dst)
                return send_json({})
            if verb == "POST" and op == "upload":
                out = fs.create_file(path, overwrite=True)
                with out:
                    n = self._stream_request_body(out.write)
                return send_json({"bytes": n})
            return self._rest_err(
                404 if verb in ("GET", "POST") else 405,
                f"no op {op!r} for {verb}")
        except FileDoesNotExistError as e:
            fail(404, str(e))
        except DirectoryNotEmptyError as e:
            fail(409, str(e))
        except (InvalidArgumentError, InvalidPathError) as e:
            # client mistakes must be 4xx: retry middleware treats 5xx
            # as server faults and retries the unretryable
            fail(400, str(e))
        except Exception as e:  # noqa: BLE001
            LOG.warning("rest %s %s failed", verb, op, exc_info=True)
            fail(500, f"{type(e).__name__}: {e}")

    @staticmethod
    def _rest_info(i) -> dict:
        return {"path": i.path, "name": i.name, "folder": i.folder,
                "length": i.length,
                "lastModificationTimeMs": i.last_modification_time_ms}

    def _rest_err(self, code: int, msg: str) -> None:
        import json as _json

        self._send(code, _json.dumps({"error": msg}).encode(),
                   ctype="application/json")

    # -- bucket ops ----------------------------------------------------------
    def _list_buckets(self) -> None:
        entries = [i for i in self.s3.fs.list_status(self.s3.root)
                   if i.folder and i.name != _MULTIPART_DIR]
        items = "".join(
            f"<Bucket><Name>{escape(i.name)}</Name>"
            f"<CreationDate>{_iso(i.creation_time_ms)}</CreationDate>"
            f"</Bucket>" for i in sorted(entries, key=lambda x: x.name))
        self._send(200, _xml(
            "<ListAllMyBucketsResult>"
            f"<Buckets>{items}</Buckets></ListAllMyBucketsResult>"))

    def _list_objects(self, bucket: str, q: Dict[str, str]) -> None:
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        start_after = q.get("start-after",
                            q.get("continuation-token", ""))
        base = self._bpath(bucket)
        if not self.s3.fs.exists(base):
            return self._fail(404, "NoSuchBucket", bucket)
        # push the prefix's directory component down into the listing so
        # a prefixed request doesn't enumerate the whole bucket
        list_root, infos = base, None
        if "/" in prefix:
            dir_part = prefix.rsplit("/", 1)[0]
            candidate = f"{base}/{dir_part}"
            if self.s3.fs.exists(candidate):
                list_root = candidate
            else:  # prefix directory absent: nothing can match
                infos = []
        if infos is None:
            infos = self.s3.fs.list_status(list_root, recursive=True)
        keys = []
        for i in infos:
            if i.folder:
                continue
            k = i.path[len(base) + 1:]
            if k.startswith(f"{_MULTIPART_DIR}/"):
                continue
            if prefix and not k.startswith(prefix):
                continue
            keys.append((k, i))
        keys.sort(key=lambda t: t[0])
        contents, common = [], []
        seen_prefixes = set()
        more_after = False
        last_emitted = ""
        for k, i in keys:
            if start_after and k <= start_after:
                continue
            if delimiter:
                rest = k[len(prefix):]
                d = rest.find(delimiter)
                if d >= 0:
                    p = prefix + rest[:d + len(delimiter)]
                    # a prefix <= the token was fully emitted on an
                    # earlier page (the token IS that prefix string)
                    if start_after and p <= start_after:
                        continue
                    if p in seen_prefixes:
                        continue
                    # prefixes count against MaxKeys like real S3
                    if len(contents) + len(common) >= max_keys:
                        more_after = True
                        break
                    seen_prefixes.add(p)
                    common.append(p)
                    last_emitted = p
                    continue
            if len(contents) + len(common) >= max_keys:
                more_after = True  # something actually remains
                break
            contents.append((k, i))
            last_emitted = k
        truncated = "true" if more_after else "false"
        body = (f"<ListBucketResult><Name>{escape(bucket)}</Name>"
                f"<Prefix>{escape(prefix)}</Prefix>"
                f"<KeyCount>{len(contents) + len(common)}</KeyCount>"
                f"<MaxKeys>{max_keys}</MaxKeys>"
                f"<IsTruncated>{truncated}</IsTruncated>")
        if more_after and last_emitted:
            body += (f"<NextContinuationToken>"
                     f"{escape(last_emitted)}"
                     f"</NextContinuationToken>")
        for k, i in contents:
            body += (f"<Contents><Key>{escape(k)}</Key>"
                     f"<Size>{i.length}</Size>"
                     f"<LastModified>{_iso(i.last_modification_time_ms)}"
                     f"</LastModified>"
                     f"<ETag>\"{i.file_id:x}\"</ETag></Contents>")
        for p in common:
            body += (f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
                     f"</CommonPrefixes>")
        body += "</ListBucketResult>"
        self._send(200, _xml(body))

    # -- object ops ----------------------------------------------------------
    def _get_object(self, bucket: str, key: str) -> None:
        path = self._kpath(bucket, key)
        info = self.s3.fs.get_status(path)
        rng = self.headers.get("Range")
        with self.s3.fs.open_file(path, info=info) as f:
            if rng and rng.startswith("bytes="):
                spec = rng[len("bytes="):]
                a, _, b = spec.partition("-")
                if a:
                    start = int(a)
                    end = int(b) + 1 if b else info.length
                else:  # suffix range: last N bytes
                    start = max(0, info.length - int(b))
                    end = info.length
                end = min(end, info.length)
                if start >= info.length:
                    return self._send(
                        416, _error("InvalidRange",
                                    f"start {start} >= length "
                                    f"{info.length}", self.path),
                        {"Content-Range": f"bytes */{info.length}"})
                return self._stream_body(
                    f, start, end - start, 206, {
                        "Content-Range":
                            f"bytes {start}-{end - 1}/{info.length}",
                        "ETag": f'"{info.file_id:x}"'})
            self._stream_body(f, 0, info.length, 200, {
                "Last-Modified": _iso(info.last_modification_time_ms),
                "ETag": f'"{info.file_id:x}"'})

    _CHUNK = 4 << 20

    def _stream_body(self, f, start: int, n: int, code: int,
                     headers: Dict[str, str]) -> None:
        """Chunked pread -> socket: a multi-GB object must not be
        buffered whole in the proxy's memory."""
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(max(0, n)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        pos, remaining = start, max(0, n)
        while remaining > 0:
            chunk = f.pread(pos, min(self._CHUNK, remaining))
            if not chunk:
                break
            self.wfile.write(chunk)
            pos += len(chunk)
            remaining -= len(chunk)

    def _copy_stream(self, fin, write) -> "hashlib._Hash":
        """Chunked pread -> write with an md5 running alongside (objects
        and parts can be GBs; never buffer them whole)."""
        md5 = hashlib.md5()
        pos = 0
        while True:
            chunk = fin.pread(pos, self._CHUNK)
            if not chunk:
                break
            md5.update(chunk)
            write(chunk)
            pos += len(chunk)
        return md5

    def _copy_object(self, bucket: str, key: str, src: str) -> None:
        segs = [s for s in src.split("/") if s]
        src_path = self._kpath(segs[0], "/".join(segs[1:]))
        with self.s3.fs.open_file(src_path) as fin:
            out = self.s3.fs.create_file(self._kpath(bucket, key),
                                         overwrite=True)
            with out:
                md5 = self._copy_stream(fin, out.write)
        etag = md5.hexdigest()
        self._send(200, _xml(
            f"<CopyObjectResult><ETag>\"{etag}\"</ETag>"
            f"<LastModified>{_iso(int(time.time() * 1000))}"
            f"</LastModified></CopyObjectResult>"))

    # -- multipart -----------------------------------------------------------
    def _initiate_multipart(self, bucket: str, key: str) -> None:
        if not self.s3.fs.exists(self._bpath(bucket)):
            return self._fail(404, "NoSuchBucket", bucket)
        upload_id = uuid.uuid4().hex
        with self.s3.lock:
            self.s3.uploads[upload_id] = (bucket, key)
        self.s3.fs.create_directory(
            f"{self.s3.root}/{_MULTIPART_DIR}/{upload_id}",
            recursive=True, allow_exists=True)
        self._send(200, _xml(
            f"<InitiateMultipartUploadResult>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            f"</InitiateMultipartUploadResult>"))

    def _upload_part(self, upload_id: str, part: int) -> None:
        with self.s3.lock:
            if upload_id not in self.s3.uploads:
                return self._fail(404, "NoSuchUpload", upload_id)
        md5 = hashlib.md5()
        out = self.s3.fs.create_file(
            f"{self.s3.root}/{_MULTIPART_DIR}/{upload_id}/{part:05d}",
            overwrite=True)
        with out:
            self._stream_request_body(out.write, md5)
        self._send(200, b"", {"ETag": f'"{md5.hexdigest()}"'})

    def _complete_multipart(self, bucket: str, key: str,
                            upload_id: str) -> None:
        with self.s3.lock:
            if upload_id not in self.s3.uploads:
                return self._fail(404, "NoSuchUpload", upload_id)
        if not self.s3.fs.exists(self._bpath(bucket)):
            # bucket deleted mid-upload: must not be re-materialized
            return self._fail(404, "NoSuchBucket", bucket)
        d = f"{self.s3.root}/{_MULTIPART_DIR}/{upload_id}"
        # the client's manifest (CompleteMultipartUpload XML) is the
        # source of truth: assemble exactly the declared parts, in the
        # declared order — never whatever happens to be in the dir
        manifest = self._parse_part_manifest(self._body())
        if manifest is None:  # no/empty body: all uploaded parts in order
            manifest = sorted(int(i.name) for i in
                              self.s3.fs.list_status(d) if not i.folder)
        etags = []
        out = self.s3.fs.create_file(self._kpath(bucket, key),
                                     overwrite=True)
        with out:
            for part in manifest:
                p = f"{d}/{part:05d}"
                if not self.s3.fs.exists(p):
                    out.cancel()
                    return self._fail(400, "InvalidPart",
                                      f"part {part} was not uploaded")
                with self.s3.fs.open_file(p) as fin:
                    etags.append(self._copy_stream(fin, out.write).digest())
        self.s3.fs.delete(d, recursive=True)
        with self.s3.lock:
            self.s3.uploads.pop(upload_id, None)
        agg = hashlib.md5(b"".join(etags)).hexdigest()
        self._send(200, _xml(
            f"<CompleteMultipartUploadResult>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<ETag>\"{agg}-{len(etags)}\"</ETag>"
            f"</CompleteMultipartUploadResult>"))

    @staticmethod
    def _parse_part_manifest(body: bytes):
        """Part numbers from the CompleteMultipartUpload request body,
        in document order; None when absent/unparseable."""
        if not body:
            return None
        try:
            import xml.etree.ElementTree as ET

            root = ET.fromstring(body)
            parts = [int(e.text) for e in root.iter()
                     if e.tag.endswith("PartNumber")]
            return parts or None
        except Exception:  # noqa: BLE001 malformed body: fall back
            return None

    def _abort_multipart(self, upload_id: str) -> None:
        with self.s3.lock:
            self.s3.uploads.pop(upload_id, None)
        d = f"{self.s3.root}/{_MULTIPART_DIR}/{upload_id}"
        try:
            self.s3.fs.delete(d, recursive=True)
        except FileDoesNotExistError:
            pass
        self._send(204)
