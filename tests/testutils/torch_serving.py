"""Shared helpers for the serving-surface parity tests (the proxy, FUSE,
the log server, the metastores): one HTTP call that records instead of
raising, the masks that make two packages' answers comparable, a
recording relay in front of the fake Hive metastore, and a role child
launched through a package's shell.
"""

from __future__ import annotations

import os
import re
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

#: the response headers both packages' proxies must send alike
HEADERS = ("Content-Type", "Content-Length", "Content-Range", "ETag",
           "Location", "Connection")

_ISO = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.000Z")
_UPLOAD_ID = re.compile(r"[0-9a-f]{32}(?=<|/|$|&)")
#: a file id rendered as an ETag (an MD5 ETag has 32 hex digits)
_FILE_ETAG = re.compile(r'"[0-9a-f]{1,31}"')
_MTIME = re.compile(r'"lastModificationTimeMs": \d+')


def mask(body: bytes) -> bytes:
    """Times, upload ids and file-id ETags masked: each package's
    cluster draws its own."""
    text = body.decode("utf-8", "replace")
    text = _ISO.sub("<T>", text)
    text = _UPLOAD_ID.sub("<ID>", text)
    text = _FILE_ETAG.sub('"<FID>"', text)
    text = _MTIME.sub('"lastModificationTimeMs": <T>', text)
    return text.encode()


def http(port: int, method: str, path: str, data: Optional[bytes] = None,
         headers: Optional[Dict[str, str]] = None
         ) -> Tuple[int, bytes, Dict[str, str]]:
    """One request to ``127.0.0.1:port``: (status, body, headers), an
    HTTP error answered as a status like any other."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def comparable(answer: Tuple[int, bytes, Dict[str, str]]) -> Tuple:
    code, body, headers = answer
    kept = tuple((k, mask(headers[k].encode()).decode())
                 for k in HEADERS if k in headers)
    return code, mask(body), kept


class Recorder:
    """Calls ``http`` against one proxy and keeps every answer in a
    comparable form."""

    def __init__(self, port: int) -> None:
        self.port = port
        self.rows: List[Tuple] = []

    def __call__(self, method: str, path: str, data=None, headers=None):
        answer = http(self.port, method, path, data, headers)
        self.rows.append((method, mask(path.encode()), comparable(answer)))
        return answer


# -- Hive metastore --------------------------------------------------------------
class HmsRelay:
    """A TCP relay in front of the fake metastore that records every byte
    a client sends. ``framed``: the client speaks TFramedTransport; the
    relay strips each frame for the fake (which reads the buffered
    transport) and frames each reply."""

    def __init__(self, target_port: int, framed: bool = False) -> None:
        self._target = ("127.0.0.1", target_port)
        self._framed = framed
        self.sent = bytearray()
        self._lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self.uri = f"thrift://127.0.0.1:{self.port}"
        threading.Thread(target=self._accept, daemon=True,
                         name="hms-relay").start()

    def _accept(self) -> None:
        while True:
            try:
                client, _ = self._sock.accept()
            except OSError:  # closed
                return
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True, name="hms-relay-conn").start()

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise EOFError
            buf += chunk
        return buf

    @staticmethod
    def _one_message(s: socket.socket, buf: bytes = b"") -> bytes:
        """Read from ``s`` until ``buf`` holds one whole buffered-
        transport message (a head and a struct)."""
        from alluxio_tpu.table.thrift_proto import Reader, ThriftError

        while True:
            try:
                r = Reader(buf)
                r.message()
                r.struct()
                return buf
            except ThriftError:
                chunk = s.recv(1 << 16)
                if not chunk:
                    raise EOFError from None
                buf += chunk

    def _serve(self, client: socket.socket) -> None:
        upstream = socket.create_connection(self._target, timeout=15)
        try:
            while True:
                if self._framed:
                    head = self._recv_exact(client, 4)
                    payload = self._recv_exact(
                        client, struct.unpack(">i", head)[0])
                    sent = head + payload
                else:
                    payload = sent = self._one_message(
                        client, self._recv_exact(client, 1))
                with self._lock:
                    self.sent += sent
                upstream.sendall(payload)
                reply = self._one_message(upstream)
                if self._framed:
                    reply = struct.pack(">i", len(reply)) + reply
                client.sendall(reply)
        except (EOFError, OSError):
            return
        finally:
            upstream.close()
            client.close()

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes the accept
        except OSError:
            pass
        self._sock.close()


# -- role children -----------------------------------------------------------------
def role_env(extra: Dict[str, str]) -> Dict[str, str]:
    return {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu",
            **extra}


def launch(pkg: str, argv: List[str], env: Dict[str, str],
           cwd: str, timeout_s: float = 60.0
           ) -> Tuple[subprocess.Popen, str]:
    """``python -m <pkg>.shell.main <argv>`` as an operator starts a
    role: returns the child and the banner it printed."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.shell.main", *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=cwd)
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    if not ready:
        stop(proc)
        raise TimeoutError(f"{pkg} {argv[0]}: no banner in {timeout_s} s")
    return proc, proc.stdout.readline().strip()


def stop(proc: subprocess.Popen, timeout_s: float = 30.0) -> int:
    """SIGTERM, as an operator stops a role; the exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        return -9
    finally:
        if proc.stdout is not None:
            proc.stdout.close()
