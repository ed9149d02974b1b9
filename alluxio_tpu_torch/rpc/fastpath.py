"""Same-host metadata fast path: framed msgpack over a Unix socket (a
copy of ``alluxio_tpu/rpc/fastpath.py``).

The reference's transport ladder ends at gRPC-over-domain-sockets for
same-host traffic (``GrpcDataServer.java:72-95``); the HTTP/2 framing it
keeps costs more CPU per call than a small metadata RPC's payload is
worth (~1.5 ms/call round measured in Python on the master bench). This
module takes the ladder one rung further for the METADATA plane: the
same ``ServiceDefinition`` registry the gRPC server hosts, exposed over
a Unix stream socket with ``[u32 len][msgpack body]`` frames — no
codegen, no HTTP/2, no per-call executor hop. Data-plane streams stay on
gRPC (flow control matters there; see ``rpc/core.py``).

Protocol (all frames are ``[u32 little-endian length][msgpack]``):
  hello   client->server  {"metadata": {k: v}}    authenticated once per
                          connection (the gRPC path fixes metadata per
                          channel, so per-connection auth is equivalent)
          server->client  {"ok": true} | {"err": wire}
  call    client->server  [service, method, request(, traceparent)]
          server->client  {"ok": result} | {"err": wire}

The optional fourth element of a call frame is the caller's trace
context; the server binds it before it opens the method's span, so the
span joins the caller's trace, as the JAX server does. A server given the
master's admission controller gates every call through the caller's token
bucket (the hello frame's ``atpu-user`` names the caller when no
authenticator runs), and the conf-gated RPC-reject hook sheds a call
here as it does on gRPC.

Discovery is by convention: a master serving RPC port P binds
``<dir>/atpu-master-P.sock`` (dir from ``atpu.master.fastpath.dir``,
default ``/tmp``). A client whose master address resolves to this host
probes that path and silently falls back to gRPC when absent — the same
"short-circuit if local, stream if not" decision the block-read ladder
makes (reference: ``BlockInStream.java:80-124``).
"""

from __future__ import annotations

import logging
import os
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import msgpack

from alluxio_tpu_torch.utils.exceptions import AlluxioTpuError, UnavailableError

LOG = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
_MAX_FRAME = 256 << 20


def socket_path_for(address: str, directory: str = "/tmp") -> str:
    """Conventional socket path for a master RPC ``host:port`` address."""
    _, _, port = address.rpartition(":")
    return os.path.join(directory, f"atpu-master-{port}.sock")


def is_local_host(host: str) -> bool:
    if host in ("localhost", "127.0.0.1", "::1", "0.0.0.0", ""):
        return True
    try:
        return host in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def _read_frame(rfile) -> Optional[bytes]:
    hdr = rfile.read(_LEN.size)
    if len(hdr) < _LEN.size:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > _MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds cap {_MAX_FRAME}")
    body = rfile.read(n)
    if len(body) < n:
        return None
    return body


def _send_frame(sock: socket.socket, obj: Any) -> None:
    body = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(_LEN.pack(len(body)) + body)


class FastPathServer:
    """Serves a ``{service-name: ServiceDefinition}`` registry over a
    Unix socket. Unary methods only — streaming methods are simply not
    registered here, so clients keep using gRPC for them."""

    def __init__(self, uds_path: str, authenticator=None,
                 admission=None) -> None:
        self._uds_path = uds_path
        self._auth = authenticator
        self._admission = admission
        #: (service, method) -> fn, resolved once at registration
        self._methods: Dict[Tuple[str, str], Any] = {}
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None
        #: live connections, severed on stop() — a DEPOSED master must
        #: not keep answering local clients over established sockets
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def add_service(self, svc) -> None:
        for method, (fn, kind) in svc.methods.items():
            if kind == "unary":
                self._methods[(svc.name, method)] = fn

    def start(self) -> str:
        from alluxio_tpu_torch.rpc.core import check_admission
        from alluxio_tpu_torch.utils.tracing import (
            bind_remote_parent, reset_remote_parent, tracer,
        )

        methods = self._methods
        authenticator = self._auth
        admission = self._admission
        conns, conns_lock = self._conns, self._conns_lock

        class Handler(socketserver.StreamRequestHandler):
            def setup(self) -> None:
                super().setup()
                with conns_lock:
                    conns.add(self.connection)

            def finish(self) -> None:
                with conns_lock:
                    conns.discard(self.connection)
                super().finish()

            def handle(self) -> None:
                from alluxio_tpu_torch.security.user import (
                    reset_authenticated_user, set_authenticated_user,
                )

                token = None
                try:
                    hello = _read_frame(self.rfile)
                    if hello is None:
                        return
                    md = msgpack.unpackb(hello, raw=False).get(
                        "metadata") or {}
                    if authenticator is not None:
                        try:
                            user = authenticator.authenticate(md)
                        except AlluxioTpuError as e:
                            _send_frame(self.connection,
                                        {"err": e.to_wire()})
                            return
                        token = set_authenticated_user(user)
                    # identity fallback for admission without an
                    # authenticator: without it every socket principal
                    # would collapse into one anonymous bucket and a
                    # flooding tenant would shed its victims too
                    principal_hint = md.get("atpu-user")
                    _send_frame(self.connection, {"ok": True})
                    while True:
                        frame = _read_frame(self.rfile)
                        if frame is None:
                            return  # clean disconnect
                        parts = msgpack.unpackb(
                            frame, raw=False, strict_map_key=False)
                        service, method, request = parts[:3]
                        # optional 4th element: the caller's traceparent
                        traceparent = parts[3] if len(parts) > 3 else None
                        fn = methods.get((service, method))
                        if fn is None:
                            _send_frame(self.connection, {"err": {
                                "code": "UNIMPLEMENTED",
                                "message": f"{service}/{method} has no "
                                           f"fastpath handler"}})
                            continue
                        # span and admission parity with the gRPC
                        # wrapper, joined to the caller's trace: a local
                        # flood must not bypass the gate by riding the
                        # Unix socket
                        trace_token = bind_remote_parent(traceparent)
                        try:
                            with tracer().span(f"{service}.{method}"):
                                check_admission(
                                    admission, None, f"{service}.{method}",
                                    principal_hint=principal_hint)
                                result = fn(request or {})
                            _send_frame(self.connection, {"ok": result})
                        except AlluxioTpuError as e:
                            _send_frame(self.connection,
                                        {"err": e.to_wire()})
                        except Exception as e:  # noqa: BLE001
                            LOG.exception("fastpath handler error")
                            _send_frame(self.connection, {"err": {
                                "code": "INTERNAL",
                                "message": f"{type(e).__name__}: {e}"}})
                        finally:
                            reset_remote_parent(trace_token)
                except (ConnectionError, ValueError, OSError):
                    pass  # peer went away mid-frame
                finally:
                    if token is not None:
                        reset_authenticated_user(token)

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        try:
            os.unlink(self._uds_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            # e.g. a foreign-owned path squatting the conventional name
            # in sticky /tmp: the fast path is an optimization — never
            # let it abort master startup
            LOG.warning("fastpath disabled: cannot claim %s (%s)",
                        self._uds_path, e)
            return ""
        try:
            self._server = Server(self._uds_path, Handler)
        except OSError as e:
            LOG.warning("fastpath disabled: cannot bind %s (%s)",
                        self._uds_path, e)
            self._server = None
            return ""
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="master-fastpath",
            daemon=True)
        self._thread.start()
        return self._uds_path

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        with self._conns_lock:
            live = list(self._conns)
        for conn in live:  # sever: no serving past deposition
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            os.unlink(self._uds_path)
        except FileNotFoundError:
            pass


class FastPathChannel:
    """Client side: one persistent connection PER THREAD (no lock on the
    call path; bench threads never contend), lazily (re)connected.
    ``call`` has the same signature/behavior as ``RpcChannel.call``
    including typed-error re-raise."""

    def __init__(self, uds_path: str,
                 metadata: Tuple[Tuple[str, str], ...] = ()) -> None:
        self._uds_path = uds_path
        self._metadata = dict(metadata)
        self._tl = threading.local()

    def _connect(self, timeout: Optional[float]) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout if timeout else 30.0)
        sock.connect(self._uds_path)
        rfile = sock.makefile("rb", buffering=64 << 10)
        _send_frame(sock, {"metadata": self._metadata})
        resp = _read_frame(rfile)
        if resp is None:
            raise UnavailableError("fastpath hello: connection closed")
        resp = msgpack.unpackb(resp, raw=False, strict_map_key=False)
        if "err" in resp:
            raise AlluxioTpuError.from_wire(resp["err"])
        self._tl.sock, self._tl.rfile = sock, rfile
        self._tl.timeout = timeout
        return sock

    def close_thread_connection(self) -> None:
        sock = getattr(self._tl, "sock", None)
        if sock is not None:
            try:
                self._tl.rfile.close()
                sock.close()
            except OSError:
                pass
            self._tl.sock = self._tl.rfile = None

    def call(self, service: str, method: str, request: dict,
             timeout: Optional[float] = 30.0) -> Any:
        sock = getattr(self._tl, "sock", None)
        try:
            if sock is None:
                sock = self._connect(timeout)
            elif timeout != getattr(self._tl, "timeout", None):
                # per-call deadline, matching the gRPC path's semantics
                sock.settimeout(timeout if timeout else 30.0)
                self._tl.timeout = timeout
            from alluxio_tpu_torch.utils.tracing import current_traceparent

            # optional 4th frame element: the caller's trace context
            tp = current_traceparent()
            _send_frame(sock, [service, method, request] +
                        ([tp] if tp else []))
            resp = _read_frame(self._tl.rfile)
        except (ConnectionError, socket.timeout, OSError) as e:
            self.close_thread_connection()
            raise UnavailableError(f"fastpath: {e}") from None
        if resp is None:
            self.close_thread_connection()
            raise UnavailableError("fastpath: server closed connection")
        resp = msgpack.unpackb(resp, raw=False, strict_map_key=False)
        err = resp.get("err")
        if err is not None:
            raise AlluxioTpuError.from_wire(err)
        return resp.get("ok")


class HybridChannel:
    """gRPC channel + optional fastpath: unary calls ride the Unix
    socket when the master is local and serving one; anything else (or a
    broken socket) falls back to gRPC. Mirrors the short-circuit /
    remote decision of the block-read ladder, for metadata."""

    def __init__(self, grpc_channel, fastpath_dir: str = "/tmp") -> None:
        self._grpc = grpc_channel
        self.address = grpc_channel.address
        self._fast: Optional[FastPathChannel] = None
        self._fast_dead = False
        host, _, _ = grpc_channel.address.rpartition(":")
        path = socket_path_for(grpc_channel.address, fastpath_dir)
        if is_local_host(host) and self._trusted_socket(path):
            self._fast = FastPathChannel(path,
                                         metadata=grpc_channel.metadata)

    @staticmethod
    def _trusted_socket(path: str) -> bool:
        """The conventional path lives in (usually sticky) /tmp: only
        trust a socket owned by our own uid or root, so a local user
        squatting the name cannot harvest clients' auth metadata."""
        try:
            st = os.stat(path)
        except OSError:
            return False
        return st.st_uid in (os.geteuid(), 0)

    def call(self, service: str, method: str, request: dict,
             timeout: Optional[float] = 30.0) -> Any:
        fast = self._fast
        if fast is not None and not self._fast_dead:
            try:
                return fast.call(service, method, request, timeout=timeout)
            except UnavailableError:
                # socket-level failure: the server may be gone entirely
                # or only the fastpath is — let gRPC decide from here on
                self._fast_dead = True
        return self._grpc.call(service, method, request, timeout=timeout)

    @property
    def transport(self) -> str:
        """``"fastpath"`` while unary calls ride the Unix socket, else
        ``"grpc"`` (no socket found, or it broke and gRPC took over)."""
        return "fastpath" if self._fast is not None and \
            not self._fast_dead else "grpc"

    def close(self) -> None:
        """Close the calling thread's socket connection and send every
        later call over gRPC; the gRPC channel is pooled per address
        and stays open for the process's other clients."""
        if self._fast is not None:
            self._fast.close_thread_connection()
        self._fast_dead = True

    def call_stream(self, *args, **kwargs):
        return self._grpc.call_stream(*args, **kwargs)

    def open_stream(self, *args, **kwargs):
        return self._grpc.open_stream(*args, **kwargs)

    def call_stream_in(self, *args, **kwargs):
        return self._grpc.call_stream_in(*args, **kwargs)

    @property
    def metadata(self):
        return self._grpc.metadata
