"""RPC core: msgpack-over-gRPC with typed error propagation.

A copy of ``alluxio_tpu/rpc/core.py`` (re-design of the reference's
``core/common/.../grpc/{GrpcServerBuilder,GrpcChannelBuilder,
GrpcConnectionPool.java:46}``): generic gRPC handlers keyed by method
name carry msgpack bodies, so the messages are the same dicts the wire
types serialize to. Method paths (``/<service>/<method>``), the message
encoding, the 64 MiB message limits and the typed-error trailer are the
JAX package's, so a client of either package talks to a server of the
other.

Errors: a handler raising ``AlluxioTpuError`` becomes a gRPC status plus
the serialized typed payload in trailing metadata; clients re-raise the
same exception class (reference: ``exception/status`` <->
``io.grpc.Status``).

Authentication: a server given an ``authenticator`` (the worker's with
QoS on, ``security/authentication.py``) authenticates every RPC's
metadata and binds the caller for handlers to read through
``security.authenticated_user()``. The ``atpu.debug.fault.rpc.reject.rate`` hook sheds a dispatch
with the typed ``ResourceExhausted`` and retry-after, as the JAX server
does, sparing the admission controller's exempt methods.

Tracing: the client sends the caller's trace context as the
``atpu-traceparent`` metadata entry, and the server binds it before it
opens the method's span, so the server span joins the caller's trace
(as the JAX transport does).

A unary call that the server cancels without a typed error (a master
stopping or demoting tears its calls down) raises ``UnavailableError``,
which the clients retry; the JAX channel raises a plain
``AlluxioTpuError`` that a client does not retry, so a failover can
surface it to a writer (the ``ha`` bench's writer saw it in one run of
twelve on the CPU and in one on the H100).

Reconnects: a client channel retries a lost connection after at most
``RECONNECT_BACKOFF_MAX_MS`` (gRPC's default backoff, which the JAX
channels keep, grows to two minutes). A master restarted on its port, or
a standby promoted onto it, is then reachable again within a second,
where a JAX client that failed through the restart waits out the backoff
it built up (observed: about 14 s after a master's SIGKILL and restart).

Admission: a server given an ``admission`` controller (the master's,
``qos/admission.py``) passes every dispatch through the caller's token
bucket (``check_admission``; the principal is the authenticated user, or
else the ``atpu-user`` metadata entry) and records the check as the
server span's ``admission`` phase.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import grpc
import msgpack

from alluxio_tpu_torch.utils.exceptions import (
    AlluxioTpuError, ResourceExhaustedError, UnavailableError,
)
from alluxio_tpu_torch.utils.tracing import (
    TRACEPARENT_KEY, bind_remote_parent, current_traceparent,
    reset_remote_parent, tracer,
)

LOG = logging.getLogger(__name__)

_ERROR_KEY = "atpu-error-bin"
#: the JAX transport's message limits, both directions
MAX_MESSAGE_BYTES = 64 << 20
#: a client channel's reconnect backoff: first retry, and the cap
RECONNECT_BACKOFF_INITIAL_MS = 100
RECONNECT_BACKOFF_MAX_MS = 1000

_CODE_TO_GRPC = {
    "NOT_FOUND": grpc.StatusCode.NOT_FOUND,
    "ALREADY_EXISTS": grpc.StatusCode.ALREADY_EXISTS,
    "INVALID_ARGUMENT": grpc.StatusCode.INVALID_ARGUMENT,
    "PERMISSION_DENIED": grpc.StatusCode.PERMISSION_DENIED,
    "UNAUTHENTICATED": grpc.StatusCode.UNAUTHENTICATED,
    "FAILED_PRECONDITION": grpc.StatusCode.FAILED_PRECONDITION,
    "RESOURCE_EXHAUSTED": grpc.StatusCode.RESOURCE_EXHAUSTED,
    "UNAVAILABLE": grpc.StatusCode.UNAVAILABLE,
    "DEADLINE_EXCEEDED": grpc.StatusCode.DEADLINE_EXCEEDED,
    "CANCELLED": grpc.StatusCode.CANCELLED,
    "ABORTED": grpc.StatusCode.ABORTED,
    "UNIMPLEMENTED": grpc.StatusCode.UNIMPLEMENTED,
    "INTERNAL": grpc.StatusCode.INTERNAL,
}


def _bind_trace(context: grpc.ServicerContext):
    """Bind an inbound traceparent as this handler's parent context, so
    the server span joins the caller's trace. Returns a reset token
    (None when tracing is off or the call carries no header)."""
    if not tracer().enabled:
        return None
    for k, v in (context.invocation_metadata() or ()):
        if k == TRACEPARENT_KEY:
            return bind_remote_parent(v)
    return None


def pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


def _abort_typed(context: grpc.ServicerContext, e: AlluxioTpuError) -> None:
    context.set_trailing_metadata(((_ERROR_KEY, pack(e.to_wire())),))
    context.abort(_CODE_TO_GRPC.get(e.code, grpc.StatusCode.INTERNAL), str(e))


def _bind_user(context: grpc.ServicerContext, authenticator):
    """Authenticate request metadata and bind the user contextvar; returns
    a reset token (or None). Raises AlluxioTpuError on rejection."""
    if authenticator is None:
        return None
    from alluxio_tpu_torch.security.user import set_authenticated_user

    md = {k: v for k, v in (context.invocation_metadata() or ())}
    user = authenticator.authenticate(md)
    return set_authenticated_user(user)


def _unbind_user(token) -> None:
    if token is not None:
        from alluxio_tpu_torch.security.user import reset_authenticated_user

        reset_authenticated_user(token)


def check_admission(admission, context, method_key: str,
                    principal_hint: Optional[str] = None) -> None:
    """Per-dispatch QoS gate, shared by the gRPC wrappers and the
    fast-path server: the conf-gated fault hook first (so shedding can
    be chaos-drilled with no admission controller and no flood), then
    the per-principal token bucket.  Raises a typed
    ``ResourceExhaustedError`` carrying ``retry_after_s`` — the RPC is
    SHED, never queued (see ``qos/admission.py``).  ``principal_hint``:
    transport-specific identity fallback for servers without a gRPC
    context (the fast path passes its hello frame's ``atpu-user``)."""
    from alluxio_tpu_torch.utils import faults

    if faults.armed():
        # the chaos drill honors the same exemptions real admission
        # does — shedding registration/heartbeats would destabilize
        # the cluster the drill is observing
        from alluxio_tpu_torch.qos.admission import DEFAULT_EXEMPT

        exempt = admission.conf.exempt if admission is not None \
            else DEFAULT_EXEMPT
        if method_key.rsplit(".", 1)[-1] not in exempt:
            ra = faults.injector().take_rpc_reject(method_key)
            if ra:
                err = ResourceExhaustedError(
                    f"injected rpc reject for {method_key}; retry "
                    f"after {ra:.3f}s")
                err.retry_after_s = ra
                raise err
    if admission is None:
        return
    principal = principal_hint
    from alluxio_tpu_torch.security.user import authenticated_user

    user = authenticated_user()
    if user is not None:
        principal = user.name
    elif principal is None and context is not None:
        # no authenticator: fall back to the identity metadata clients
        # attach anyway, so admission can still separate principals
        for k, v in (context.invocation_metadata() or ()):
            if k == "atpu-user":
                principal = v
                break
    admission.check(principal, method_key.rsplit(".", 1)[-1])


def _timed_admission(sp, admission, context, span_name: str) -> None:
    """check_admission, recording its cost as the server span's
    ``admission`` phase when the dispatch is traced."""
    if sp is None:
        check_admission(admission, context, span_name)
        return
    t0 = time.perf_counter()
    check_admission(admission, context, span_name)
    sp.phase("admission", (time.perf_counter() - t0) * 1000.0)


def _wrap_unary(fn: Callable[[dict], Any], authenticator,
                span_name: str, admission=None) -> Callable:
    def handler(request: dict, context: grpc.ServicerContext):
        token = None
        trace_token = _bind_trace(context)
        try:
            with tracer().span(span_name) as sp:
                token = _bind_user(context, authenticator)
                _timed_admission(sp, admission, context, span_name)
                return fn(request or {})
        except AlluxioTpuError as e:
            _abort_typed(context, e)
        except Exception as e:  # noqa: BLE001 - the RPC boundary
            LOG.exception("unhandled error in RPC handler")
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            _unbind_user(token)
            reset_remote_parent(trace_token)

    return handler


def _wrap_stream_out(fn: Callable[[dict], Iterator[Any]], authenticator,
                     span_name: str, admission=None) -> Callable:
    def handler(request: dict, context: grpc.ServicerContext):
        token = None
        trace_token = _bind_trace(context)
        try:
            with tracer().span(span_name) as sp:
                token = _bind_user(context, authenticator)
                _timed_admission(sp, admission, context, span_name)
                yield from fn(request or {})
        except AlluxioTpuError as e:
            _abort_typed(context, e)
        except Exception as e:  # noqa: BLE001 - the RPC boundary
            LOG.exception("unhandled error in streaming RPC handler")
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            _unbind_user(token)
            reset_remote_parent(trace_token)

    return handler


def _wrap_stream_in(fn: Callable[[Iterator[Any]], Any], authenticator,
                    span_name: str, admission=None) -> Callable:
    def handler(request_iterator, context: grpc.ServicerContext):
        token = None
        trace_token = _bind_trace(context)
        try:
            with tracer().span(span_name) as sp:
                token = _bind_user(context, authenticator)
                _timed_admission(sp, admission, context, span_name)
                return fn(request_iterator)
        except AlluxioTpuError as e:
            _abort_typed(context, e)
        except Exception as e:  # noqa: BLE001 - the RPC boundary
            LOG.exception("unhandled error in client-streaming RPC handler")
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            _unbind_user(token)
            reset_remote_parent(trace_token)

    return handler


class ServiceDefinition:
    """A named service: method name -> (callable, kind)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.methods: Dict[str, Tuple[Callable, str]] = {}

    def unary(self, method: str, fn: Callable[[dict], Any]) -> None:
        self.methods[method] = (fn, "unary")

    def stream_out(self, method: str,
                   fn: Callable[[dict], Iterator[Any]]) -> None:
        self.methods[method] = (fn, "stream_out")

    def stream_in(self, method: str,
                  fn: Callable[[Iterator[Any]], Any]) -> None:
        self.methods[method] = (fn, "stream_in")


class _GenericHandler(grpc.GenericRpcHandler):
    def __init__(self, services: Dict[str, ServiceDefinition],
                 authenticator=None, admission=None) -> None:
        self._services = services
        self._auth = authenticator
        self._admission = admission

    def service(self, handler_call_details):
        # method path: /<service>/<method>
        _, _, rest = handler_call_details.method.partition("/")
        service_name, _, method = rest.partition("/")
        svc = self._services.get(service_name)
        entry = svc.methods.get(method) if svc is not None else None
        if entry is None:
            return None
        fn, kind = entry
        span = f"{service_name}.{method}"
        if kind == "unary":
            return grpc.unary_unary_rpc_method_handler(
                _wrap_unary(fn, self._auth, span, self._admission),
                request_deserializer=unpack, response_serializer=pack)
        if kind == "stream_out":
            return grpc.unary_stream_rpc_method_handler(
                _wrap_stream_out(fn, self._auth, span, self._admission),
                request_deserializer=unpack, response_serializer=pack)
        return grpc.stream_unary_rpc_method_handler(
            _wrap_stream_in(fn, self._auth, span, self._admission),
            request_deserializer=unpack, response_serializer=pack)


class RpcServer:
    """gRPC server hosting ServiceDefinitions
    (reference: ``GrpcServerBuilder`` + ``GrpcDataServer.java:50``)."""

    def __init__(self, bind_host: str = "0.0.0.0", port: int = 0,
                 max_workers: int = 16, authenticator=None,
                 admission=None,
                 thread_name_prefix: str = "rpc-server") -> None:
        """``authenticator``: a ``security.authentication.Authenticator``;
        when set, every RPC is authenticated and the resolved user is
        bound for handlers to read via
        ``security.authenticated_user()``. ``admission``: a
        ``qos.admission.AdmissionController``; when set, every dispatch
        passes its per-principal token bucket and over-limit calls are
        shed with a typed retry-after. ``thread_name_prefix`` names the
        handler threads, which ``stop`` joins."""
        self._services: Dict[str, ServiceDefinition] = {}
        self._authenticator = authenticator
        self._admission = admission
        options = [
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ("grpc.so_reuseport", 0),
        ]
        self._executor = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=thread_name_prefix)
        self._server = grpc.server(self._executor, options=options)
        self._bind = f"{bind_host}:{port}"
        self.port = port
        self._started = False

    def add_service(self, svc: ServiceDefinition) -> None:
        self._services[svc.name] = svc

    def service(self, name: str) -> Optional[ServiceDefinition]:
        """Registered service by name — dispatch reads the definition's
        method map per call, so callers may wrap handlers in place even
        after ``start()`` (the HA primacy fence does)."""
        return self._services.get(name)

    def start(self) -> int:
        """Bind and serve; returns the bound port (an ephemeral one for
        port 0). Raises when the address cannot be bound."""
        self._server.add_generic_rpc_handlers(
            (_GenericHandler(self._services, self._authenticator,
                             self._admission),))
        self.port = self._server.add_insecure_port(self._bind)
        if self.port == 0:
            raise UnavailableError(f"cannot bind the RPC server to "
                                   f"{self._bind}")
        self._server.start()
        self._started = True
        return self.port

    def stop(self, grace_s: float = 0.5) -> None:
        """Stop serving, then join the handler threads for up to 5 s (a
        handler stuck past the grace period is left to finish on its
        own)."""
        if self._started:
            self._started = False
            self._server.stop(grace_s).wait(timeout=5)
            self._executor.shutdown(wait=False, cancel_futures=True)
            deadline = time.monotonic() + 5.0
            for t in list(getattr(self._executor, "_threads", ())):
                t.join(max(0.0, deadline - time.monotonic()))


def _raise_typed(err: grpc.RpcError) -> None:
    md = dict(err.trailing_metadata() or ())
    blob = md.get(_ERROR_KEY)
    if blob is not None:
        raise AlluxioTpuError.from_wire(unpack(blob)) from None
    if err.code() == grpc.StatusCode.UNAVAILABLE:
        raise UnavailableError(err.details() or "server unavailable") from None
    raise AlluxioTpuError(f"{err.code().name}: {err.details()}") from None


def default_client_metadata() -> Tuple[Tuple[str, str], ...]:
    """Identity attached to calls when the caller supplies none: the OS
    user (reference: LoginUser under SIMPLE auth)."""
    from alluxio_tpu_torch.security.user import get_os_user

    return (("atpu-user", get_os_user()),)


class StreamCall:
    """A cancellable server-stream: iterate for decoded messages, call
    :meth:`cancel` to abort the underlying HTTP/2 stream mid-flight. A
    self-cancelled stream ends iteration quietly; every other gRPC error
    is re-raised typed like :meth:`RpcChannel.call_stream`."""

    __slots__ = ("_call", "cancelled")

    def __init__(self, call) -> None:
        self._call = call
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        self._call.cancel()

    def __iter__(self) -> Iterator[Any]:
        try:
            yield from self._call
        except grpc.RpcError as e:
            if self.cancelled and e.code() == grpc.StatusCode.CANCELLED:
                return
            _raise_typed(e)


class RpcChannel:
    """A pooled channel + method invokers: one channel per address,
    shared by every client in the process (grpc-python multiplexes
    streams on one HTTP/2 connection) — except for the striped read
    path, where ``pool_index`` > 0 mints additional channels with their
    own subchannel pool, i.e. their own TCP connections, so stripes are
    not serialized behind one connection's flow-control window.
    ``metadata``: identity tuples attached to every call."""

    _pool: Dict[str, grpc.Channel] = {}
    _pool_lock = threading.Lock()

    def __init__(self, address: str,
                 metadata: Optional[Tuple[Tuple[str, str], ...]] = None,
                 pool_index: int = 0) -> None:
        self.address = address
        self.metadata = tuple(metadata) if metadata is not None \
            else default_client_metadata()
        key = address if pool_index == 0 else f"{address}#{pool_index}"
        with RpcChannel._pool_lock:
            ch = RpcChannel._pool.get(key)
            if ch is None:
                options = [
                    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                    ("grpc.initial_reconnect_backoff_ms",
                     RECONNECT_BACKOFF_INITIAL_MS),
                    ("grpc.min_reconnect_backoff_ms",
                     RECONNECT_BACKOFF_INITIAL_MS),
                    ("grpc.max_reconnect_backoff_ms",
                     RECONNECT_BACKOFF_MAX_MS),
                ]
                if pool_index:
                    # opt out of gRPC's global subchannel sharing:
                    # identical-args channels would otherwise coalesce
                    # onto the same TCP connection, defeating the pool
                    options.append(("grpc.use_local_subchannel_pool", 1))
                ch = grpc.insecure_channel(address, options=options)
                RpcChannel._pool[key] = ch
            self._channel = ch

    def _call_metadata(self) -> Tuple[Tuple[str, str], ...]:
        """Per-call metadata: the channel identity plus the caller's
        trace context, so the server span joins the caller's trace."""
        tp = current_traceparent()
        if tp is None:
            return self.metadata
        return self.metadata + ((TRACEPARENT_KEY, tp),)

    def call(self, service: str, method: str, request: dict,
             timeout: Optional[float] = 30.0) -> Any:
        fn = self._channel.unary_unary(
            f"/{service}/{method}", request_serializer=pack,
            response_deserializer=unpack)
        try:
            return fn(request, timeout=timeout,
                      metadata=self._call_metadata())
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.CANCELLED and \
                    _ERROR_KEY not in dict(e.trailing_metadata() or ()):
                # nothing here can cancel a blocking unary call: the
                # server tore it down (a master stopping or demoting)
                raise UnavailableError(
                    f"call cancelled by the server: {e.details()}") from None
            _raise_typed(e)

    def call_stream(self, service: str, method: str, request: dict,
                    timeout: Optional[float] = 300.0) -> Iterator[Any]:
        fn = self._channel.unary_stream(
            f"/{service}/{method}", request_serializer=pack,
            response_deserializer=unpack)
        try:
            yield from fn(request, timeout=timeout,
                          metadata=self._call_metadata())
        except grpc.RpcError as e:
            _raise_typed(e)

    def open_stream(self, service: str, method: str, request: dict,
                    timeout: Optional[float] = 300.0) -> StreamCall:
        """Like :meth:`call_stream` but returns the live call as a
        :class:`StreamCall`, so the caller can ``cancel()`` it."""
        fn = self._channel.unary_stream(
            f"/{service}/{method}", request_serializer=pack,
            response_deserializer=unpack)
        return StreamCall(fn(request, timeout=timeout,
                             metadata=self._call_metadata()))

    def call_stream_in(self, service: str, method: str,
                       requests: Iterator[dict],
                       timeout: Optional[float] = 300.0) -> Any:
        fn = self._channel.stream_unary(
            f"/{service}/{method}", request_serializer=pack,
            response_deserializer=unpack)
        try:
            return fn(requests, timeout=timeout,
                      metadata=self._call_metadata())
        except grpc.RpcError as e:
            _raise_typed(e)

    @classmethod
    def shutdown_pool(cls) -> None:
        with cls._pool_lock:
            for ch in cls._pool.values():
                ch.close()
            cls._pool.clear()
