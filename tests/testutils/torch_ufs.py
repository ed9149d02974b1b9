"""Parity harness for the UFS connectors and client adapters.

One script of connector calls runs through each package in turn, each
against its own instance of one fake HTTP server. The second instance
binds the port the first one had, so that the ``Host`` header, and every
signature over it, is the same in both runs. While a package runs, the
clocks its signers and stores read (and the fake's own clock and upload
ids) are pinned to one instant and one seeded id stream. The fake records
every request line with its headers; a script records what each call
returned or raised, with statuses turned into plain tuples.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import email.utils
import importlib
import random
import re
import threading
import time
import types
import uuid
from http.server import ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from unittest import mock

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES

#: the instant every pinned clock reads (2025-06-01T00:00:00Z)
NOW_S = 1_748_736_000.0

#: a multipart form's boundary: ``requests`` draws it from the OS
_BOUNDARY = re.compile(r"boundary=[0-9a-f]+")

#: (module, attribute) of the clocks each package's connectors read
_PKG_CLOCKS = (
    ("underfs.s3", "datetime"),
    ("underfs.azure", "time"), ("underfs.azure", "formatdate"),
    ("underfs.vendor_native", "time"),
    ("underfs.vendor_native", "formatdate"),
    ("underfs.swift", "time"),
    ("underfs.object_base", "time"),
)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _FixedDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime.fromtimestamp(NOW_S, tz)


def _shim(name: str):
    """A stand-in for a module attribute that reads the clock (or draws
    an id): everything else passes through to the real module."""
    if name == "datetime":
        return types.SimpleNamespace(
            datetime=_FixedDatetime, timezone=datetime.timezone,
            timedelta=datetime.timedelta)
    if name == "formatdate":
        return lambda timeval=None, localtime=False, usegmt=False: \
            email.utils.formatdate(NOW_S, localtime, usegmt)
    if name == "time":
        ns = types.SimpleNamespace(**{k: getattr(time, k)
                                      for k in dir(time)
                                      if not k.startswith("__")})
        ns.time = lambda: NOW_S
        return ns
    if name == "uuid":
        rng = random.Random(0)
        ns = types.SimpleNamespace(**{k: getattr(uuid, k)
                                      for k in dir(uuid)
                                      if not k.startswith("__")})
        ns.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
        return ns
    raise KeyError(name)


@contextlib.contextmanager
def pinned(pkg: str, fake_module=None):
    """Pin the clocks of package ``pkg``'s connectors and, where given,
    the fake module's clock and id draws."""
    with contextlib.ExitStack() as stack:
        for name, attr in _PKG_CLOCKS:
            stack.enter_context(mock.patch.object(
                mod(pkg, name), attr, _shim(attr)))
        if fake_module is not None:
            for attr in ("time", "formatdate", "uuid"):
                if hasattr(fake_module, attr):
                    stack.enter_context(mock.patch.object(
                        fake_module, attr, _shim(attr)))
        yield


def _recording(fake_cls, port: int, log: List[Tuple]):
    """``fake_cls`` bound to ``port`` (0: any), its handler recording
    every request's method, path and headers into ``log``."""

    class Recording(fake_cls):
        def _init_server(self, handler_cls) -> None:
            class Handler(handler_cls):
                def parse_request(self):
                    ok = super().parse_request()
                    if ok:
                        log.append((self.command, self.path, tuple(
                            (k, _BOUNDARY.sub("boundary=*", v))
                            for k, v in self.headers.items())))
                    return ok

            self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
            self._server.daemon_threads = True
            self.port = self._server.server_address[1]
            self._thread = None

        def __enter__(self):
            # a short poll: the fake stops within 50 ms of the script
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True,
                name=fake_cls.__name__)
            self._thread.start()
            return self

    return Recording


@dataclasses.dataclass
class Run:
    """One package's run: what the script recorded and the requests the
    fake saw."""

    observed: List[Tuple]
    requests: List[Tuple]
    server: object


def run_both(fake_cls, script: Callable,
             fake_kwargs: Optional[Dict] = None) -> Dict[str, Run]:
    """Run ``script(pkg, server, trace)`` once per package, each against a
    fresh ``fake_cls(**fake_kwargs)`` on one shared port, clocks pinned."""
    fake_module = importlib.import_module(fake_cls.__module__)
    out: Dict[str, Run] = {}
    port = 0
    for pkg in PACKAGES:
        log: List[Tuple] = []
        trace = Trace()
        srv = _recording(fake_cls, port, log)(**(fake_kwargs or {}))
        port = srv.port
        with pinned(pkg, fake_module), srv:
            script(pkg, srv, trace)
        out[pkg] = Run(trace.rows, log, srv)
    return out


def norm(value, mask_mtime: bool = False):
    """A value both packages can be compared on: a status (of either
    package) becomes a tuple of its fields, containers are walked."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        fields = dataclasses.asdict(value)
        if mask_mtime and fields.get("last_modified_ms") is not None:
            # a store over real files: its times (and the local UFS's
            # content hash, which carries the time) are the run's own
            fields["last_modified_ms"] = \
                fields["last_modified_ms"] > 1_500_000_000_000
            fields["content_hash"] = bool(fields.get("content_hash"))
        return (type(value).__name__, tuple(sorted(fields.items())))
    if isinstance(value, (list, tuple)):
        rows = [norm(v, mask_mtime) for v in value]
        return rows if isinstance(value, list) else tuple(rows)
    if isinstance(value, dict):
        return {k: norm(v, mask_mtime) for k, v in value.items()}
    return value


class Trace:
    """Records each call's label and outcome: ``("ok", value)`` or
    ``("raise", exception type, message)``."""

    def __init__(self, mask_mtime: bool = False) -> None:
        self.rows: List[Tuple] = []
        self.mask_mtime = mask_mtime

    def __call__(self, label: str, fn: Callable, *args, **kwargs):
        try:
            value = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the outcome is the record
            self.rows.append((label, "raise", type(e).__name__, str(e)))
            return None
        self.rows.append((label, "ok", norm(value, self.mask_mtime)))
        return value


def write(ufs, path: str, data: bytes) -> int:
    """A whole-object write through the UFS's ``create`` stream."""
    with ufs.create(path) as w:
        w.write(data)
    return len(data)


def payload(seed: int, n: int) -> bytes:
    return random.Random(seed).randbytes(n)
