"""The port's log server (``alluxio_tpu_torch/logserver/``) and the
launcher's remote-logging hook against the JAX package's, on the CPU.

- JAX's ``tests/test_observability.py::TestLogServer``: records shipped by
  each package's ``enable_remote_logging`` land in each package's server
  as the same lines (times masked), under the source's address;
- a crafted frame whose pickle names a global is refused by both
  servers: the connection drops and nothing is written;
- ``shell.launch.maybe_enable_remote_logging`` attaches a handler to the
  root logger when ``atpu.logserver.hostname`` is set, and none when it
  is not, in both packages. Every handler a test attaches is detached
  and closed before the test ends.
"""

import importlib
import logging
import os
import pickle
import re
import socket
import struct
import time

import pytest

from tests.testutils.torch_serving import PACKAGES, PORT
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

_ASCTIME = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ", re.M)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _wait_for(path, needle, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path) and needle in open(path).read():
            return open(path).read()
        time.sleep(0.05)
    raise AssertionError(f"{needle!r} never reached {path}")


def _ship(pkg, logs_dir):
    """JAX's scenario through package ``pkg``: the server's file text
    with its times masked."""
    ls = _mod(pkg, "logserver")
    srv = ls.LogServerProcess(str(logs_dir))
    port = srv.start()
    lg = logging.getLogger("atpu.remote.test")
    handler = ls.enable_remote_logging("127.0.0.1", port,
                                       logger_name="atpu.remote.test")
    old = (lg.level, lg.propagate)
    try:
        lg.setLevel(logging.INFO)
        lg.propagate = False
        lg.info("hello from afar %d", 42)
        lg.debug("below the handler's level")
        lg.warning("watch out")
        text = _wait_for(os.path.join(logs_dir, "127.0.0.1.log"),
                         "watch out")
    finally:
        lg.removeHandler(handler)
        handler.close()
        lg.setLevel(old[0])
        lg.propagate = old[1]
        srv.stop()
    return sorted(os.listdir(logs_dir)), _ASCTIME.sub("<T> ", text)


def test_records_aggregate_per_source_like_jax(tmp_path):
    got = [_ship(pkg, tmp_path / pkg) for pkg in PACKAGES]
    assert got[1] == got[0]
    files, text = got[1]
    assert files == ["127.0.0.1.log"]
    assert text == (
        "<T> INFO    atpu.remote.test [127.0.0.1] hello from afar 42\n"
        "<T> WARNING atpu.remote.test [127.0.0.1] watch out\n")


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_crafted_frame_is_refused(pkg, tmp_path):
    """A frame whose pickle names a global (here ``os.getcwd`` through
    ``__reduce__``) is never executed: the server drops the connection
    and writes no file."""
    srv = _mod(pkg, "logserver").LogServerProcess(str(tmp_path / "logs"))
    port = srv.start()
    try:
        payload = pickle.dumps({"msg": _Evil(), "levelno": 20})
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(struct.pack(">L", len(payload)) + payload)
            s.settimeout(10)
            assert s.recv(1) == b""  # dropped, not answered
        time.sleep(0.2)
        assert os.listdir(tmp_path / "logs") == []
    finally:
        srv.stop()


def _hook(pkg, host):
    conf = _mod(pkg, "conf").Configuration(load_env=False)
    keys = _mod(pkg, "conf").Keys
    if host:
        conf.set(keys.LOGSERVER_HOSTNAME, host)
    conf.set(keys.LOGSERVER_PORT, 1)
    root = logging.getLogger()
    before = list(root.handlers)
    _mod(pkg, "shell.launch").maybe_enable_remote_logging(conf)
    added = [h for h in root.handlers if h not in before]
    for h in added:
        root.removeHandler(h)
        h.close()
    return [(type(h).__name__, h.host, h.port, h.level) for h in added]


@pytest.mark.parametrize("host", ["", "127.0.0.1"])
def test_remote_logging_hook_like_jax(host):
    got = [_hook(pkg, host) for pkg in PACKAGES]
    assert got[1] == got[0]
    assert got[1] == ([("SocketHandler", host, 1, logging.INFO)]
                      if host else [])


def test_launcher_skips_the_hook_for_the_log_server(monkeypatch):
    """Every role but the log server calls the hook (a log server that
    shipped its own records to itself would loop)."""
    launch = _mod(PORT, "shell.launch")
    calls = []
    monkeypatch.setattr(launch.logging, "basicConfig", lambda **kw: None)
    monkeypatch.setattr(launch, "maybe_enable_remote_logging",
                        lambda conf: calls.append("hook"))
    monkeypatch.setattr(launch, "_LAUNCHERS",
                        {r: (lambda conf, r=r: calls.append(r) or 0)
                         for r in launch._LAUNCHERS})
    conf = _mod(PORT, "conf").Configuration(load_env=False)
    for role in ("logserver", "proxy", "fuse", "master"):
        assert launch.launch_process(role, conf) == 0
    assert calls == ["logserver", "hook", "proxy", "hook", "fuse",
                     "hook", "master"]
