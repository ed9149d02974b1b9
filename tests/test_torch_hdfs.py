"""The port's HDFS connector (libhdfs through pyarrow) and its HTTP
error-body helpers against the JAX package's.

Mirrors JAX's ``tests/test_hdfs_pyarrow.py`` and ``tests/test_httperr.py``.
``pyarrow.fs.HadoopFileSystem`` is replaced by ``pyarrow.fs.
LocalFileSystem`` rooted at a directory (the JNI connect is the one line
that needs a Hadoop install), so every translation line of both packages'
``underfs/hdfs.py`` runs against pyarrow's own semantics; one seeded script
goes through each package in turn over the same emptied root, and what
each call returns or raises must be equal (times masked: the files are
the run's own).
"""

from __future__ import annotations

import io
import shutil
import urllib.error

import pytest

from tests.test_torch_underfs_connectors import _outcomes, contract
from tests.testutils import torch_ufs as tu
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pafs = pytest.importorskip("pyarrow.fs")

JAX, PORT = tu.JAX, tu.PORT


@pytest.fixture()
def hadoop(tmp_path, monkeypatch):
    """``HadoopFileSystem`` as a LocalFileSystem under ``tmp_path/root``;
    yields a function that empties the root."""
    root = tmp_path / "hdfs-root"

    class _LocalAsHadoop:
        def __init__(self, **kw):
            self.kw = kw
            self._fs = pafs.LocalFileSystem()

        def _m(self, path):
            return str(root) + path

        def open_output_stream(self, path):
            return self._fs.open_output_stream(self._m(path))

        def open_input_file(self, path):
            return self._fs.open_input_file(self._m(path))

        def delete_file(self, path):
            return self._fs.delete_file(self._m(path))

        def delete_dir(self, path):
            return self._fs.delete_dir(self._m(path))

        def move(self, src, dst):
            return self._fs.move(self._m(src), self._m(dst))

        def create_dir(self, path, recursive=True):
            return self._fs.create_dir(self._m(path), recursive=recursive)

        def get_file_info(self, sel):
            if isinstance(sel, pafs.FileSelector):
                return self._fs.get_file_info(pafs.FileSelector(
                    self._m(sel.base_dir), recursive=sel.recursive))
            return self._fs.get_file_info(self._m(sel))

    monkeypatch.setattr(pafs, "HadoopFileSystem", _LocalAsHadoop)

    def fresh():
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir()

    return fresh


def _hdfs(pkg, root="hdfs://nn:8020/", **props):
    return tu.mod(pkg, "underfs.hdfs").HdfsUnderFileSystem(
        root, {"hdfs.user": "atpu", **props})


def _both(hadoop, script):
    got = {}
    for pkg in tu.PACKAGES:
        hadoop()
        trace = tu.Trace(mask_mtime=True)
        script(pkg, trace)
        got[pkg] = trace.rows
    assert got[PORT] == got[JAX]
    return _outcomes(got[PORT])


def test_hdfs_contract_matches_jax(hadoop):
    seen = _both(hadoop, lambda pkg, trace: contract(
        pkg, _hdfs(pkg), "/w", trace, 81))
    assert seen["delete_directory flat"] == ("ok", False)
    assert seen["status deleted"] == ("ok", None)


def test_hdfs_paths_streams_and_types_match_jax(hadoop):
    def script(pkg, trace):
        ufs = _hdfs(pkg)
        trace("connect", lambda: sorted(ufs._fs.kw.items()))
        trace("type", ufs.get_underfs_type)
        trace("create uri", tu.write, ufs, "hdfs://nn:8020/u.bin", b"x")
        trace("status uri", ufs.get_status, "/u.bin")
        tu.write(ufs, "/r.bin", b"0123456789")
        with ufs.open("/r.bin", offset=4) as r:
            trace("read offset", r.read, 3)
        trace("range", ufs.read_range, "/r.bin", 2, 5)
        ufs.mkdirs("/d/e")
        tu.write(ufs, "/d/f.bin", b"z")
        trace("list", lambda: sorted((s.name, s.is_directory)
                                     for s in ufs.list_status("/d")))
        trace("list file", ufs.list_status, "/d/f.bin")
        trace("absent", ufs.get_status, "/nope")
        trace("rename", ufs.rename_file, "/r.bin", "/s.bin")
        trace("moved", ufs.read_range, "/s.bin", 0, 10)
        trace("mtime", lambda: ufs.get_status("/s.bin").last_modified_ms
              > 1_500_000_000_000)

    seen = _both(hadoop, script)
    assert seen["read offset"] == ("ok", b"456")
    assert seen["range"] == ("ok", b"23456")
    assert seen["connect"] == ("ok", [("host", "nn"), ("port", 8020),
                                      ("replication", 3), ("user", "atpu")])
    assert seen["mtime"] == ("ok", True)


def test_hdfs_registers_where_pyarrow_has_libhdfs_binding():
    """Both registries list ``hdfs`` exactly when pyarrow carries the
    binding (the probe is the import of ``pyarrow.fs``)."""
    schemes = {pkg: "hdfs" in tu.mod(pkg, "underfs.registry")
               .supported_schemes() for pkg in tu.PACKAGES}
    assert schemes[PORT] == schemes[JAX] == \
        hasattr(pafs, "HadoopFileSystem")


# -- utils/httperr.py -------------------------------------------------------------
class _ExplodingBody(io.RawIOBase):
    def read(self, *a):  # noqa: ARG002
        raise ConnectionResetError(104, "Connection reset by peer")


def _http_error(fp, code=403) -> urllib.error.HTTPError:
    return urllib.error.HTTPError("http://x/", code, "Forbidden", {}, fp)


@pytest.mark.parametrize("body,limit", [
    (b"a" * 1000, 10), (b"abc", 400), ("été".encode() + b"\xff",
                                       400), (None, 400)])
def test_error_body_matches_jax(body, limit):
    got = {}
    for pkg in tu.PACKAGES:
        httperr = tu.mod(pkg, "utils.httperr")
        fp = _ExplodingBody() if body is None else io.BytesIO(body)
        got[pkg] = httperr.error_body(_http_error(fp), limit=limit)
    assert got[PORT] == got[JAX]
    if body is None:
        assert "unreadable" in got[PORT] and "403" in got[PORT]


def test_drain_swallows_a_reset():
    for pkg in tu.PACKAGES:
        tu.mod(pkg, "utils.httperr").drain(_http_error(_ExplodingBody()))


def test_webhdfs_reads_error_bodies_through_the_port_helper():
    """The port's WebHDFS connector uses the port's own helper."""
    webhdfs = tu.mod(PORT, "underfs.webhdfs")
    assert webhdfs.httperr is tu.mod(PORT, "utils.httperr")
