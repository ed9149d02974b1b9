"""The port's UFS connectors against the JAX package's, on the CPU.

Mirrors JAX's ``tests/test_underfs_connectors.py``: S3 (and its vendor
gateways) on the fake S3 server, the web UFS on a stdlib file server,
WebHDFS on the fake NameNode, the sleeping wrapper, ``mem://`` in process,
the registry, and a cluster mount of ``s3://``. Each case runs one seeded
script of calls through both packages' connectors, each against its own
instance of the fake on the same port with the clocks pinned
(``tests/testutils/torch_ufs.py``): what the calls return must be equal,
and so must every request line, header and signature the fake saw.
"""

from __future__ import annotations

import functools
import importlib
import http.server
import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.testutils import torch_ufs as tu
from tests.testutils.fake_s3 import FakeS3Server
from tests.testutils.fake_webhdfs import FakeWebHdfsServer
from tests.testutils.httpfake import HttpFakeServer
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

JAX, PORT = tu.JAX, tu.PORT
ROOT = Path(__file__).resolve().parents[1]
S3_PROPS = {"s3.access.key": "test", "s3.secret.key": "secret",
            "s3.multipart.size": str(64 * 1024)}


def contract(pkg, ufs, base, trace, seed, *, renames=True):
    """One seeded pass over the UFS SPI: mkdirs, writes of seeded sizes,
    positioned and streamed reads, statuses, listings, renames and the
    delete semantics (``UnderFileSystemContractTest``'s surface)."""
    rng = random.Random(seed)
    delete_options = tu.mod(pkg, "underfs.base").DeleteOptions
    trace("mkdirs", ufs.mkdirs, f"{base}/c/sub")
    files = {}
    for i in range(4):
        path = f"{base}/c/f{i}" if i % 2 else f"{base}/c/sub/f{i}"
        files[path] = rng.randbytes(rng.randrange(1, 3000))
        trace(f"create {path}", tu.write, ufs, path, files[path])
    for path, data in files.items():
        off = rng.randrange(len(data))
        n = rng.randrange(1, len(data) - off + 1)
        trace(f"read_range {path}", ufs.read_range, path, off, n)
        trace(f"open {path}", _read_from, ufs, path, off)
        trace(f"status {path}", ufs.get_status, path)
    trace("list c", _listing, ufs, f"{base}/c")
    trace("list sub", _listing, ufs, f"{base}/c/sub")
    trace("status dir", ufs.get_status, f"{base}/c/sub")
    trace("status missing", ufs.get_status, f"{base}/c/nope")
    if renames:
        trace("rename_file", ufs.rename_file, f"{base}/c/f1",
              f"{base}/c/f1r")
        trace("status renamed away", ufs.get_status, f"{base}/c/f1")
        trace("read renamed", ufs.read_range, f"{base}/c/f1r", 0, 8)
        trace("rename_directory", ufs.rename_directory, f"{base}/c/sub",
              f"{base}/c/sub2")
        trace("list after renames", _listing, ufs, f"{base}/c")
    trace("delete_file", ufs.delete_file, f"{base}/c/f3")
    trace("delete_directory flat", ufs.delete_directory, f"{base}/c")
    trace("delete_directory recursive", ufs.delete_directory, f"{base}/c",
          delete_options(recursive=True))
    trace("status deleted", ufs.get_status, f"{base}/c")
    return files


def _read_from(ufs, path, offset):
    with ufs.open(path, offset=offset) as f:
        return f.read()


def _listing(ufs, path):
    out = ufs.list_status(path)
    return None if out is None else sorted(out, key=lambda s: s.name)


def _assert_parity(runs, *, requests=True):
    jax, port = runs[JAX], runs[PORT]
    assert port.observed == jax.observed
    if requests:
        assert port.requests == jax.requests
    return jax.observed


def _outcomes(observed):
    return {row[0]: row[1:] for row in observed}


# -- S3 -----------------------------------------------------------------------
def _s3(pkg, srv, root="s3://bkt/data", **props):
    return tu.mod(pkg, "underfs.s3").S3UnderFileSystem(
        root, {"s3.endpoint": srv.endpoint, **S3_PROPS, **props})


@pytest.mark.parametrize("seed", [0, 1])
def test_s3_contract_matches_jax(seed):
    def script(pkg, srv, trace):
        contract(pkg, _s3(pkg, srv), "s3://bkt/data", trace, seed)

    runs = tu.run_both(FakeS3Server, script)
    seen = _outcomes(_assert_parity(runs))
    assert seen["delete_directory flat"] == ("ok", False)
    assert seen["delete_directory recursive"] == ("ok", True)
    assert seen["status deleted"] == ("ok", None)
    assert any("AWS4-HMAC-SHA256" in dict(h).get("Authorization", "")
               for _, _, h in runs[PORT].requests)


def test_s3_multipart_upload_matches_jax():
    """200 KB in 10 KB writes at a 64 KB part size: initiate, four parts,
    complete, with the same upload ids, part numbers and signatures."""
    data = tu.payload(7, 200_000)

    def script(pkg, srv, trace):
        ufs = _s3(pkg, srv)
        with ufs.create("s3://bkt/data/big.bin") as w:
            for i in range(0, len(data), 10_000):
                w.write(data[i:i + 10_000])
        trace("read", _read_from, ufs, "s3://bkt/data/big.bin", 0)
        trace("status", ufs.get_status, "s3://bkt/data/big.bin")

    runs = tu.run_both(FakeS3Server, script)
    seen = _outcomes(_assert_parity(runs))
    assert seen["read"] == ("ok", data)
    parts = [p for m, p, _ in runs[PORT].requests
             if m == "PUT" and "partNumber=" in p]
    assert len(parts) == 4


def test_s3_list_pagination_matches_jax():
    """1005 keys: the listing follows the continuation token once."""
    def script(pkg, srv, trace):
        with srv.state.lock:
            for i in range(1005):
                srv.state.objects[f"bkt/data/p/f{i:05d}"] = b"x"
        ufs = _s3(pkg, srv)
        trace("keys", ufs._client.list_prefix, "data/p/")

    runs = tu.run_both(FakeS3Server, script)
    seen = _outcomes(_assert_parity(runs))
    assert len(seen["keys"][1]) == 1005
    assert sum("continuation-token" in p for _, p, _ in
               runs[PORT].requests) == 1


def test_sigv4_signature_matches_jax():
    """The signer alone, clock pinned: equal headers, byte for byte."""
    signed = {}
    for pkg in tu.PACKAGES:
        with tu.pinned(pkg):
            signer = tu.mod(pkg, "underfs.s3").SigV4Signer(
                "AKID", "secret/key", "eu-west-1")
            signed[pkg] = signer.sign(
                "PUT", "https://bkt.s3.amazonaws.com/a%20b/c?partNumber=2"
                "&uploadId=x%2By", {"Range": "bytes=0-9"}, "e3b0c442")
    assert signed[PORT] == signed[JAX]
    assert "20250601/eu-west-1/s3/aws4_request" in \
        signed[PORT]["Authorization"]


@pytest.mark.parametrize("scheme", ["oss", "cos", "kodo", "obs"])
def test_vendor_gateway_contract_matches_jax(scheme):
    """Each vendor remap speaks SigV4 to the fake S3 through the
    registry, as JAX's ``TestVendorRemapContracts``."""
    def script(pkg, srv, trace):
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(
            f"{scheme}://bkt/", {f"{scheme}.endpoint": srv.endpoint,
                                 f"{scheme}.access.key": "ak",
                                 f"{scheme}.secret.key": "sk"})
        trace("type", ufs.get_underfs_type)
        trace("class", lambda: type(ufs).__name__)
        contract(pkg, ufs, f"{scheme}://bkt/w", trace, 3)

    _assert_parity(tu.run_both(FakeS3Server, script))


def test_swift_gateway_contract_matches_jax():
    def script(pkg, srv, trace):
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(
            "swift://bkt/", {"swift.endpoint": srv.endpoint,
                             "swift.access.key": "ak",
                             "swift.secret.key": "sk"})
        trace("class", lambda: type(ufs).__name__)
        contract(pkg, ufs, "swift://bkt", trace, 4)

    _assert_parity(tu.run_both(FakeS3Server, script))


# -- web ----------------------------------------------------------------------
class _WebFake(HttpFakeServer):
    """A stdlib static file server over one directory."""

    def __init__(self, directory: str) -> None:
        self._init_server(type("Static", (
            http.server.SimpleHTTPRequestHandler,), {
                "__init__": functools.partialmethod(
                    http.server.SimpleHTTPRequestHandler.__init__,
                    directory=directory),
                "log_message": lambda self, *a: None}))


def test_web_ufs_matches_jax(tmp_path):
    files = tmp_path / "files"
    (files / "sub").mkdir(parents=True)
    (files / "a.txt").write_bytes(b"alpha-content")
    (files / "sub" / "b.txt").write_bytes(b"beta")

    def script(pkg, srv, trace):
        base = f"{srv.endpoint}/files"
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(base)
        trace("type", ufs.get_underfs_type)
        trace("status", ufs.get_status, f"{base}/a.txt")
        trace("read", _read_from, ufs, f"{base}/a.txt", 0)
        trace("read offset", _read_from, ufs, f"{base}/a.txt", 6)
        trace("range", ufs.read_range, f"{base}/a.txt", 0, 5)
        trace("list", _listing, ufs, base)
        trace("missing", ufs.get_status, f"{base}/nope.txt")
        trace("create", ufs.create, f"{base}/new.txt")
        trace("mkdirs", ufs.mkdirs, f"{base}/d")

    runs = tu.run_both(_WebFake, script, {"directory": str(tmp_path)})
    seen = _outcomes(_assert_parity(runs))
    assert seen["read"] == ("ok", b"alpha-content")
    assert seen["range"] == ("ok", b"alpha")
    assert seen["missing"] == ("ok", None)
    assert seen["create"][0] == "raise"


# -- WebHDFS ------------------------------------------------------------------
def _webhdfs(pkg, srv):
    return tu.mod(pkg, "underfs.registry").create_ufs(
        srv.uri, {"hdfs.user": "atpu"})


class _WebHdfs(FakeWebHdfsServer):
    """The fake NameNode over a directory of the run's own."""

    def __init__(self, root: str) -> None:
        super().__init__(os.path.join(root, f"nn{time.monotonic_ns()}"))


def _webhdfs_runs(tmp_path, script):
    return tu.run_both(_WebHdfs, script, {"root": str(tmp_path)})


def test_webhdfs_contract_matches_jax(tmp_path):
    def script(pkg, srv, trace):
        trace.mask_mtime = True
        contract(pkg, _webhdfs(pkg, srv), "/w", trace, 5)

    runs = _webhdfs_runs(tmp_path, script)
    seen = _outcomes(_assert_parity(runs))
    assert seen["delete_directory flat"] == ("ok", False)
    assert seen["status deleted"] == ("ok", None)
    assert runs[PORT].server.users and \
        set(runs[PORT].server.users) == {"atpu"}


def test_webhdfs_create_redirect_and_streams_match_jax(tmp_path):
    """The two-step CREATE (307 then the data PUT), partial streamed
    reads, an aborted create that uploads nothing, and a file that is not
    listable."""
    def script(pkg, srv, trace):
        trace.mask_mtime = True
        ufs = _webhdfs(pkg, srv)
        trace("create", tu.write, ufs, "/a/b/f.bin", b"hdfs-payload" * 10)
        trace("creates", lambda: [r for r in srv.requests
                                  if "PUT CREATE" in r])
        trace("range", ufs.read_range, "/a/b/f.bin", 4, 5)
        r = ufs.open("/a/b/f.bin")
        trace("read 3", r.read, 3)
        trace("read 2", r.read, 2)
        r.close()
        trace("tail", _read_from, ufs, "/a/b/f.bin", 118)

        def aborted():
            with ufs.create("/partial") as w:
                w.write(b"half-written")
                raise RuntimeError("writer died")

        trace("aborted", aborted)
        trace("partial", ufs.get_status, "/partial")
        trace("open missing", ufs.open, "/nope")
        trace("list file", ufs.list_status, "/a/b/f.bin")
        trace("list missing", ufs.list_status, "/nope")
        trace("type confusion file", ufs.delete_file, "/a/b")
        trace("type confusion dir", ufs.delete_directory, "/a/b/f.bin")
        trace("mkdirs existing", ufs.mkdirs, "/a/b")
        trace("mkdirs no parent", ufs.mkdirs, "/no/parent/deep", False)
        trace("active sync", ufs.supports_active_sync)

    seen = _outcomes(_assert_parity(_webhdfs_runs(tmp_path, script)))
    assert len(seen["creates"][1]) == 2
    assert seen["read 3"] == ("ok", b"hdf")
    assert seen["tail"] == ("ok", b"ad")
    assert seen["partial"] == ("ok", None)
    assert seen["open missing"][1] == "FileNotFoundError"


def test_webhdfs_standby_errors_match_jax(tmp_path):
    """A standby NameNode's RemoteException raises; it never reads as a
    missing file."""
    def script(pkg, srv, trace):
        trace.mask_mtime = True
        ufs = _webhdfs(pkg, srv)
        trace("create", tu.write, ufs, "/keep", b"x")
        srv.fail_all = ("StandbyException",
                        "Operation category READ is not supported in "
                        "state standby")
        trace("status", ufs.get_status, "/keep")
        trace("list", ufs.list_status, "/")
        trace("open", ufs.open, "/keep")
        srv.fail_all = None
        trace("status after", ufs.get_status, "/keep")

    seen = _outcomes(_assert_parity(_webhdfs_runs(tmp_path, script)))
    assert seen["status"][0] == "raise" and \
        "StandbyException" in seen["status"][2]
    assert seen["status after"][1] is not None


def test_webhdfs_active_sync_matches_jax(tmp_path):
    """An external write and delete behind the connector's back show in
    the namespace after the active-sync tick, in both packages' masters
    (JAX's ``TestHdfsActiveSync``)."""
    def script(pkg, srv, trace):
        journal = tu.mod(pkg, "journal").NoopJournalSystem()
        master = tu.mod(pkg, "master")
        bm = master.BlockMaster(journal)
        fsm = master.FileSystemMaster(bm, journal)
        root = tmp_path / f"root-{pkg}"
        os.makedirs(root)
        fsm.start(str(root))
        try:
            fsm.mount("/wh", srv.uri, properties={"hdfs.user": "atpu"})
            asm = tu.mod(pkg, "master.sync").ActiveSyncManager(fsm, journal)
            ufs = _webhdfs(pkg, srv)
            ufs.mkdirs("/data")
            tu.write(ufs, "/data/seen", b"1")
            trace("before", lambda: [i.name for i in
                                     fsm.list_status("/wh/data")])
            asm.add_sync_point("/wh/data")
            with open(os.path.join(srv.root, "data", "unseen"), "wb") as f:
                f.write(b"external-bytes")
            os.unlink(os.path.join(srv.root, "data", "seen"))
            asm.heartbeat()
            trace("after", lambda: [i.name for i in
                                    fsm.list_status("/wh/data")])
            trace("length", lambda: fsm.get_status(
                "/wh/data/unseen").length)
            trace("changed", lambda: bool(asm.last_runs["/wh/data"][1]))
        finally:
            fsm.stop()

    seen = _outcomes(_assert_parity(_webhdfs_runs(tmp_path, script),
                                    requests=False))
    assert seen["after"] == ("ok", ["unseen"])
    assert seen["length"] == ("ok", 14)
    assert seen["changed"] == ("ok", True)


# -- the sleeping wrapper -----------------------------------------------------
def test_sleeping_ufs_matches_jax(tmp_path, monkeypatch):
    """The same ops nap for the same seconds and count the same, over the
    local UFS, in both packages."""
    got = {}
    for pkg in tu.PACKAGES:
        naps = []
        delegating = tu.mod(pkg, "underfs.delegating")
        monkeypatch.setattr(delegating.time, "sleep", naps.append)
        root = tmp_path / "ufs"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir()
        inner = tu.mod(pkg, "underfs.local").LocalUnderFileSystem(str(root))
        ufs = delegating.SleepingUnderFileSystem(
            inner, sleeps={"get_status": 0.05, "list_status": 0.25,
                           "read_range": 0.125})
        trace = tu.Trace(mask_mtime=True)
        contract(pkg, ufs, str(root), trace, 6)
        monkeypatch.undo()
        got[pkg] = (trace.rows, ufs.op_counts, naps,
                    ufs.get_underfs_type(), ufs.supports_active_sync())
    assert got[PORT] == got[JAX]
    assert got[PORT][1]["get_status"] == 8 and \
        sorted(set(got[PORT][2])) == [0.05, 0.125, 0.25]


def test_sleeping_ufs_really_sleeps(tmp_path):
    delegating = tu.mod(PORT, "underfs.delegating")
    inner = tu.mod(PORT, "underfs.local").LocalUnderFileSystem(str(tmp_path))
    ufs = delegating.SleepingUnderFileSystem(inner,
                                             sleeps={"get_status": 0.05})
    p = str(tmp_path / "f")
    tu.write(ufs, p, b"x")
    t0 = time.monotonic()
    assert ufs.get_status(p) is not None
    assert time.monotonic() - t0 >= 0.05
    assert ufs.op_counts == {"create": 1, "get_status": 1}


# -- mem:// ---------------------------------------------------------------------
def test_mem_ufs_matches_jax():
    """``mem://`` in process: the registry's built-in object store, its
    buckets shared by every instance of one package's class."""
    got = {}
    for pkg in tu.PACKAGES:
        store = tu.mod(pkg, "underfs.object_base").MemObjectStore
        store.reset_all()
        create_ufs = tu.mod(pkg, "underfs.registry").create_ufs
        trace = tu.Trace()
        with tu.pinned(pkg):
            ufs = create_ufs("mem://bkt/root")
            contract(pkg, ufs, "mem://bkt/root", trace, 8)
            tu.write(ufs, "mem://bkt/root/kept", b"kept")
            other = create_ufs("mem://bkt/root")
            trace("shared", other.read_range, "mem://bkt/root/kept", 0, 4)
            trace("keys", store.bucket("bkt").list_prefix, "")
        got[pkg] = (trace.rows, ufs.get_underfs_type())
        store.reset_all()
    assert got[PORT] == got[JAX]
    assert _outcomes(got[PORT][0])["shared"] == ("ok", b"kept")


def test_mem_buckets_are_per_package():
    jstore = tu.mod(JAX, "underfs.object_base").MemObjectStore
    pstore = tu.mod(PORT, "underfs.object_base").MemObjectStore
    try:
        pstore.bucket("only-port").put("k", b"v")
        assert pstore.bucket("only-port").get("k") == b"v"
        assert jstore.bucket("only-port").get("k") is None
    finally:
        jstore.reset_all()
        pstore.reset_all()


# -- the registry ---------------------------------------------------------------
def test_supported_schemes_match_jax():
    schemes = {pkg: tu.mod(pkg, "underfs.registry").supported_schemes()
               for pkg in tu.PACKAGES}
    assert schemes[PORT] == schemes[JAX]
    for s in ("", "file", "mem", "s3", "s3a", "oss", "cos", "kodo", "obs",
              "swift", "http", "https", "gs", "gcs", "wasb", "wasbs",
              "abfs", "abfss", "adl", "o3fs", "ofs", "webhdfs"):
        assert s in schemes[PORT], s


def test_registry_names_the_port_connectors():
    """Every optional connector of the port is a port module, and the
    table names the same factories and schemes as JAX's (JAX leaves some
    schemes to the class's ``schemes`` attribute; the port writes each
    out, since it imports no connector to read it)."""
    reg = {pkg: tu.mod(pkg, "underfs.registry") for pkg in tu.PACKAGES}
    port = [(m.replace(PORT + ".", ""), c, s)
            for m, c, s in reg[PORT]._OPTIONAL_CONNECTORS]
    jax = [(m.replace(JAX + ".", ""), c,
            s or getattr(importlib.import_module(m), c).schemes)
           for m, c, s in reg[JAX]._OPTIONAL_CONNECTORS]
    assert port == jax
    assert all(m.startswith(PORT + ".underfs.")
               for m, _, _ in reg[PORT]._OPTIONAL_CONNECTORS)
    for scheme in reg[PORT].supported_schemes():
        factory = reg[PORT]._FACTORIES[scheme]
        assert factory.__module__.startswith(PORT + "."), scheme


def test_optional_connector_imports_with_its_first_uri():
    """The port imports an optional connector when a URI of its scheme is
    first created, not at import (the one difference from JAX's, in its
    docstring): a process that boots the master's modules and makes a
    local and a ``mem://`` UFS, as every master does, loads neither
    requests nor pyarrow; an ``s3://`` URI loads requests and not
    pyarrow. A factory the caller registers first still replaces the
    optional one, as in JAX, and ``supported_schemes()`` lists JAX's."""
    code = (
        "import sys, tempfile\n"
        "import alluxio_tpu_torch.master.metastore, "
        "alluxio_tpu_torch.master.process, "
        "alluxio_tpu_torch.worker.ufs_manager\n"
        "import alluxio_tpu_torch.underfs.registry as r\n"
        "heavy = lambda: sorted(m for m in ('pyarrow', 'requests') "
        "if m in sys.modules)\n"
        "r.create_ufs(tempfile.mkdtemp()); r.create_ufs('mem://b/x')\n"
        "print(heavy())\n"
        "r.create_ufs('s3://b/x', {'s3.endpoint': 'http://127.0.0.1:1'})\n"
        "print(heavy())\n"
        "class Mine: pass\n"
        "r.register_factory('gs', Mine)\n"
        "print(' '.join(r.supported_schemes()))\n"
        "print(r._FACTORIES['gs'] is Mine, r._FACTORIES['s3'].__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "[]"
    assert lines[1] == "['requests']"
    want = " ".join(tu.mod(JAX, "underfs.registry").supported_schemes())
    assert lines[2] == want
    assert lines[3] == "True S3UnderFileSystem"


def test_ufs_manager_matches_jax(tmp_path):
    got = {}
    for pkg in tu.PACKAGES:
        m = tu.mod(pkg, "underfs.registry").UfsManager()
        first = m.add_mount(1, str(tmp_path))
        m.add_mount(2, "mem://b/x")
        got[pkg] = (m.add_mount(1, "mem://other") is first,
                    m.get(1).get_underfs_type(),
                    m.get(2).get_underfs_type(), m.has(1), m.has(3))
        m.remove_mount(1)
        assert not m.has(1)
        with pytest.raises(Exception) as err:
            m.get(1)
        got[pkg] += (type(err.value).__name__,)
        m.close()
        assert not m.has(2)
    assert got[PORT] == got[JAX]


# -- a cluster mount of s3:// ---------------------------------------------------
def _wait_cached(cluster, path, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        infos = cluster.fs_client().get_file_block_info_list(path)
        if any(fbi.block_info.locations for fbi in infos):
            return True
        time.sleep(0.05)
    return False


def test_cluster_mount_s3_cold_read_matches_jax(tmp_path):
    """Each package's LocalCluster mounts the same bucket on the fake S3
    and reads a three-block file cold from it, then writes a file back
    through it: the bytes are equal, and so is what lands in the bucket."""
    data = tu.payload(11, 3 * (64 << 10) + 123)
    got = {}
    with FakeS3Server() as srv:
        props = {"s3.endpoint": srv.endpoint, "s3.access.key": "k",
                 "s3.secret.key": "s"}
        tu.mod(JAX, "underfs.s3").S3Client("warm", props).put(
            "ds/part-0", data)
        for pkg in tu.PACKAGES:
            lc = tu.mod(pkg, "minicluster.local_cluster")
            with lc.LocalCluster(str(tmp_path / pkg), num_workers=1,
                                 block_size=64 << 10,
                                 start_worker_heartbeats=True) as c:
                fs = c.file_system()
                fs.mount("/s3", "s3://warm/ds", properties=props)
                status = fs.get_status("/s3/part-0")
                read = fs.read_all("/s3/part-0")
                cached = _wait_cached(c, "/s3/part-0")
                fs.write_all(f"/s3/out-{pkg}", read[:5000],
                             write_type="CACHE_THROUGH")
                got[pkg] = (read, status.length, len(status.block_ids),
                            cached, sorted(
                                i.name for i in fs.list_status("/s3")))
                fs.close()
        client = tu.mod(PORT, "underfs.s3").S3Client("warm", props)
        back = {pkg: client.get(f"ds/out-{pkg}") for pkg in tu.PACKAGES}
    assert got[PORT][0] == got[JAX][0] == data
    assert got[PORT][1:3] == got[JAX][1:3] == (len(data), 4)
    assert got[PORT][3] and got[JAX][3]
    assert back[PORT] == back[JAX] == data[:5000]
