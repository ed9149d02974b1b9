"""The port's Arrow and fsspec adapters against the JAX package's.

Mirrors JAX's ``tests/test_arrow_fs.py`` and ``tests/test_fsspec.py``: each
package's adapter runs the same seeded script over that package's own
``LocalCluster`` (one worker, 1 MiB blocks): Parquet through
``pyarrow.parquet`` and ``pyarrow.dataset``, file infos and selectors,
moves, copies and deletes, and fsspec's reads, writes, listings and
ranged reads, with pandas on top. What each call returns or raises must be
equal, modification times aside. fsspec's protocol registry is process
wide and both packages claim ``atpu``/``alluxio``: the registration test
puts the table back as it found it.
"""

from __future__ import annotations

import importlib
import io

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

from tests.test_torch_underfs_connectors import _outcomes
from tests.testutils import torch_ufs as tu
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

fsspec = pytest.importorskip("fsspec")

JAX, PORT = tu.JAX, tu.PORT
PROTOCOLS = ("atpu", "alluxio")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for pkg in tu.PACKAGES:
            lc = tu.mod(pkg, "minicluster.local_cluster")
            c = lc.LocalCluster(str(tmp_path_factory.mktemp(pkg)),
                                num_workers=1, block_size=1 << 20)
            c.start()
            out[pkg] = c
        yield out
    finally:
        for c in out.values():
            c.stop()


def _table(seed=0, n=100):
    rng = np.random.default_rng(seed)
    return pa.table({"x": rng.integers(0, 1 << 40, n),
                     "y": [f"row-{i}" for i in range(n)],
                     "z": rng.standard_normal(n).astype(np.float32)})


def _info(i):
    return (i.path, i.type.name, i.size if i.type == pafs.FileType.File
            else None)


def _arrow_script(pkg, cluster, root, trace):
    afs = tu.mod(pkg, "client.arrow_fs").arrow_file_system(
        fs=cluster.file_system())
    t = _table()
    trace("type", lambda: afs.type_name)
    trace("mkdir", afs.create_dir, f"{root}/warehouse")
    trace("write", pq.write_table, t, f"{root}/warehouse/t.parquet",
          filesystem=afs)
    trace("read", lambda: pq.read_table(f"{root}/warehouse/t.parquet",
                                        filesystem=afs).to_pydict())
    trace("project", lambda: pq.read_table(
        f"{root}/warehouse/t.parquet", filesystem=afs,
        columns=["x"]).to_pydict())
    for part in ("a", "b"):
        pq.write_table(_table(ord(part)), f"{root}/ds/{part}/part-0.parquet",
                       filesystem=afs)
    trace("dataset", lambda: pads.dataset(f"{root}/ds", filesystem=afs)
          .to_table().sort_by("x").to_pydict())
    with afs.open_output_stream(f"{root}/d/f.bin") as f:
        f.write(b"abc")
    trace("infos", lambda: [_info(i) for i in afs.get_file_info(
        [f"{root}/d", f"{root}/d/f.bin", f"{root}/missing"])])
    with afs.open_output_stream(f"{root}/sel/sub/f1") as f:
        f.write(b"1")
    trace("flat", lambda: sorted(_info(i) for i in afs.get_file_info(
        pafs.FileSelector(f"{root}/sel"))))
    trace("deep", lambda: sorted(_info(i) for i in afs.get_file_info(
        pafs.FileSelector(f"{root}/sel", recursive=True))))
    trace("allow missing", lambda: afs.get_file_info(
        pafs.FileSelector(f"{root}/nope", allow_not_found=True)))
    trace("selector missing", lambda: afs.get_file_info(
        pafs.FileSelector(f"{root}/nope")))
    with afs.open_output_stream(f"{root}/m/a") as f:
        f.write(b"payload")
    trace("move", afs.move, f"{root}/m/a", f"{root}/m/b")
    trace("copy", afs.copy_file, f"{root}/m/b", f"{root}/m/c")
    trace("copied", lambda: afs.open_input_stream(f"{root}/m/c").read())
    with afs.open_input_file(f"{root}/m/c") as f:
        f.seek(3)
        trace("seek read", f.read, 2)
    trace("delete", afs.delete_file, f"{root}/m/b")
    trace("deleted", lambda: _info(afs.get_file_info([f"{root}/m/b"])[0]))
    trace("delete again", afs.delete_file, f"{root}/m/b")
    trace("delete dir as file", afs.delete_file, f"{root}/m")
    trace("open missing", afs.open_input_file, f"{root}/nope.bin")
    trace("append", afs.open_append_stream, f"{root}/m/c")
    with afs.open_output_stream(f"atpu://host:1{root}/n/x") as f:
        f.write(b"q")
    trace("scheme", lambda: _info(afs.get_file_info([f"{root}/n/x"])[0]))
    trace("delete contents", afs.delete_dir_contents, f"{root}/sel")
    trace("emptied", lambda: afs.get_file_info(
        pafs.FileSelector(f"{root}/sel")))
    trace("delete dir", afs.delete_dir, f"{root}/sel")


def test_arrow_adapter_matches_jax(clusters):
    got = {}
    for pkg in tu.PACKAGES:
        trace = tu.Trace()
        _arrow_script(pkg, clusters[pkg], "/arrow", trace)
        got[pkg] = trace.rows
    assert got[PORT] == got[JAX]
    seen = _outcomes(got[PORT])
    assert seen["read"] == ("ok", _table().to_pydict())
    assert len(seen["dataset"][1]["x"]) == 200
    assert seen["infos"][1][1] == ("/arrow/d/f.bin", "File", 3)
    assert seen["copied"] == ("ok", b"payload")
    assert seen["open missing"][1] == "FileNotFoundError"


def _entry(e):
    return {k: v for k, v in e.items() if k != "mtime"}


def _fsspec_script(pkg, cluster, root, trace):
    afs = tu.mod(pkg, "client.fsspec_fs").AlluxioTpuFileSystem(
        fs=cluster.file_system())
    with afs.open(f"{root}/dir/a.bin", "wb") as f:
        f.write(b"hello fsspec")
    trace("cat", afs.cat_file, f"{root}/dir/a.bin")
    with afs.open(f"{root}/dir/a.bin", "rb") as f:
        trace("read 5", f.read, 5)
        f.seek(6)
        trace("read rest", f.read)
    afs.pipe_file(f"{root}/d/x", b"1")
    afs.pipe_file(f"{root}/d/y", b"22")
    trace("ls", lambda: sorted(afs.ls(f"{root}/d", detail=False)))
    trace("ls detail", lambda: sorted(
        (_entry(e) for e in afs.ls(f"{root}/d")), key=lambda e: e["name"]))
    trace("info", lambda: _entry(afs.info(f"{root}/d/y")))
    trace("info dir", lambda: _entry(afs.info(f"{root}/d")))
    trace("exists", afs.exists, f"{root}/d/x")
    trace("exists missing", afs.exists, f"{root}/nope")
    trace("info missing", afs.info, f"{root}/nope")
    trace("makedirs", afs.makedirs, f"{root}/a/b/c")
    trace("makedirs again", afs.makedirs, f"{root}/a/b/c")
    trace("makedirs ok", afs.makedirs, f"{root}/a/b/c", exist_ok=True)
    afs.pipe_file(f"{root}/a/b/c/f", b"data")
    trace("mv", afs.mv, f"{root}/a/b/c/f", f"{root}/a/b/g")
    trace("moved", afs.cat_file, f"{root}/a/b/g")
    trace("rmdir full", afs.rmdir, f"{root}/a")
    trace("rm", afs.rm, f"{root}/a", recursive=True)
    trace("rm gone", afs.exists, f"{root}/a")
    for name, data in (("a.tmp", b"1"), ("b.tmp", b"2"), ("keep.dat", b"3")):
        afs.pipe_file(f"{root}/g/{name}", data)
    trace("rm glob", afs.rm, f"{root}/g/*.tmp")
    trace("after glob", lambda: afs.ls(f"{root}/g", detail=False))
    afs.pipe_file(f"{root}/ow", b"old content")
    with afs.open(f"{root}/ow", "wb") as f:
        f.write(b"new")
    trace("overwritten", afs.cat_file, f"{root}/ow")
    afs.pipe_file(f"{root}/r", bytes(range(100)))
    trace("range", afs.cat_file, f"{root}/r", start=10, end=20)
    trace("range tail", afs.cat_file, f"{root}/r", start=-5)
    trace("bad mode", afs.open, f"{root}/r", "ab")
    data = np.random.default_rng(0).integers(
        0, 255, size=3 * (1 << 20) + 17, dtype=np.uint8).tobytes()
    with afs.open(f"{root}/big", "wb") as f:
        f.write(data)
    trace("big size", lambda: afs.info(f"{root}/big")["size"])
    with afs.open(f"{root}/big", "rb") as f:
        trace("big", lambda: f.read() == data)
    table = pa.table({"a": list(range(1000)),
                      "b": [f"s{i}" for i in range(1000)]})
    buf = io.BytesIO()
    pq.write_table(table, buf)
    afs.pipe_file(f"{root}/warehouse/t.parquet", buf.getvalue())
    trace("parquet", lambda: pq.read_table(
        f"{root.lstrip('/')}/warehouse/t.parquet",
        filesystem=afs).to_pydict() == table.to_pydict())
    with afs.open(f"{root}/out/w.parquet", "wb") as f:
        pq.write_table(pa.table({"x": [1.5, 2.5, 3.5]}), f)
    trace("parquet write", lambda: pq.read_table(
        f"{root.lstrip('/')}/out/w.parquet", filesystem=afs).to_pydict())
    pd = pytest.importorskip("pandas")
    afs.pipe_file(f"{root}/csv/data.csv", b"a,b\n1,x\n2,y\n")
    with afs.open(f"{root}/csv/data.csv", "rb") as f:
        trace("pandas", lambda: pd.read_csv(f).to_dict("list"))
    afs.close()


def test_fsspec_adapter_matches_jax(clusters):
    got = {}
    for pkg in tu.PACKAGES:
        trace = tu.Trace()
        _fsspec_script(pkg, clusters[pkg], "/fss", trace)
        got[pkg] = trace.rows
    assert got[PORT] == got[JAX]
    seen = _outcomes(got[PORT])
    assert seen["read rest"] == ("ok", b"fsspec")
    assert seen["ls"] == ("ok", ["fss/d/x", "fss/d/y"])
    assert seen["info missing"][1] == "FileNotFoundError"
    assert seen["after glob"] == ("ok", ["fss/g/keep.dat"])
    assert seen["range"] == ("ok", bytes(range(10, 20)))
    assert seen["big"] == ("ok", True) and seen["parquet"] == ("ok", True)
    assert seen["pandas"] == ("ok", {"a": [1, 2], "b": ["x", "y"]})


@pytest.fixture()
def fsspec_registry():
    """fsspec's protocol table as it was, put back after the test."""
    registry = importlib.import_module("fsspec.registry")
    saved = {p: registry._registry.get(p) for p in PROTOCOLS}
    yield
    for p, cls in saved.items():
        if cls is None:
            registry._registry.pop(p, None)
        else:
            registry.register_implementation(p, cls, clobber=True)


def test_registered_protocol_url_reaches_the_port(clusters, fsspec_registry):
    """After the port's ``register()``, even over JAX's, ``atpu://`` and
    ``alluxio://`` resolve to the port's class, and a URL opened through
    fsspec reads and writes the port's cluster."""
    tu.mod(JAX, "client.fsspec_fs").register()
    port = tu.mod(PORT, "client.fsspec_fs")
    port.register()
    for p in PROTOCOLS:
        assert fsspec.get_filesystem_class(p) is port.AlluxioTpuFileSystem
    addr = clusters[PORT].master.address
    with fsspec.open("atpu:///u/f.txt", "wb", master=addr) as f:
        f.write(b"via url")
    with fsspec.open("alluxio:///u/f.txt", "rb", master=addr) as f:
        assert f.read() == b"via url"
    fs = clusters[PORT].file_system()
    assert fs.read_all("/u/f.txt") == b"via url"
    fs.close()


def test_adapter_classes_are_the_port_own(clusters):
    port_fs = clusters[PORT].file_system()
    afs = tu.mod(PORT, "client.fsspec_fs").AlluxioTpuFileSystem(fs=port_fs)
    assert type(afs).__module__ == "alluxio_tpu_torch.client.fsspec_fs"
    assert afs.protocol == ("atpu", "alluxio") and not afs.cachable
    arrow = tu.mod(PORT, "client.arrow_fs").arrow_file_system(fs=port_fs)
    assert type(arrow.handler).__module__ == \
        "alluxio_tpu_torch.client.arrow_fs"
    port_fs.close()
