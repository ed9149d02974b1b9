"""The port's projection-pushdown read path (``alluxio_tpu_torch.table``),
on the CPU.

JAX's ``tests/test_table_reads.py`` scenarios run on the port: coalescing,
the footer fast path and its cache, plan content, the planned path's byte
identity against pyarrow across seeded schemas, projections and row-group
sizes, ``_RangeCachedFile``, pipeline teardown on a mid-read error, and
the port's LocalCluster. Then the two packages together, on the same
Parquet bytes in one process:

- the port's ``read_columns`` over the port's LocalCluster equals JAX's
  ``read_columns`` over JAX's LocalCluster on the same files;
- the planned path equals the legacy path equals ``table.select(proj)``;
- the port's reader over the JAX cluster's FileSystem, and JAX's reader
  over the port's, give the same tables.

The footer cache, the plan cache and the fetch pool are module singletons
of each package: every test starts with both packages' caches cleared.
"""

import importlib
import io
import threading

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu_torch.conf import Configuration, Keys  # noqa: E402
from alluxio_tpu_torch.table import plan as tplan  # noqa: E402
from alluxio_tpu_torch.table import reader as treader  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------- harness
class FakeStream:
    """In-memory stand-in for FileInStream (pread/read/seek/tell)."""

    def __init__(self, data: bytes, counts=None) -> None:
        self._d = data
        self._pos = 0
        self.counts = counts if counts is not None else {}

    def pread(self, off: int, n: int) -> bytes:
        self.counts["preads"] = self.counts.get("preads", 0) + 1
        return self._d[off:off + n]

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._d) - self._pos
        out = self._d[self._pos:self._pos + n]
        self._pos += len(out)
        self.counts["reads"] = self.counts.get("reads", 0) + 1
        return out

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        pass


class FakeInfo:
    def __init__(self, length: int, file_id: int = 1,
                 mtime: int = 1000) -> None:
        self.length = length
        self.file_id = file_id
        self.last_modification_time_ms = mtime
        self.folder = False


class FakeFs:
    def __init__(self, files: dict, conf=None) -> None:
        self._files = files
        self.conf = conf if conf is not None else Configuration()
        self.counts = {}

    def get_status(self, path: str) -> FakeInfo:
        return FakeInfo(len(self._files[path]), file_id=hash(path) & 0xFF)

    def open_file(self, path: str, **kw) -> FakeStream:
        return FakeStream(self._files[path], self.counts)


def _legacy_conf():
    return Configuration({Keys.USER_TABLE_PUSHDOWN_ENABLED: "false"})


def _table(rng, rows: int, num_cols: int, str_cols: int):
    cols = {}
    for i in range(num_cols):
        cols[f"c{i}"] = rng.integers(0, 1 << 20, size=rows,
                                     dtype=np.int64)
    for i in range(str_cols):
        cols[f"s{i}"] = [f"v{i}-{j % 37}" for j in range(rows)]
    return pa.table(cols)


def _parquet(table, row_group_size: int, compression="none") -> bytes:
    sink = io.BytesIO()
    pq.write_table(table, sink, row_group_size=row_group_size,
                   compression=compression)
    return sink.getvalue()


@pytest.fixture(autouse=True)
def _fresh_caches():
    for pkg in PACKAGES:
        plan = _mod(pkg, "table.plan")
        plan.footer_cache().clear()
        plan._PLAN_CACHE.clear()
    yield


# ------------------------------------------------------------- coalescing
class TestCoalesce:
    def test_gap_merge_under_slack(self):
        assert tplan.coalesce([(0, 10), (15, 10)], slack=5) == [(0, 25)]

    def test_slack_boundary_not_crossed(self):
        assert tplan.coalesce([(0, 10), (16, 10)], slack=5) == \
            [(0, 10), (16, 10)]

    def test_zero_slack_merges_only_touching(self):
        assert tplan.coalesce([(0, 10), (10, 5), (21, 4)]) == \
            [(0, 15), (21, 4)]

    def test_overlapping_ranges_merge(self):
        assert tplan.coalesce([(0, 20), (10, 5), (12, 30)]) == [(0, 42)]

    def test_unsorted_input_and_empties(self):
        assert tplan.coalesce([(30, 4), (0, 10), (5, 0)], slack=0) == \
            [(0, 10), (30, 4)]

    def test_contained_range_keeps_outer_length(self):
        assert tplan.coalesce([(0, 100), (10, 5)]) == [(0, 100)]


# ------------------------------------------------------------ footer path
class TestFooter:
    def test_single_tail_read_when_footer_fits(self):
        t = _table(np.random.default_rng(0), 1000, 4, 1)
        data = _parquet(t, 500)
        calls = []

        def pread(off, n):
            calls.append((off, n))
            return data[off:off + n]

        f = tplan.read_footer(pread, len(data))
        assert len(calls) == 1
        assert f.metadata.num_rows == 1000
        assert f.tail_offset + len(f.tail) == len(data)

    def test_second_exact_read_when_footer_outgrows_guess(self):
        t = _table(np.random.default_rng(0), 100, 40, 4)
        data = _parquet(t, 10)
        calls = []

        def pread(off, n):
            calls.append((off, n))
            return data[off:off + n]

        f = tplan.read_footer(pread, len(data), guess_bytes=256)
        assert len(calls) == 2
        footer_len = int.from_bytes(data[-8:-4], "little")
        assert calls[1] == (len(data) - footer_len - 8, footer_len + 8)
        assert f.metadata.num_columns == 44

    def test_not_parquet_raises_plan_error(self):
        junk = b"x" * 64
        with pytest.raises(tplan.ParquetPlanError):
            tplan.read_footer(lambda o, n: junk[o:o + n], len(junk))

    def test_too_short_raises_plan_error(self):
        with pytest.raises(tplan.ParquetPlanError):
            tplan.read_footer(lambda o, n: b"", 4)

    def test_cache_hits_on_same_version_misses_on_new(self):
        t = _table(np.random.default_rng(0), 200, 3, 0)
        data = _parquet(t, 100)
        info = FakeInfo(len(data))
        reads = []

        def pread(off, n):
            reads.append(n)
            return data[off:off + n]

        f1 = tplan.cached_footer(pread, "/p", info)
        f2 = tplan.cached_footer(pread, "/p", info)
        assert f1 is f2 and len(reads) == 1
        tplan.cached_footer(pread, "/p", FakeInfo(len(data), mtime=2000))
        assert len(reads) == 2

    def test_cache_capacity_bounded(self):
        c = tplan.FooterCache(max_entries=2)
        for i in range(5):
            c.put((i,), object())
        assert c.size() == 2


# ----------------------------------------------------------- plan content
class TestPlan:
    def test_ranges_cover_exactly_projected_chunks(self):
        t = _table(np.random.default_rng(1), 3000, 5, 2)
        md = pq.read_metadata(pa.BufferReader(_parquet(t, 1000)))
        plans = tplan.plan_row_groups(md, ["c1", "s0"])
        assert len(plans) == 3
        for p in plans:
            assert sorted(r.column for r in p.ranges) == ["c1", "s0"]
            assert p.projected_bytes == sum(r.length for r in p.ranges)
            for r in p.ranges:
                assert any(off <= r.offset and
                           r.offset + r.length <= off + n
                           for off, n in p.reads)

    def test_none_projection_plans_every_column(self):
        t = _table(np.random.default_rng(1), 500, 3, 1)
        md = pq.read_metadata(pa.BufferReader(_parquet(t, 500)))
        (p,) = tplan.plan_row_groups(md, None)
        assert len(p.ranges) == 4

    def test_unknown_column_ignored_at_plan_time(self):
        t = _table(np.random.default_rng(1), 500, 3, 0)
        md = pq.read_metadata(pa.BufferReader(_parquet(t, 500)))
        (p,) = tplan.plan_row_groups(md, ["c0", "nope"])
        assert [r.column for r in p.ranges] == ["c0"]


# ------------------------------------------------- planned read identity
class TestPlannedByteIdentity:
    @pytest.mark.parametrize("seed", range(6))
    def test_property_sweep_random_schema_projection_rg(self, seed):
        rng = np.random.default_rng(seed)
        rows = int(rng.integers(100, 4000))
        num_cols = int(rng.integers(1, 12))
        str_cols = int(rng.integers(0, 4))
        rg = int(rng.integers(64, max(65, rows + 1)))
        compression = ["none", "snappy"][seed % 2]
        t = _table(rng, rows, num_cols, str_cols)
        data = _parquet(t, rg, compression=compression)
        names = t.column_names
        k = int(rng.integers(1, len(names) + 1))
        proj = list(rng.choice(names, size=k, replace=False))
        out = treader.read_columns(FakeFs({"/f": data}), ["/f"],
                                   columns=proj)
        assert out.equals(t.select(proj))

    def test_full_scan_and_multi_file_identity(self):
        rng = np.random.default_rng(7)
        t1, t2 = _table(rng, 900, 4, 1), _table(rng, 400, 4, 1)
        fs = FakeFs({"/a": _parquet(t1, 256), "/b": _parquet(t2, 256)})
        out = treader.read_columns(fs, ["/a", "/b"])
        assert out.equals(pa.concat_tables([t1, t2]))

    def test_planned_issues_fewer_preads_than_chunks(self):
        rng = np.random.default_rng(8)
        t = _table(rng, 8000, 10, 0)
        fs = FakeFs({"/f": _parquet(t, 1000)})  # 8 rgs x 10 cols
        out = treader.read_columns(fs, ["/f"],
                                   columns=["c0", "c1", "c2"])
        assert out.equals(t.select(["c0", "c1", "c2"]))
        assert fs.counts.get("preads", 0) < 24

    def test_unknown_column_matches_legacy_semantics(self):
        data = _parquet(_table(np.random.default_rng(9), 100, 2, 0), 100)
        planned = treader.read_columns(FakeFs({"/f": data}), ["/f"],
                                       columns=["missing"])
        legacy = treader.read_columns(FakeFs({"/f": data},
                                             conf=_legacy_conf()),
                                      ["/f"], columns=["missing"])
        assert planned.equals(legacy)

    def test_disabled_conf_uses_legacy_path(self):
        t = _table(np.random.default_rng(10), 500, 3, 1)
        fs = FakeFs({"/f": _parquet(t, 250)}, conf=_legacy_conf())
        out = treader.read_columns(fs, ["/f"], columns=["c1"])
        assert out.equals(t.select(["c1"]))
        assert fs.counts.get("reads", 0) > 0

    def test_non_parquet_falls_back_to_legacy_error(self):
        junk = b"not parquet at all" * 10
        with pytest.raises(Exception) as planned_err:
            treader.read_columns(FakeFs({"/junk": junk}), ["/junk"])
        with pytest.raises(Exception) as legacy_err:
            treader.read_columns(FakeFs({"/junk": junk},
                                        conf=_legacy_conf()), ["/junk"])
        assert type(planned_err.value) is type(legacy_err.value)


# ------------------------------------------------------- range-cache file
class TestRangeCachedFile:
    def test_miss_falls_through_and_counts(self):
        data = bytes(range(256)) * 16
        stream = FakeStream(data)
        src = treader._RangeCachedFile(stream, len(data),
                                       threading.Lock())
        src.install(100, data[100:200])
        src.seek(100)
        assert src.read(100) == data[100:200]
        assert stream.counts.get("preads", 0) == 0
        src.seek(0)
        assert src.read(50) == data[:50]
        assert stream.counts["preads"] == 1

    def test_miss_read_stops_at_next_staged_buffer(self):
        data = bytes(range(256)) * 4
        stream = FakeStream(data)
        src = treader._RangeCachedFile(stream, len(data),
                                       threading.Lock())
        src.install(64, data[64:128])
        src.seek(0)
        assert src.read(200) == data[:200]
        assert stream.counts["preads"] == 2  # the two gaps, not the stage

    def test_drop_releases_buffers(self):
        data = b"z" * 1024
        src = treader._RangeCachedFile(FakeStream(data), len(data),
                                       threading.Lock())
        src.install(0, data[:512])
        src.drop([0])
        src.seek(0)
        src.read(10)
        assert src._s.counts["preads"] == 1


# -------------------------------------------------------- pipeline errors
class TestPipelineTeardown:
    def test_mid_read_transfer_error_propagates_and_joins(self):
        t = _table(np.random.default_rng(11), 4000, 6, 0)
        data = _parquet(t, 500)  # 8 row groups

        class FailingStream(FakeStream):
            def __init__(self, data):
                super().__init__(data)
                self.calls = 0

            def pread(self, off, n):
                self.calls += 1
                if self.calls > 3:
                    raise RuntimeError("worker lost mid-read")
                return super().pread(off, n)

        class FailingFs(FakeFs):
            def open_file(self, path, **kw):
                return FailingStream(self._files[path])

        fs = FailingFs({"/f": data})
        before = threading.active_count()
        with pytest.raises(RuntimeError, match="worker lost"):
            treader._PlannedRead(fs, "/f", ["c0", "c1"], fs.conf).run()
        assert threading.active_count() <= before + 4
        out = treader.read_columns(FakeFs({"/f": data}), ["/f"],
                                   columns=["c0"])
        assert out.equals(t.select(["c0"]))

    def test_decode_error_does_not_hang(self):
        t = _table(np.random.default_rng(12), 2000, 4, 0)
        data = bytearray(_parquet(t, 250))
        col = pq.read_metadata(pa.BufferReader(bytes(data))) \
            .row_group(4).column(0)
        off = col.data_page_offset
        data[off + 20:off + 36] = b"\xff" * 16
        with pytest.raises(Exception):
            treader.read_columns(FakeFs({"/f": bytes(data)}), ["/f"],
                                 columns=["c0"])


# --------------------------------------------------------- minicluster e2e
def _cluster(pkg: str, base: str, **kw):
    return _mod(pkg, "minicluster").LocalCluster(base, num_workers=1, **kw)


@pytest.fixture()
def cluster(tmp_path):
    with _cluster("alluxio_tpu_torch", str(tmp_path)) as c:
        yield c


class TestMinicluster:
    def test_disabled_conf_byte_identity_e2e(self, cluster):
        fs = cluster.file_system()
        t = _table(np.random.default_rng(13), 5000, 8, 2)
        fs.write_all("/tbl/part-0.parquet", _parquet(t, 1024))
        proj = ["c2", "c5", "s1"]
        fs.conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED, True)
        planned = treader.read_columns(fs, ["/tbl/part-0.parquet"],
                                       columns=proj)
        fs.conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED, False)
        legacy = treader.read_columns(fs, ["/tbl/part-0.parquet"],
                                      columns=proj)
        fs.conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED, True)
        assert planned.equals(legacy)
        assert planned.equals(t.select(proj))
        fs.close()

    def test_planned_multi_file_e2e(self, cluster):
        fs = cluster.file_system()
        rng = np.random.default_rng(14)
        parts = [_table(rng, 1500, 5, 1) for _ in range(3)]
        for i, t in enumerate(parts):
            fs.write_all(f"/tbl2/part-{i}.parquet", _parquet(t, 512))
        out = treader.read_columns(
            fs, [f"/tbl2/part-{i}.parquet" for i in range(3)],
            columns=["c0", "s0"])
        assert out.equals(
            pa.concat_tables([t.select(["c0", "s0"]) for t in parts]))
        fs.close()


# ------------------------------------------------- the two packages together
def _files(seed: int):
    rng = np.random.default_rng(seed)
    tables = [_table(rng, int(rng.integers(800, 3000)), 6, 2)
              for _ in range(3)]
    return tables, {f"/t/part-{i}.parquet": _parquet(t, 400, "snappy")
                    for i, t in enumerate(tables)}


PROJECTIONS = (None, ["c0"], ["c3", "s1", "c1"], ["s0", "missing"])


@pytest.fixture(scope="module")
def both_clusters(tmp_path_factory):
    """One LocalCluster of each package, holding the same files."""
    tables, files = _files(21)
    out = {}
    try:
        for pkg in PACKAGES:
            c = _cluster(pkg, str(tmp_path_factory.mktemp(pkg))).start()
            fs = c.file_system()
            for path, data in files.items():
                fs.write_all(path, data)
            out[pkg] = (c, fs)
        yield tables, list(files), out
    finally:
        for c, fs in out.values():
            fs.close()
            c.stop()


def _read(pkg: str, fs, paths, columns, pushdown: bool):
    fs.conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED.name, pushdown)
    try:
        return _mod(pkg, "table.reader").read_columns(fs, paths,
                                                      columns=columns)
    finally:
        fs.conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED.name, True)


@pytest.mark.parametrize("columns", PROJECTIONS, ids=repr)
def test_port_cluster_reads_equal_jax_cluster_reads(both_clusters, columns):
    """Each package's reader over its own cluster, planned and legacy,
    on the same files: all equal, and equal to pyarrow's own select."""
    tables, paths, clusters = both_clusters
    want = pa.concat_tables(
        [t if columns is None else
         t.select([c for c in columns if c in t.column_names])
         for t in tables])
    got = {(pkg, pd): _read(pkg, clusters[pkg][1], paths, columns, pd)
           for pkg in PACKAGES for pd in (True, False)}
    for key, table in got.items():
        assert table.equals(want), key


@pytest.mark.parametrize("reader,cluster_pkg", [
    ("alluxio_tpu_torch", "alluxio_tpu"), ("alluxio_tpu", "alluxio_tpu_torch")])
def test_reader_over_the_other_packages_file_system(both_clusters, reader,
                                                    cluster_pkg):
    tables, paths, clusters = both_clusters
    fs = clusters[cluster_pkg][1]
    proj = ["c2", "s0"]
    want = pa.concat_tables([t.select(proj) for t in tables])
    for pd in (True, False):
        assert _read(reader, fs, paths, proj, pd).equals(want)
    assert _read(reader, fs, paths[:1], None, True).equals(tables[0])


def test_partition_columns_equal_across_packages(both_clusters):
    """``read_partition_columns`` over the same catalog wire dict, with a
    partition filter, in both packages."""
    tables, paths, clusters = both_clusters
    wire = {"partitions": [{"spec": "", "location": "/t", "values": {}}]}
    got = [_mod(pkg, "table.reader").read_partition_columns(
        clusters[pkg][1], wire, columns=["c4"],
        partition_filter=lambda v: True) for pkg in PACKAGES]
    assert got[0].equals(got[1])
    assert got[1].num_rows == sum(t.num_rows for t in tables)
    none = [_mod(pkg, "table.reader").read_partition_columns(
        clusters[pkg][1], wire, partition_filter=lambda v: False)
        for pkg in PACKAGES]
    assert none[0].equals(none[1]) and none[1].num_rows == 0
