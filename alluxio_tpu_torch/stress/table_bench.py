"""BASELINE config #4: Parquet column-projection read through the
table service (TPC-DS-style wide fact table); a copy of
``alluxio_tpu/stress/table_bench.py``.

Reference analogue: Presto projecting columns through the catalog +
caching data plane (``table/server/master/.../AlluxioCatalog.java:55``;
``LocalCacheFileInStream`` page reads). The bench writes a partitioned
Hive-layout Parquet table into the warm cache, attaches it as an ``fs``
under-database, and measures a k-of-N column projection via
``table.reader.read_partition_columns`` — reporting projection GB/s and
the byte selectivity vs a full scan.

The port differs from the reference in two ways: without pyarrow a bench
raises ``ImportError`` (the reference returns a skipped row), and it has
no ``master`` argument (the port's bench cluster runs in-process only;
``params["master"]`` says so, as the reference's does for that mode).
"""

from __future__ import annotations

import io
import sys
import time
import numpy as np

from alluxio_tpu_torch.stress.base import BenchResult
from alluxio_tpu_torch.stress.cluster import bench_cluster

# store_sales-flavored wide schema: 20 numeric + 3 string columns
_N_NUM = 20
_PROJECT = ["ss_sold_date_sk", "ss_quantity", "ss_net_paid"]


def _make_parquet(rng: np.random.Generator, rows: int) -> bytes:
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = {}
    names = [f"ss_col_{i}" for i in range(_N_NUM - 3)] + _PROJECT
    for name in names:
        cols[name] = rng.integers(0, 1 << 30, size=rows, dtype=np.int64)
    for name in ("ss_item_desc", "ss_store_name", "ss_promo"):
        base = rng.integers(0, 26, size=rows, dtype=np.uint8) + 65
        cols[name] = [chr(b) * 24 for b in base]
    table = pa.table(cols)
    buf = io.BytesIO()
    pq.write_table(table, buf, compression="none", row_group_size=8192)
    return buf.getvalue()


def _attach(cluster, base_path):
    table_master = cluster.master.table_master
    db = table_master.attach_database("fs", f"{base_path}/db")
    return table_master.get_table(db, "store_sales")


class _ModeledStream:
    """A ``FileInStream`` behind a modeled wire: every round trip costs
    one RTT plus bytes/bandwidth (the same modeled-sleep isolation the
    remote-read bench uses). Both read paths pay the identical tariff —
    the planned path just makes fewer, coalesced, pipelined trips."""

    def __init__(self, inner, rtt_s: float, bw: float) -> None:
        self._inner = inner
        self._rtt_s = rtt_s
        self._bw = bw

    def _charge(self, nbytes: int, trips: int = 1) -> None:
        time.sleep(trips * self._rtt_s + nbytes / self._bw)

    def read(self, n: int = -1) -> bytes:
        out = self._inner.read(n)
        self._charge(len(out))
        return out

    def pread(self, offset: int, n: int) -> bytes:
        out = self._inner.pread(offset, n)
        self._charge(len(out))
        return out

    def pread_ranges(self, ranges, *, route_stats=None):
        outs = self._inner.pread_ranges(ranges, route_stats=route_stats)
        # one modeled trip per coalesced range (conservative: the real
        # plane batches small ranges into single read_many RPCs)
        self._charge(sum(len(o) for o in outs), trips=max(1, len(outs)))
        return outs

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _ModeledFs:
    """FS proxy whose data streams ride :class:`_ModeledStream`."""

    def __init__(self, fs, rtt_s: float, bw: float) -> None:
        self._fs = fs
        self._rtt_s = rtt_s
        self._bw = bw

    def open_file(self, path, **kw):
        return _ModeledStream(self._fs.open_file(path, **kw),
                              self._rtt_s, self._bw)

    def __getattr__(self, name):
        return getattr(self._fs, name)


def run_pushdown(*, partitions: int = 4,
                 rows_per_partition: int = 40_000, repeats: int = 3,
                 min_speedup: float = 2.0, rtt_ms: float = 2.0,
                 conn_mbps: float = 1000.0,
                 base_path: str = "/stress-table-pd") -> BenchResult:
    """Planned vs legacy projection over the same warm table behind a
    modeled wire (``rtt_ms`` per round trip + bytes over ``conn_mbps``,
    the remote-read bench's isolation technique): the same
    ``read_partition_columns`` call with ``atpu.user.table.pushdown
    .enabled`` toggled, gated on ``min_speedup`` and on the two results
    being byte-identical (``pa.Table.equals`` — content comparison)."""
    import pyarrow  # noqa: F401 - no pyarrow, no bench: raise before set-up

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.table.reader import read_partition_columns

    rng = np.random.default_rng(1)
    with bench_cluster(block_size=32 << 20,
                       worker_mem_bytes=1 << 30) as (fs, cluster):
        total_file_bytes = 0
        for p in range(partitions):
            data = _make_parquet(rng, rows_per_partition)
            total_file_bytes += len(data)
            fs.write_all(
                f"{base_path}/db/store_sales/ss_date={2020 + p}/"
                f"part-0.parquet",
                data, write_type=WriteType.MUST_CACHE)
        table_wire = _attach(cluster, base_path)
        conf = fs.conf
        mfs = _ModeledFs(fs, rtt_ms / 1e3, conn_mbps * (1 << 20) / 8)

        def timed(enabled: bool):
            conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED, enabled)
            # warm pass: footer cache + worker-cache residency for this
            # path, excluded from timing for both sides
            out = read_partition_columns(mfs, table_wire,
                                         columns=_PROJECT)
            t0 = time.monotonic()
            for _ in range(repeats):
                out = read_partition_columns(mfs, table_wire,
                                             columns=_PROJECT)
            return out, (time.monotonic() - t0) / repeats

        legacy, legacy_wall = timed(False)
        planned, planned_wall = timed(True)
        conf.set(Keys.USER_TABLE_PUSHDOWN_ENABLED, True)

        identical = planned.equals(legacy)
        speedup = legacy_wall / planned_wall if planned_wall else 0.0
        ok = identical and speedup >= min_speedup
        if not ok:
            print(f"table-projection-pushdown FAILED gate: "
                  f"identical={identical} speedup={speedup:.2f}x vs "
                  f"{min_speedup}x gate", file=sys.stderr)
        return BenchResult(
            bench="table-projection-pushdown",
            params={"partitions": partitions,
                    "rows_per_partition": rows_per_partition,
                    "columns_projected": len(_PROJECT),
                    "repeats": repeats, "min_speedup": min_speedup,
                    "rtt_ms": rtt_ms, "conn_mbps": conn_mbps,
                    "master": "in-process"},
            metrics={
                "legacy_ms": round(legacy_wall * 1e3, 2),
                "planned_ms": round(planned_wall * 1e3, 2),
                "speedup": round(speedup, 2),
                "byte_identical": int(identical),
                "projected_mb_per_s": round(
                    planned.nbytes / planned_wall / 1e6, 2)
                if planned_wall else 0.0,
                "file_bytes": total_file_bytes},
            errors=0 if ok else 1,
            duration_s=(legacy_wall + planned_wall) * repeats)


def run(*, partitions: int = 4,
        rows_per_partition: int = 40_000, repeats: int = 3,
        min_speedup: float = 0.0,
        base_path: str = "/stress-table") -> BenchResult:
    import pyarrow  # noqa: F401 - no pyarrow, no bench: raise before set-up

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.table.reader import read_partition_columns

    rng = np.random.default_rng(0)
    with bench_cluster(block_size=32 << 20,
                       worker_mem_bytes=1 << 30) as (fs, cluster):
        total_file_bytes = 0
        for p in range(partitions):
            data = _make_parquet(rng, rows_per_partition)
            total_file_bytes += len(data)
            fs.write_all(
                f"{base_path}/db/store_sales/ss_date={2020 + p}/part-0.parquet",
                data, write_type=WriteType.MUST_CACHE)

        table_wire = _attach(cluster, base_path)

        # warm the footers + projected column chunks
        proj = read_partition_columns(fs, table_wire, columns=_PROJECT)
        proj_bytes = proj.nbytes

        t0 = time.monotonic()
        for _ in range(repeats):
            proj = read_partition_columns(fs, table_wire, columns=_PROJECT)
        proj_wall = (time.monotonic() - t0) / repeats

        t0 = time.monotonic()
        full = read_partition_columns(fs, table_wire, columns=None)
        full_wall = time.monotonic() - t0
        rows = full.num_rows

        speedup = full_wall / proj_wall if proj_wall else 0.0
        ok = rows == partitions * rows_per_partition and \
            speedup >= min_speedup
        if not ok:
            print(f"table-column-projection FAILED gate: rows={rows} "
                  f"projection_speedup={speedup:.2f}x vs "
                  f"{min_speedup}x gate", file=sys.stderr)
        return BenchResult(
            bench="table-column-projection",
            params={"partitions": partitions,
                    "rows_per_partition": rows_per_partition,
                    "columns_projected": len(_PROJECT),
                    "columns_total": len(table_wire["schema"]),
                    "min_speedup": min_speedup,
                    "master": "in-process"},
            metrics={
                "projection_mb_per_s": round(proj_bytes / proj_wall / 1e6, 2),
                "full_scan_mb_per_s": round(full.nbytes / full_wall / 1e6, 2),
                "projection_speedup": round(speedup, 2),
                "byte_selectivity": round(proj_bytes / full.nbytes, 4),
                "rows": rows, "file_bytes": total_file_bytes},
            errors=0 if ok else 1,
            duration_s=proj_wall * repeats + full_wall)
