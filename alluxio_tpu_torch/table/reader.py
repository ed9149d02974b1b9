"""Column-projection Parquet reads through the caching data plane (a copy
of ``alluxio_tpu/table/reader.py``).

Two read paths (``docs/table_reads.md``):

**Planned** (default, ``atpu.user.table.pushdown.enabled``): the
footer/range planner (``table/plan.py``) turns the projection into
per-row-group byte ranges, the range executor
(``FileInStream.pread_ranges``) routes them down the ``choose_route``
ladder in bulk (SHM zero-copy / ``read_many`` scatter batches / striped
reads), and a bounded two-stage pipeline keeps row group k+1's ranges
in flight while row group k decodes — decode time hides under transfer
time (the latency-hiding schedule of arxiv 2503.22643). Decode itself
stays pyarrow's: planned ranges are staged in a range cache that serves
pyarrow's own reads, so the planned path is byte-identical by
construction, and any read the plan missed falls through to the stream
(counted, never wrong).

**Legacy** (conf off, no pyarrow plan, or any ``ParquetPlanError``):
pyarrow drives every byte through seek+read on ``FileInStream`` — a
serial RPC per column chunk. Kept verbatim as the fallback rung and the
bench baseline.

Reference analogue: Presto reading through the HDFS-compat client +
``LocalCacheFileInStream`` page cache; the planned path adds what
Presto's ``ParquetReader`` does on top (footer cache + coalesced range
fetches + async column prefetch).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from alluxio_tpu_torch.table import plan as _plan


def _metrics():
    from alluxio_tpu_torch.metrics import metrics

    return metrics()


class _SizedStream:
    """File-like over FileInStream with the ``size`` pyarrow probes for
    (footer-relative seeks)."""

    def __init__(self, stream, size: int) -> None:
        self._s = stream
        self._size = size
        self._closed = False

    def read(self, n: int = -1) -> bytes:
        return self._s.read(n)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._s.tell()
        elif whence == 2:
            pos += self._size
        self._s.seek(pos)
        return pos

    def tell(self) -> int:
        return self._s.tell()

    def size(self) -> int:
        return self._size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    @property
    def closed(self) -> bool:  # pyarrow probes this attribute-style
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._s.close()

    def flush(self) -> None:
        pass


class _RangeCachedFile:
    """File-like that serves pyarrow from staged range buffers.

    The pipeline installs each row group's planned (coalesced) reads
    here before handing the row group to pyarrow; pyarrow's seek+read
    stream then hits the buffers instead of the wire. Reads the plan
    did not cover fall through to the underlying ``FileInStream``
    (``Client.TableProjectionPlanMisses``) — a miss costs a round trip,
    never correctness. ``lock`` serializes that fallback against the
    fetch thread, because ``FileInStream`` is not thread-safe."""

    def __init__(self, stream, size: int, lock) -> None:
        self._s = stream
        self._size = size
        self._lock = lock
        self._pos = 0
        self._closed = False
        self._starts: List[int] = []       # sorted buffer start offsets
        self._bufs: Dict[int, object] = {}  # start offset -> buffer

    # -- staging -------------------------------------------------------------
    def install(self, offset: int, buf) -> None:
        if offset not in self._bufs:
            bisect.insort(self._starts, offset)
        self._bufs[offset] = buf

    def drop(self, offsets: Sequence[int]) -> None:
        """Release a decoded row group's buffers (bounds pipeline
        memory to ~depth row groups of projected bytes)."""
        for off in offsets:
            if off in self._bufs:
                del self._bufs[off]
                del self._starts[bisect.bisect_left(self._starts, off)]

    def _cached(self, pos: int, n: int):
        """The longest staged prefix of [pos, pos+n), or None."""
        i = bisect.bisect_right(self._starts, pos) - 1
        if i < 0:
            return None
        off = self._starts[i]
        buf = self._bufs[off]
        rel = pos - off
        if rel >= len(buf):
            return None
        return buf[rel:rel + n] if rel or n < len(buf) else buf

    # -- file protocol -------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        chunks = []
        while n > 0:
            got = self._cached(self._pos, n)
            if got is None:
                # miss: fetch only up to the next staged buffer so a
                # short gap doesn't shadow staged bytes behind it
                j = bisect.bisect_right(self._starts, self._pos)
                take = n if j >= len(self._starts) else \
                    min(n, self._starts[j] - self._pos)
                _metrics().counter(
                    "Client.TableProjectionPlanMisses").inc()
                with self._lock:
                    got = self._s.pread(self._pos, take)
                if not got:
                    break
            chunks.append(got)
            self._pos += len(got)
            n -= len(got)
        if len(chunks) == 1 and isinstance(chunks[0], bytes):
            return chunks[0]
        return b"".join(chunks)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self._size
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        # pyarrow closes its source when a ParquetFile is collected; the
        # owning reader closes the underlying stream itself
        self._closed = True

    def flush(self) -> None:
        pass


#: process-wide fetch pool shared by every planned read: transfer
#: stages are short and lock-serialized per file, and reusing warm
#: threads keeps the per-read pipeline cost at two submits instead of
#: a thread spawn (the 4-reader fan-out in ``read_columns`` still gets
#: per-file concurrency — fetches from different files interleave)
_FETCH_POOL: Optional[ThreadPoolExecutor] = None
_FETCH_POOL_LOCK = threading.Lock()


def _fetch_pool() -> ThreadPoolExecutor:
    global _FETCH_POOL
    pool = _FETCH_POOL
    if pool is None:
        with _FETCH_POOL_LOCK:
            pool = _FETCH_POOL
            if pool is None:
                pool = _FETCH_POOL = ThreadPoolExecutor(
                    max_workers=4,
                    thread_name_prefix="atpu-table-fetch")
    return pool


def _pread_ranges(stream, ranges, route_stats):
    """Range-list read with graceful degradation: ``pread_ranges`` when
    the stream has it (FileInStream), else per-range ``pread`` (e.g. the
    page-cache wrapper) — the plan and pipeline still apply."""
    fn = getattr(stream, "pread_ranges", None)
    if fn is not None:
        return fn(ranges, route_stats=route_stats)
    out = []
    for off, n in ranges:
        buf = stream.pread(off, n)
        out.append(buf)
        if route_stats is not None:
            route_stats["stream"] = route_stats.get("stream", 0) + len(buf)
    return out


class _PlannedRead:
    """One file's planned projection read: footer -> range plan ->
    pipelined fetch/decode.

    A single fetch thread keeps up to ``depth`` row groups' ranges in
    flight (``atpu.user.table.pipeline.depth``) while the caller thread
    decodes — the two-stage bounded pipeline of the tentpole. Teardown
    is unconditional: any mid-read error drains the executor and closes
    the stream before propagating."""

    def __init__(self, fs, path: str, columns: Optional[Sequence[str]],
                 conf) -> None:
        from alluxio_tpu_torch.conf import Keys

        self._fs = fs
        self._path = path
        self._columns = list(columns) if columns is not None else None
        self._depth = max(1, conf.get_int(Keys.USER_TABLE_PIPELINE_DEPTH))
        self._slack = max(0, conf.get_bytes(
            Keys.USER_TABLE_COALESCE_SLACK_BYTES))
        self._footer_guess = max(_plan._TAIL_FIXED, conf.get_bytes(
            Keys.USER_TABLE_FOOTER_READ_BYTES))
        self._cache_max = conf.get_int(Keys.USER_TABLE_FOOTER_CACHE_MAX)

    def run(self):
        """Execute the planned read; raises ``ParquetPlanError`` (before
        any partial decode) when the file cannot be planned."""
        import pyarrow.parquet as pq

        from alluxio_tpu_torch.utils.tracing import tracer

        m = _metrics()
        with tracer().span("atpu.client.table_read",
                           path=self._path) as sp:
            t_plan0 = time.perf_counter()
            info = self._fs.get_status(self._path)
            stream = self._fs.open_file(self._path, info=info)
            lock = threading.Lock()
            try:
                footer = _plan.cached_footer(
                    stream.pread, self._path, info,
                    guess_bytes=self._footer_guess,
                    cache_max=self._cache_max)
                plans = _plan.cached_plan(
                    self._path, info, footer.metadata, self._columns,
                    slack=self._slack, cache_max=self._cache_max)
                m.counter("Client.TableProjectionRanges").inc(
                    sum(len(p.ranges) for p in plans))
                m.counter("Client.TableProjectionRangesCoalesced").inc(
                    sum(len(p.reads) for p in plans))
                m.counter("Client.TableProjectionBytes").inc(
                    sum(p.projected_bytes for p in plans))
                src = _RangeCachedFile(stream, info.length, lock)
                src.install(footer.tail_offset, footer.tail)
                # hand the cached FileMetaData over: construction skips
                # the (already-done) footer re-parse
                pf = pq.ParquetFile(src, metadata=footer.metadata)
                if sp is not None:
                    sp.phase("table_plan",
                             (time.perf_counter() - t_plan0) * 1000.0)
                if not plans:
                    return pf.read(columns=self._columns)
                return self._pipeline(pf, src, stream, lock, plans, sp, m)
            finally:
                stream.close()

    def _pipeline(self, pf, src, stream, lock, plans, sp, m):
        import pyarrow as pa

        route_stats: Dict[str, int] = {}

        def fetch(p):
            with lock:
                bufs = _pread_ranges(stream, p.reads, route_stats)
            for (off, _n), buf in zip(p.reads, bufs):
                src.install(off, buf)
            return p

        parts = []
        decode_ms = 0.0
        overlap_ms = 0.0
        pending = deque(plans)
        inflight: "deque" = deque()
        pool = _fetch_pool()
        try:
            while pending and len(inflight) < self._depth:
                inflight.append(pool.submit(fetch, pending.popleft()))
            while inflight:
                ready = [inflight.popleft().result()]
                # drain every other fetch that already landed: decoding
                # ready row groups in ONE read_row_groups call amortizes
                # pyarrow's per-call setup, while a transfer-bound read
                # still decodes groups one by one as each lands
                while inflight and inflight[0].done():
                    ready.append(inflight.popleft().result())
                while pending and len(inflight) < self._depth:
                    inflight.append(pool.submit(fetch, pending.popleft()))
                overlapped = bool(inflight)
                t0 = time.perf_counter()
                parts.append(pf.read_row_groups(
                    [p.index for p in ready], columns=self._columns))
                d = (time.perf_counter() - t0) * 1000.0
                decode_ms += d
                if overlapped:
                    overlap_ms += d
                src.drop([off for p in ready for off, _n in p.reads])
        finally:
            # teardown on mid-read error: every in-flight fetch must
            # finish or cancel before the stream under it closes (the
            # pool is shared, so wait on the futures, not the pool)
            for f in inflight:
                if not f.cancel():
                    try:
                        f.result()
                    except Exception:  # noqa: BLE001 - original wins
                        pass
            if sp is not None:
                sp.phase("table_decode", decode_ms)
            m.counter("Client.TableDecodeOverlapMs").inc(int(overlap_ms))
            for route, nbytes in route_stats.items():
                m.counter(
                    f"Client.TableProjectionRouteBytes.{route}"
                ).inc(nbytes)
        return parts[0] if len(parts) == 1 else pa.concat_tables(parts)


def open_parquet(fs, path: str):
    """ParquetFile over the caching FS client (the legacy/unplanned
    entry point — pyarrow drives every range itself)."""
    import pyarrow.parquet as pq

    info = fs.get_status(path)
    return pq.ParquetFile(_SizedStream(fs.open_file(path), info.length))


def _read_one_legacy(fs, path: str, columns):
    return open_parquet(fs, path).read(columns=columns)


def _pushdown_conf(fs):
    """The client conf when pushdown is on, else None (legacy path).
    Fakes/wrappers without a ``conf`` attribute read legacy."""
    conf = getattr(fs, "conf", None)
    if conf is None:
        return None
    from alluxio_tpu_torch.conf import Keys

    return conf if conf.get_bool(Keys.USER_TABLE_PUSHDOWN_ENABLED) \
        else None


def _read_one(fs, path: str, columns, conf):
    if conf is not None:
        try:
            return _PlannedRead(fs, path, columns, conf).run()
        except _plan.ParquetPlanError:
            # unplannable file: the legacy path surfaces the canonical
            # pyarrow error (or succeeds, e.g. exotic footers)
            pass
    return _read_one_legacy(fs, path, columns)


def read_columns(fs, paths: Sequence[str],
                 columns: Optional[List[str]] = None):
    """Read (a projection of) one or more Parquet files into a single
    pyarrow Table. ``columns=None`` reads everything.

    Multi-file reads fan out over a bounded executor
    (``atpu.user.table.read.parallelism``) so partition-spanning
    projections overlap their footer fetches and transfers instead of
    running file-serial."""
    import pyarrow as pa

    paths = list(paths)
    conf = _pushdown_conf(fs)
    fanout = 1
    if conf is not None:
        from alluxio_tpu_torch.conf import Keys

        fanout = max(1, conf.get_int(Keys.USER_TABLE_READ_PARALLELISM))
    if len(paths) > 1 and fanout > 1:
        with ThreadPoolExecutor(
                max_workers=min(fanout, len(paths)),
                thread_name_prefix="atpu-table-file") as pool:
            tables = list(pool.map(
                lambda p: _read_one(fs, p, columns, conf), paths))
    else:
        tables = [_read_one(fs, p, columns, conf) for p in paths]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


def read_partition_columns(fs, table_wire: dict, *,
                           columns: Optional[List[str]] = None,
                           partition_filter=None):
    """Projection over a catalog table's partitions.

    ``partition_filter(values: dict) -> bool`` prunes partitions before
    any IO (the catalog's partition pruning); returns a pyarrow Table.
    """
    paths: List[str] = []
    for part in table_wire["partitions"]:
        if partition_filter is not None and \
                not partition_filter(part.get("values", {})):
            continue
        for info in fs.list_status(part["location"]):
            if not info.folder and info.name.endswith(".parquet"):
                paths.append(f"{part['location']}/{info.name}")
    if not paths:
        import pyarrow as pa

        return pa.table({})
    return read_columns(fs, paths, columns=columns)
