"""Parquet footer/range planner: projection pushdown v2 (a copy of
``alluxio_tpu/table/plan.py``; design in ``docs/table_reads.md``).

The legacy table read path hands a ``FileInStream`` to pyarrow and lets
it drive every byte through seek+read — a serial RPC per column chunk,
blind to the scatter/gather, SHM, and striped planes the small-read
stack already has. This module is the other half of the fix: parse the
footer ONCE (one tail-range read instead of pyarrow's probe-seek
sequence, LRU-cached keyed on path + metadata version), and emit, per
row group, the exact column-chunk byte ranges of a projection — a plan
the range executor (``client/streams.py:FileInStream.pread_ranges``)
can route down the ``choose_route`` ladder in bulk.

Reference analogues: Presto's ``ParquetReader`` footer cache + Arrow's
``pre_buffer`` range coalescing (arxiv 2503.22643's latency-hiding
pipeline plans transfers the same way: ranges first, decode overlapped
behind them).

Coalescing: adjacent ranges whose gap is at or under
``atpu.user.table.coalesce.slack.bytes`` merge into one read — the
dropped gap bytes buy fewer round trips. Every consumer slices the
original ranges back out of the merged buffer, so coalescing is
invisible above the transfer layer.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

#: footer-length trailer + magic, the fixed Parquet tail
_TAIL_FIXED = 8
_MAGIC = b"PAR1"


class ParquetPlanError(Exception):
    """The file cannot be footer-planned (not Parquet / truncated /
    encrypted footer); the reader falls back to the legacy pyarrow-driven
    path, which surfaces its own (identical) error if the file is bad."""


class ColumnRange(NamedTuple):
    """One planned column-chunk byte range inside a row group."""

    column: str
    offset: int
    length: int


class RowGroupPlan(NamedTuple):
    """The projection's exact byte ranges for one row group, plus the
    coalesced read list the transfer layer executes."""

    index: int
    num_rows: int
    #: per-column exact ranges (pre-coalesce, for accounting/tests)
    ranges: List[ColumnRange]
    #: gap-merged (offset, length) reads, ascending, non-overlapping
    reads: List[Tuple[int, int]]
    #: exact projected bytes (sum of ranges, excludes coalescing slack)
    projected_bytes: int


class Footer(NamedTuple):
    """A parsed footer plus the raw tail bytes it came from — the tail
    is pre-seeded into the range cache so pyarrow's own footer
    probe-seeks never touch the wire again."""

    metadata: object  # pyarrow.parquet.FileMetaData
    tail: bytes
    tail_offset: int


def _metrics():
    from alluxio_tpu_torch.metrics import metrics

    return metrics()


class FooterCache:
    """Bounded LRU of parsed footers keyed on (path, metadata version)
    — also reused, with richer keys, for derived row-group plans.

    The version rides the same fields the client metadata cache
    serves coherently (file id, length, mtime): a rewritten or
    re-transformed file changes them and naturally misses, while a warm
    projection re-plans with zero footer I/O."""

    def __init__(self, max_entries: int = 256) -> None:
        self._max = max(1, int(max_entries))
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()

    def configure(self, max_entries: int) -> None:
        with self._lock:
            self._max = max(1, int(max_entries))
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def get(self, key: tuple):
        with self._lock:
            f = self._entries.get(key)
            if f is not None:
                self._entries.move_to_end(key)
            return f

    def put(self, key: tuple, footer) -> None:
        with self._lock:
            self._entries[key] = footer
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._entries)


#: process-wide footer cache (capacity re-applied from conf at each
#: planned open — cheap, and keeps the module import-light)
_FOOTER_CACHE = FooterCache()


def footer_cache() -> FooterCache:
    return _FOOTER_CACHE


def metadata_version(info) -> tuple:
    """The (file_id, length, mtime) stamp a footer cache entry is keyed
    on — the fields the client metadata cache keeps heartbeat-coherent."""
    return (info.file_id, info.length, info.last_modification_time_ms)


def read_footer(pread, length: int, *, guess_bytes: int = 64 << 10
                ) -> Footer:
    """Fetch + parse a Parquet footer with at most two range reads:
    one ``guess_bytes`` tail read (vs pyarrow's probe-seek sequence of
    tiny reads), and — only when the footer outgrows the guess — one
    exact re-read sized from the footer-length trailer.

    ``pread(offset, n) -> bytes`` is the only transport dependency, so
    the planner runs over a FileInStream, a raw file, or a test stub."""
    if length < _TAIL_FIXED:
        raise ParquetPlanError(f"file too short for a Parquet tail "
                               f"({length} bytes)")
    m = _metrics()
    tail_off = max(0, length - max(_TAIL_FIXED, int(guess_bytes)))
    tail = pread(tail_off, length - tail_off)
    m.counter("Client.TableFooterReads").inc()
    if len(tail) < _TAIL_FIXED or tail[-4:] != _MAGIC:
        raise ParquetPlanError("missing PAR1 magic (not a Parquet file?)")
    footer_len = int.from_bytes(tail[-8:-4], "little")
    need = footer_len + _TAIL_FIXED
    if need > length:
        raise ParquetPlanError(
            f"footer length {footer_len} exceeds file ({length} bytes)")
    if need > len(tail):
        tail_off = length - need
        tail = pread(tail_off, need)
        m.counter("Client.TableFooterReads").inc()
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        # BufferReader over the tail: footer parsing only touches the
        # end of the file, and every offset inside the decoded metadata
        # is absolute, so the truncated view parses identically
        md = pq.read_metadata(pa.BufferReader(tail))
    except ParquetPlanError:
        raise
    except Exception as e:  # noqa: BLE001 - fall back to the legacy path
        raise ParquetPlanError(f"footer parse failed: {e}") from e
    return Footer(metadata=md, tail=bytes(tail), tail_offset=tail_off)


def cached_footer(pread, path: str, info, *, guess_bytes: int = 64 << 10,
                  cache_max: int = 256) -> Footer:
    """The LRU-cached form of :func:`read_footer`."""
    cache = _FOOTER_CACHE
    cache.configure(cache_max)
    key = (path, metadata_version(info))
    hit = cache.get(key)
    if hit is not None:
        _metrics().counter("Client.TableFooterCacheHits").inc()
        return hit
    footer = read_footer(pread, info.length, guess_bytes=guess_bytes)
    cache.put(key, footer)
    return footer


def _chunk_range(col) -> Tuple[int, int]:
    """The absolute byte range of one column chunk: pages start at the
    dictionary page when present, else the first data page; the chunk
    runs ``total_compressed_size`` bytes from there."""
    start = col.data_page_offset
    dict_off = col.dictionary_page_offset
    if dict_off is not None and 0 <= dict_off < start:
        start = dict_off
    return int(start), int(col.total_compressed_size)


def coalesce(ranges: Sequence[Tuple[int, int]], *, slack: int = 0
             ) -> List[Tuple[int, int]]:
    """Merge ascending-sorted (offset, length) ranges whose gap is at
    or under ``slack`` (0 merges only touching/overlapping ranges).
    Output is ascending and non-overlapping; empty ranges are dropped."""
    merged: List[Tuple[int, int]] = []
    for off, n in sorted((r for r in ranges if r[1] > 0)):
        if merged:
            last_off, last_n = merged[-1]
            if off - (last_off + last_n) <= slack:
                merged[-1] = (last_off,
                              max(last_n, off + n - last_off))
                continue
        merged.append((off, n))
    return merged


def plan_row_groups(metadata, columns: Optional[Sequence[str]], *,
                    slack: int = 0,
                    row_groups: Optional[Sequence[int]] = None
                    ) -> List[RowGroupPlan]:
    """Per-row-group projection plan from a parsed footer.

    ``columns=None`` plans every column (a planned full scan still
    coalesces and pipelines). Column matching follows pyarrow's
    ``read(columns=...)`` semantics: a requested name selects every
    leaf whose dotted path starts at it, so nested roots project all
    their leaves. Unknown names are ignored here — pyarrow raises the
    canonical error at decode time, keeping error behavior identical
    to the legacy path."""
    wanted = None if columns is None else {str(c) for c in columns}
    plans: List[RowGroupPlan] = []
    indices = range(metadata.num_row_groups) if row_groups is None \
        else row_groups
    for rg_i in indices:
        rg = metadata.row_group(rg_i)
        ranges: List[ColumnRange] = []
        for c_i in range(rg.num_columns):
            col = rg.column(c_i)
            path = col.path_in_schema
            root = path.split(".", 1)[0]
            if wanted is not None and root not in wanted \
                    and path not in wanted:
                continue
            off, n = _chunk_range(col)
            ranges.append(ColumnRange(path, off, n))
        reads = coalesce([(r.offset, r.length) for r in ranges],
                         slack=slack)
        plans.append(RowGroupPlan(
            index=rg_i, num_rows=rg.num_rows, ranges=ranges, reads=reads,
            projected_bytes=sum(r.length for r in ranges)))
    return plans


#: derived-plan LRU: planning walks the full (rg × column) metadata
#: through pyarrow property calls — noticeable per read on warm
#: repeated projections, and fully determined by (footer version,
#: projection, slack), so it caches alongside the footers
_PLAN_CACHE = FooterCache()


def cached_plan(path: str, info, metadata,
                columns: Optional[Sequence[str]], *, slack: int = 0,
                cache_max: int = 256) -> List[RowGroupPlan]:
    """The LRU-cached form of :func:`plan_row_groups`, keyed on the
    footer-cache key plus the projection and coalescing slack."""
    cache = _PLAN_CACHE
    cache.configure(cache_max)
    key = (path, metadata_version(info),
           None if columns is None else tuple(columns), int(slack))
    hit = cache.get(key)
    if hit is None:
        hit = plan_row_groups(metadata, columns, slack=slack)
        cache.put(key, hit)
    return hit
