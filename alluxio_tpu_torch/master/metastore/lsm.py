"""``LsmInodeStore`` — log-structured merge-tree inode + edge store, a
copy of ``alluxio_tpu/master/metastore/lsm.py``.

The capacity backend (reference: ``rocks/RocksInodeStore.java`` — the
reference gets a billion-inode namespace by putting metadata behind
RocksDB; this is the same shape built on the stdlib):

- every mutation appends to a CRC-framed WAL (``wal.py``) and lands in a
  sorted in-memory **memtable** (a dict; sorted once, at seal time);
- when the memtable passes ``memtable_bytes`` it is sealed into an
  immutable **sorted run** (``sstable.py``: sparse index + bloom filter)
  and the WAL truncated;
- a background thread runs **size-tiered compaction**: ≥
  ``max_runs_per_tier`` adjacent runs of the same size tier merge
  (streaming) into one; newest value wins, tombstones dropped only when
  the oldest run is in the merge (else deletes would resurrect);
- reads check memtable → runs newest-first, bloom filters short-circuit
  the runs that can't hold the key; ``children()`` is a k-way merge of
  range scans over the ``(parent_id, name)``-ordered edge keyspace.

RAM cost is memtable + per-run index/bloom — the namespace itself lives
on disk under ``atpu.master.metastore.dir`` (the
``metadata-lsm-capacity`` bench row walks 10M inodes under an RSS cap
that OOMs the heap store).

Run ordering is held in a ``MANIFEST`` (atomic tmp+rename, newest
first); recovery = read manifest, open runs, replay the WAL tail into
the memtable.  ``checkpoint_state`` seals the memtable and captures the
run set, so a journal checkpoint of an LSM namespace is "sealed runs +
WAL position (empty)" rather than a million-entry inode dump.

Concurrency: point ops serialize on one RLock (cheap — they are dict
hits or single preads).  Range scans snapshot the memtable slice + run
list up front and then stream OUTSIDE the lock; each scanned run carries
a refcount so a compaction can retire it safely mid-scan (the file is
unlinked, the fd stays open until the last scan finishes).
"""

from __future__ import annotations

import heapq
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import msgpack

from alluxio_tpu_torch.master.inode import Inode
from alluxio_tpu_torch.master.metastore import encoding as enc
from alluxio_tpu_torch.master.metastore.base import InodeStore
from alluxio_tpu_torch.master.metastore.sstable import (
    MISSING, SortedRun, write_run)
from alluxio_tpu_torch.master.metastore.wal import WriteAheadLog

_MANIFEST = "MANIFEST"
_WAL = "wal.log"
_INODE_SCAN_END = enc.INODE_PREFIX + b"\xff" * 9


class LsmInodeStore(InodeStore):
    def __init__(self, directory: str, *,
                 memtable_bytes: int = 8 << 20,
                 max_runs_per_tier: int = 4,
                 bloom_bits_per_key: int = 10,
                 wal_sync: bool = False,
                 compaction: bool = True,
                 compaction_poll_s: float = 0.05) -> None:
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        # floor keeps a misconfigured limit from flushing every write,
        # while staying small enough that tests can force real flushes
        self._memtable_limit = max(1 << 12, memtable_bytes)
        self._max_runs_per_tier = max(2, max_runs_per_tier)
        self._bits_per_key = bloom_bits_per_key
        self._lock = threading.RLock()
        self._compact_mutex = threading.Lock()
        self._memtable: Dict[bytes, Optional[bytes]] = {}
        self._memtable_size = 0
        self._runs: List[SortedRun] = []  # newest first
        self._next_run_seq = 0
        self._inode_count = 0
        self._closed = False
        # counters surfaced through stats() -> Master.Metastore* gauges
        self._flushes = 0
        self._compactions = 0
        self._compaction_bytes = 0
        self._wal = WriteAheadLog(os.path.join(directory, _WAL),
                                  sync=wal_sync)
        #: WAL records replayed at open — the recovery point, asserted by
        #: the kill-and-recover property test
        self.recovered_wal_records = 0
        self._recover()
        self._stop = threading.Event()
        self._compactor: Optional[threading.Thread] = None
        if compaction:
            self._compactor = threading.Thread(
                target=self._compaction_loop, args=(compaction_poll_s,),
                name="lsm-compaction", daemon=True)
            self._compactor.start()

    # ---------------------------------------------------------- recovery
    def _manifest_path(self) -> str:
        return os.path.join(self._dir, _MANIFEST)

    def _write_manifest_locked(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(
                [os.path.basename(r.path) for r in self._runs],
                use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    @staticmethod
    def _run_seq(name: str) -> int:
        return int(name.split("-")[1].split(".")[0])

    def _recover(self) -> None:
        try:
            with open(self._manifest_path(), "rb") as f:
                names = msgpack.unpackb(f.read(), raw=False)
        except FileNotFoundError:
            names = []
        for name in names:
            path = os.path.join(self._dir, name)
            if os.path.exists(path):
                self._runs.append(SortedRun(path))
            self._next_run_seq = max(self._next_run_seq,
                                     self._run_seq(name) + 1)
        for key, value in self._wal.replay():
            self._memtable[key] = value
            self._memtable_size += len(key) + len(value or b"") + 16
            self.recovered_wal_records += 1
        if self._runs or self._memtable:
            self._inode_count = sum(
                1 for _ in self._iter_merged(enc.INODE_PREFIX,
                                             _INODE_SCAN_END))

    # ------------------------------------------------------- write path
    def _write_locked(self, key: bytes, value: Optional[bytes]) -> None:
        self._wal.append(key, value)
        self._memtable[key] = value
        self._memtable_size += len(key) + len(value or b"") + 16
        if self._memtable_size >= self._memtable_limit:
            self._flush_memtable_locked()

    def _flush_memtable_locked(self) -> None:
        if not self._memtable:
            return
        path = os.path.join(self._dir,
                            f"run-{self._next_run_seq:012d}.sst")
        self._next_run_seq += 1
        write_run(path, sorted(self._memtable.items()),
                  bits_per_key=self._bits_per_key)
        self._runs.insert(0, SortedRun(path))
        self._write_manifest_locked()
        self._memtable = {}
        self._memtable_size = 0
        self._wal.truncate()
        self._flushes += 1

    # -------------------------------------------------------- read path
    def _read(self, key: bytes):
        """Newest-wins point lookup: value bytes, or ``None`` (tombstone
        and absent collapse — callers never need the distinction)."""
        with self._lock:
            if key in self._memtable:
                return self._memtable[key]
            for run in self._runs:
                v = run.get(key)
                if v is not MISSING:
                    return v
            return None

    def _release_runs_locked(self, runs: List[SortedRun]) -> None:
        for r in runs:
            r.refs -= 1
            if r.retired and r.refs == 0:
                r.close()
                try:
                    os.unlink(r.path)
                except OSError:
                    pass

    def _iter_merged(self, start_key: bytes, end_key: bytes,
                     start_inclusive: bool = True) \
            -> Iterator[Tuple[bytes, bytes]]:
        """K-way merge of memtable + all runs over ``[start_key,
        end_key)``; newest source wins per key; tombstones skipped.

        Sources are snapshotted up front, so the scan is consistent
        against concurrent writers (their newer values land in a
        memtable this scan no longer reads) and refcounted against
        concurrent compactions."""
        with self._lock:
            mem = sorted((k, v) for k, v in self._memtable.items()
                         if start_key <= k < end_key)
            runs = list(self._runs)
            for r in runs:
                r.refs += 1
        try:
            def _bounded(it):
                for k, v in it:
                    if k >= end_key:
                        return
                    yield k, v

            sources = [iter(mem)] + [_bounded(r.iter_from(start_key))
                                     for r in runs]
            # heap entries (key, source_priority, value, iter); priority
            # 0 is the memtable (newest) — first pop for a key wins
            heap = []
            for prio, it in enumerate(sources):
                for k, v in it:
                    heap.append((k, prio, v, it))
                    break
            heapq.heapify(heap)
            last_key = None
            while heap:
                k, prio, v, it = heapq.heappop(heap)
                for nk, nv in it:
                    heapq.heappush(heap, (nk, prio, nv, it))
                    break
                if k == last_key:
                    continue
                last_key = k
                if v is None:  # tombstone shadows older runs
                    continue
                if not start_inclusive and k == start_key:
                    continue
                yield k, v
        finally:
            with self._lock:
                self._release_runs_locked(runs)

    # ------------------------------------------------------- compaction
    def _pick_compaction_locked(self) -> Optional[Tuple[int, int]]:
        """Longest adjacent same-size-tier group of >= max_runs_per_tier
        runs, as ``(start, stop)`` indices into ``self._runs``.  Only
        ADJACENT (recency-contiguous) runs may merge, or newest-wins
        ordering breaks."""
        n = len(self._runs)
        if n < self._max_runs_per_tier:
            return None

        def tier(run: SortedRun) -> int:
            size, t = max(run.file_size, 1), 0
            while size > (1 << 20):
                size >>= 2
                t += 1
            return t

        tiers = [tier(r) for r in self._runs]
        best = None
        i = 0
        while i < n:
            j = i
            while j < n and tiers[j] == tiers[i]:
                j += 1
            if j - i >= self._max_runs_per_tier and \
                    (best is None or j - i > best[1] - best[0]):
                best = (i, j)
            i = j
        if best is None and n >= 3 * self._max_runs_per_tier:
            # tier spread stalled compaction while runs pile up: fold
            # the oldest group regardless of tier to bound read fan-out
            best = (n - self._max_runs_per_tier, n)
        return best

    @staticmethod
    def _merge_runs(inputs: List[SortedRun], drop_tombstones: bool) \
            -> Iterator[Tuple[bytes, Optional[bytes]]]:
        heap = []
        for prio, it in enumerate(r.iter_from() for r in inputs):
            for k, v in it:
                heap.append((k, prio, v, it))
                break
        heapq.heapify(heap)
        last_key = None
        while heap:
            k, prio, v, it = heapq.heappop(heap)
            for nk, nv in it:
                heapq.heappush(heap, (nk, prio, nv, it))
                break
            if k == last_key:
                continue
            last_key = k
            if v is None and drop_tombstones:
                continue
            yield k, v

    def _maybe_compact(self) -> bool:
        with self._compact_mutex:
            with self._lock:
                pick = self._pick_compaction_locked()
                if pick is None:
                    return False
                start, stop = pick
                inputs = self._runs[start:stop]
                # flushes only ever insert at index 0, so this group
                # stays contiguous (and its oldest-ness stable) while
                # the merge streams outside the lock
                drop_tombstones = inputs[-1] is self._runs[-1]
                for r in inputs:
                    r.refs += 1
                out = os.path.join(
                    self._dir, f"run-{self._next_run_seq:012d}.sst")
                self._next_run_seq += 1
            write_run(out, self._merge_runs(inputs, drop_tombstones),
                      bits_per_key=self._bits_per_key)
            new_run = SortedRun(out)
            with self._lock:
                i = self._runs.index(inputs[0])
                self._runs[i:i + len(inputs)] = [new_run]
                self._write_manifest_locked()
                self._compactions += 1
                self._compaction_bytes += sum(r.file_size for r in inputs)
                for r in inputs:
                    r.retired = True
                self._release_runs_locked(inputs)
            return True

    def _compaction_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                while self._maybe_compact():
                    pass
            except Exception:  # noqa: BLE001 — keep the store serving
                import logging
                logging.getLogger(__name__).exception(
                    "lsm compaction failed; will retry")

    def compact_now(self) -> None:
        """Run pending compactions synchronously (tests / fsadmin)."""
        while self._maybe_compact():
            pass

    # ----------------------------------------------- InodeStore: inodes
    def get(self, inode_id: int) -> Optional[Inode]:
        blob = self._read(enc.inode_key(inode_id))
        if blob is None:
            return None
        return Inode.from_wire_dict(msgpack.unpackb(blob, raw=False))

    def put(self, inode: Inode) -> None:
        key = enc.inode_key(inode.id)
        blob = msgpack.packb(inode.to_wire_dict(), use_bin_type=True)
        with self._lock:
            if self._read(key) is None:
                self._inode_count += 1
            self._write_locked(key, blob)

    def remove(self, inode_id: int) -> None:
        key = enc.inode_key(inode_id)
        with self._lock:
            if self._read(key) is not None:
                self._inode_count -= 1
                self._write_locked(key, None)

    # ------------------------------------------------ InodeStore: edges
    def add_child(self, parent_id: int, name: str, child_id: int) -> None:
        with self._lock:
            self._write_locked(enc.edge_key(parent_id, name),
                               enc.edge_value(child_id))

    def remove_child(self, parent_id: int, name: str) -> None:
        key = enc.edge_key(parent_id, name)
        with self._lock:
            if self._read(key) is not None:
                self._write_locked(key, None)

    def get_child_id(self, parent_id: int, name: str) -> Optional[int]:
        blob = self._read(enc.edge_key(parent_id, name))
        return None if blob is None else enc.decode_edge_value(blob)

    def child_names(self, parent_id: int) -> List[str]:
        return [name for name, _ in self.iter_edges(parent_id)]

    def child_count(self, parent_id: int) -> int:
        return sum(1 for _ in self.iter_edges(parent_id))

    def iter_edges(self, parent_id: int,
                   start_after: Optional[str] = None) \
            -> Iterator[Tuple[str, int]]:
        prefix = enc.edge_prefix(parent_id)
        start = prefix if start_after is None \
            else enc.edge_key(parent_id, start_after)
        for key, value in self._iter_merged(
                start, prefix + b"\xff",
                start_inclusive=start_after is None):
            yield key[9:].decode("utf-8"), enc.decode_edge_value(value)

    def has_children(self, parent_id: int) -> bool:
        return next(self.iter_edges(parent_id), None) is not None

    def iter_inodes(self) -> Iterator[Inode]:
        for _key, blob in self._iter_merged(enc.INODE_PREFIX,
                                            _INODE_SCAN_END):
            yield Inode.from_wire_dict(msgpack.unpackb(blob, raw=False))

    def all_ids(self) -> Iterator[int]:
        for key, _blob in self._iter_merged(enc.INODE_PREFIX,
                                            _INODE_SCAN_END):
            yield enc.decode_inode_key(key)

    # ------------------------------------------------------ maintenance
    def flush(self) -> None:
        with self._lock:
            self._wal.flush()

    def seal(self) -> None:
        """Force the memtable into a sorted run (tests / checkpoint)."""
        with self._lock:
            self._flush_memtable_locked()

    def clear(self) -> None:
        with self._lock:
            for r in self._runs:
                r.retired = True
                r.refs += 1
            self._release_runs_locked(self._runs)
            self._runs = []
            try:
                os.unlink(self._manifest_path())
            except OSError:
                pass
            self._memtable = {}
            self._memtable_size = 0
            self._wal.truncate()
            self._inode_count = 0

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout=5.0)
        with self._lock:
            # seal so the next open replays nothing (fast restart); the
            # WAL still covers a kill before this point
            self._flush_memtable_locked()
            self._wal.close()
            for r in self._runs:
                r.close()

    def estimated_size(self) -> int:
        with self._lock:
            return self._inode_count

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "kind": "LSM",
                "inodes": self._inode_count,
                "memtable_bytes": self._memtable_size,
                "memtable_entries": len(self._memtable),
                "runs": len(self._runs),
                "run_bytes": sum(r.file_size for r in self._runs),
                "wal_bytes": self._wal.size_bytes(),
                "flushes": self._flushes,
                "compactions": self._compactions,
                "compaction_bytes": self._compaction_bytes,
            }

    # ----------------------------------------------- native checkpoints
    def checkpoint_state(self) -> dict:
        """Seal the memtable, then capture the run set: the checkpoint
        IS the on-disk LSM at WAL position zero."""
        with self._lock:
            self._flush_memtable_locked()
            runs = []
            for r in self._runs:
                with open(r.path, "rb") as f:
                    runs.append({"name": os.path.basename(r.path),
                                 "data": f.read()})
        return {"format": "lsm-runs", "runs": runs}

    def restore_state(self, state: dict) -> None:
        if state.get("format") != "lsm-runs":
            raise ValueError(
                f"unknown LSM checkpoint format {state.get('format')!r}")
        with self._lock:
            self.clear()
            for entry in state.get("runs", []):
                path = os.path.join(self._dir, entry["name"])
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(entry["data"])
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                self._runs.append(SortedRun(path))
                self._next_run_seq = max(
                    self._next_run_seq, self._run_seq(entry["name"]) + 1)
            self._write_manifest_locked()
            self._inode_count = sum(
                1 for _ in self._iter_merged(enc.INODE_PREFIX,
                                             _INODE_SCAN_END))
