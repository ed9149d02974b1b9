"""Client side of the same-host zero-copy plane: SHM segment transport
(the port of ``alluxio_tpu/client/shm_transport.py``).

A co-located client leases a block's MEM-tier file from the worker
(``shm_open``), maps it ONCE, and serves every read of that block from
the shared pages — no RPC, no serialization, no copy per read.
``numpy_view`` hands the same pages to numpy, read-only: the loader
copies them into pinned staging for the host -> device copy, which is
the only copy a same-host read pays. See ``alluxio_tpu_torch/shm/`` for
the lease protocol.

The transport keeps an LRU **segment cache**
(``atpu.user.shm.segment.cache.max``): repeated opens of a hot block
cost a dict hit, not an RPC. Leases renew *lazily*: a read touching a
segment past ``atpu.user.shm.lease.renew.fraction`` of its TTL fires one
``shm_renew``, amortized over every read in between.

Failure contract: every exit from this plane is a typed error the
routing ladder catches — ``ShmLeaseDeniedError`` /
``ShmSegmentUnavailableError`` from the worker, ``OSError`` from a
failed map. A *renewal* failure on an already-mapped segment is NOT an
error: Linux keeps mapped pages valid across an unlink, so in-flight
readers finish safely and only the next cold open re-routes.
"""

from __future__ import annotations

import mmap
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from alluxio_tpu_torch import native
from alluxio_tpu_torch.client import fastpath
from alluxio_tpu_torch.client.block_streams import BlockInStream, _record_read
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.utils import faults
from alluxio_tpu_torch.utils.tracing import current_span


class ShmSegment:
    """One mapped segment: mmap + lease bookkeeping."""

    __slots__ = ("block_id", "path", "length", "lease_id", "ttl_s",
                 "renew_at", "mm", "dead")

    def __init__(self, block_id: int, path: str, length: int,
                 lease_id: int, ttl_s: float, renew_fraction: float,
                 mm: Optional[mmap.mmap]) -> None:
        self.block_id = block_id
        self.path = path
        self.length = length
        self.lease_id = lease_id
        self.ttl_s = ttl_s
        self.renew_at = time.monotonic() + ttl_s * renew_fraction
        self.mm = mm
        #: lease lost (renewal refused / released): serve existing maps,
        #: stop cache hits
        self.dead = False

    def view(self, offset: int = 0, length: int = -1) -> memoryview:
        if self.mm is None:
            return memoryview(b"")
        end = self.length if length < 0 else min(self.length,
                                                 offset + length)
        return memoryview(self.mm)[offset:max(offset, end)]

    def close_map(self) -> None:
        mm, self.mm = self.mm, None
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                # a numpy view is still live (a staging copy in
                # progress); leave the mapping to GC — pages stay valid
                pass


class ShmTransport:
    """Per-client segment cache + lease manager."""

    def __init__(self, session_id: int, *, cache_max: int = 64,
                 renew_fraction: float = 0.5, host: str = "",
                 native_fastpath: bool = True) -> None:
        self._session = session_id
        self._cache_max = max(1, int(cache_max))
        self._renew_fraction = min(0.95, max(0.05, float(renew_fraction)))
        #: the client's host, which the fault injector's scope matches
        self._host = host
        #: batch pread_many through the native plan executor
        #: (``atpu.user.native.fastpath.enabled``); the per-op Python
        #: loop gives the same bytes
        self.native_fastpath = bool(native_fastpath)
        self._lock = threading.Lock()
        self._segments: "OrderedDict[int, ShmSegment]" = OrderedDict()

    # -------------------------------------------------------------- open
    def open_stream(self, worker, block_id: int) -> "ShmBlockInStream":
        """The same-host read stream over ``worker`` (a
        ``WorkerClient``); raises the typed fallback errors (lease
        denied / segment unavailable / map OSError) the routing ladder
        in ``BlockStoreClient.open_block`` catches."""
        return ShmBlockInStream(self, worker, self.segment(worker,
                                                           block_id))

    def segment(self, worker, block_id: int) -> ShmSegment:
        with self._lock:
            seg = self._segments.get(block_id)
            if seg is not None and not seg.dead:
                self._segments.move_to_end(block_id)
            else:
                seg = None
        if seg is not None:
            self._maybe_renew(worker, seg)
            if not seg.dead:
                return seg
            self.invalidate(block_id)
        return self._map(worker, block_id)

    def _map(self, worker, block_id: int) -> ShmSegment:
        sp = current_span()
        t0 = time.perf_counter()
        # lease grant: the worker pins the block against eviction before
        # we touch the file — typed denials propagate to the router
        lease = worker.shm_open(self._session, block_id)
        if sp is not None:
            sp.phase("lease_wait", (time.perf_counter() - t0) * 1000.0)
        t1 = time.perf_counter()
        try:
            if faults.armed() and \
                    faults.injector().take_shm_map_error(self._host):
                raise OSError(
                    f"injected shm map fault for block {block_id}")
            if lease["length"] > 0:
                with open(lease["path"], "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
            else:
                mm = None
        except OSError:
            metrics().counter("Client.ShmMapFailures").inc()
            # we hold a lease we cannot use; give it back now rather
            # than waiting out the TTL
            try:
                worker.shm_release(self._session, lease["lease_id"])
            except Exception:  # noqa: BLE001 - TTL reclaims it anyway
                pass
            raise
        if sp is not None:
            sp.phase("shm_map", (time.perf_counter() - t1) * 1000.0)
        seg = ShmSegment(block_id, lease["path"], lease["length"],
                         lease["lease_id"], lease["ttl_s"],
                         self._renew_fraction, mm)
        victims = []
        with self._lock:
            self._segments[block_id] = seg
            self._segments.move_to_end(block_id)
            while len(self._segments) > self._cache_max:
                victims.append(self._segments.popitem(last=False)[1])
        for v in victims:
            self._release(worker, v)
        return seg

    # ------------------------------------------------------------- leases
    def _maybe_renew(self, worker, seg: ShmSegment) -> None:
        """Lazy renewal: one RPC past the renew point, amortized over
        the zero-copy reads in between. A refused renewal (worker
        restarted, lease reclaimed) marks the segment dead — existing
        views stay valid (mmap semantics), the next open re-leases."""
        if seg.dead or time.monotonic() < seg.renew_at:
            return
        try:
            resp = worker.shm_renew(self._session, seg.lease_id)
        except Exception:  # noqa: BLE001 - worker gone: segment is stale
            seg.dead = True
            return
        if resp.get("ok"):
            seg.renew_at = time.monotonic() + \
                float(resp.get("ttl_s", seg.ttl_s)) * self._renew_fraction
        else:
            seg.dead = True

    def touch(self, worker, seg: ShmSegment) -> None:
        """Read-path hook: keep the lease fresh while a stream serves."""
        self._maybe_renew(worker, seg)

    def _release(self, worker, seg: ShmSegment) -> None:
        seg.dead = True
        seg.close_map()
        if worker is not None:
            try:
                worker.shm_release(self._session, seg.lease_id)
            except Exception:  # noqa: BLE001 - TTL reclaims it anyway
                pass

    def invalidate(self, block_id: int) -> None:
        with self._lock:
            seg = self._segments.pop(block_id, None)
        if seg is not None:
            seg.dead = True
            seg.close_map()

    def close(self, worker_for=None) -> None:
        """Unmap everything; ``worker_for(block_id) -> WorkerClient``
        enables graceful lease release (else TTL expiry reclaims)."""
        with self._lock:
            segs = list(self._segments.values())
            self._segments.clear()
        for seg in segs:
            w = worker_for(seg.block_id) if worker_for is not None else None
            self._release(w, seg)

    def cached_blocks(self) -> int:
        with self._lock:
            return len(self._segments)


class ShmBlockInStream(BlockInStream):
    """Same-host zero-copy stream over a cached SHM segment: reads are
    slices of the shared pages, no RPC and no serialization."""

    source = "LOCAL"

    def __init__(self, transport: ShmTransport, worker,
                 seg: ShmSegment) -> None:
        super().__init__(seg.block_id, seg.length)
        self.last_source = "SHM"
        self._transport = transport
        self._worker = worker
        self._seg = seg

    def pread(self, offset: int, n: int) -> bytes:
        return bytes(self.pread_view(offset, n))

    def pread_view(self, offset: int, n: int) -> memoryview:
        """The zero-copy form of :meth:`pread`: a live view of the
        shared pages, no intermediate ``bytes``."""
        self._transport.touch(self._worker, self._seg)
        out = self._seg.view(offset, n)
        metrics().counter("Client.ShmReads").inc()
        _record_read("shm", len(out))
        return out

    def pread_many(self, offsets, sizes):
        """Batched positioned reads: with the native fastpath on, the
        whole batch becomes ONE packed op table copied out of the mapped
        segment GIL-free — one lease touch and one metrics update per
        batch. The per-op path gives the same bytes on any native
        problem."""
        if self._transport.native_fastpath and len(offsets) > 1:
            if fastpath.available():
                try:
                    return self._native_pread_many(offsets, sizes)
                except fastpath.NativeExecError:
                    pass  # the fallback is counted
            else:
                fastpath.note_unavailable()
        return super().pread_many(offsets, sizes)

    def _native_pread_many(self, offsets, sizes):
        seg = self._seg
        self._transport.touch(self._worker, seg)
        offs = np.asarray(offsets, dtype=np.int64)
        szs = np.asarray(sizes, dtype=np.int64)
        if offs.size and int(offs.min()) < 0:
            # negative offsets hit memoryview's from-the-end slicing in
            # the per-op path; keep that quirk on the Python rung
            raise fastpath.NativeExecError("negative offset")
        # clamp exactly like ShmSegment.view: min(n, seg.length - off),
        # floored at zero (past-EOF and negative sizes read empty)
        lens = np.clip(np.minimum(szs, seg.length - offs), 0, None)
        bounds = np.zeros(offs.size + 1, dtype=np.int64)
        np.cumsum(lens, out=bounds[1:])
        dest = bytearray(int(bounds[-1]))
        if len(dest):
            loc = native._buffer_address(seg.mm) \
                if seg.mm is not None else None
            if loc is None:
                fastpath.note_unavailable()
                raise fastpath.NativeExecError("no segment address")
            addr, n, keep = loc
            ops = fastpath.op_table(offs.size)
            ops["src"] = addr  # kind zero-init == OP_COPY
            ops["src_off"] = offs.astype(np.uint64)
            ops["src_len"] = n
            ops["dst_off"] = bounds[:-1]
            ops["len"] = lens
            fastpath.execute_table(ops, dest, host="shm")
            del keep
        m = metrics()
        m.counter("Client.ShmReads").inc(offs.size)
        m.counter("Client.BytesRead.shm").inc(len(dest))
        m.counter("Client.BlocksRead.shm").inc(offs.size)
        return fastpath.slice_out(dest, bounds.tolist())

    def memoryview(self) -> Optional[memoryview]:
        """Zero-copy view over the shared pages."""
        return self._seg.view()

    def numpy_view(self, dtype=np.uint8) -> np.ndarray:
        """Zero-copy read-only ndarray over the shared pages (copy it
        into staging; ``torch.from_numpy`` refuses read-only arrays)."""
        if self._seg.mm is None:
            return np.empty(0, dtype=dtype)
        metrics().counter("Client.ShmReads").inc()
        _record_read("shm", self._seg.length)
        return np.frombuffer(self._seg.mm, dtype=dtype)

    def close(self) -> None:
        # the segment stays cached (and leased) for the next open — the
        # whole point of the transport; BlockStoreClient.close releases
        pass
