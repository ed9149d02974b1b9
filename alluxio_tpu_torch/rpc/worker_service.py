"""Worker data-server RPC service.

A copy of ``alluxio_tpu/rpc/worker_service.py``.

Re-design of ``core/server/worker/.../grpc/{GrpcDataServer.java:50,
BlockReadHandler.java:59,BlockWriteHandler,ShortCircuitBlockReadHandler,
ShortCircuitBlockWriteHandler}.java`` + ``grpc/block_worker.proto:13-29``,
under the JAX service's name and method names, with its message dicts:

- ``read_block``: server-stream of chunks (``DEFAULT_CHUNK``); a cold
  block falls back to a UFS read-through when the request carries a UFS
  descriptor, streamed stripe by stripe from the worker's striped,
  coalescing fetch (``worker/ufs_fetch.py``) as the stripes land, so a
  client's first byte costs one stripe.
- ``write_block``: client-stream (header, chunks...) -> length.
- ``open_local_block`` / ``close_local_block``: short-circuit **path
  leases** for same-host clients; the server holds the shared block lock
  until the lease closes.
- ``create_local_block`` / ``complete_local_block``: the short-circuit
  write lease (a temp-block path) and its commit or abort.
- ``read_many``: a batch of small reads of one block in one RPC.
- ``shm_open`` / ``shm_renew`` / ``shm_release``: the same-host SHM
  lease plane (``worker/shm_store.py``).
- ``async_cache``, ``prefetch_pin`` / ``prefetch_unpin``,
  ``remove_block``, ``move_block``, ``persist_file``,
  ``cleanup_session``: unary control ops.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, Tuple

from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.qos import priority_from_name
from alluxio_tpu_torch.rpc.core import ServiceDefinition
from alluxio_tpu_torch.utils import faults
from alluxio_tpu_torch.utils.exceptions import (
    BlockDoesNotExistError, InvalidArgumentError, best_effort,
)
from alluxio_tpu_torch.utils.tracing import current_span
from alluxio_tpu_torch.worker.process import BlockWorker
from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor

WORKER_SERVICE = "atpu.BlockWorker"

DEFAULT_CHUNK = 1 << 20
#: Worker.ReadBlockTime (per-MiB warm produce time) is only sampled for
#: reads of at least this many bytes served in chunks of at least this
#: size: below either bound, the fixed per-read-call cost dominates the
#: normalized figure
P99_SAMPLE_MIN_BYTES = 1 << 18
P99_SAMPLE_MIN_CHUNK = 1 << 16


class _LeaseRegistry:
    def __init__(self) -> None:
        self._leases: Dict[Tuple[int, int], object] = {}
        self._lock = threading.Lock()

    def put(self, session_id: int, block_id: int, lease) -> None:
        with self._lock:
            old = self._leases.pop((session_id, block_id), None)
            self._leases[(session_id, block_id)] = lease
        if old is not None:
            old.close()

    def close(self, session_id: int, block_id: int) -> bool:
        with self._lock:
            lease = self._leases.pop((session_id, block_id), None)
        if lease is not None:
            lease.close()
            return True
        return False

    def close_session(self, session_id: int) -> None:
        with self._lock:
            victims = [k for k in self._leases if k[0] == session_id]
            leases = [self._leases.pop(k) for k in victims]
        for lease in leases:
            lease.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._leases)


def _principal() -> str:
    """The authenticated caller's name, for per-tenant QoS accounting;
    empty (one anonymous tenant) when the worker runs no authenticator
    (QoS disabled) or the call is in-process."""
    from alluxio_tpu_torch.security.user import authenticated_user

    user = authenticated_user()
    return user.name if user is not None else ""


def worker_service(worker: BlockWorker) -> ServiceDefinition:
    svc = ServiceDefinition(WORKER_SERVICE)
    leases = _LeaseRegistry()
    worker._short_circuit_leases = leases  # session cleanup hook

    # ---------------------------------------------------------- read stream
    def read_block(req: dict) -> Iterator[dict]:
        """Chunks carry ``source`` — the serving tier alias (MEM/SSD/...)
        or ``UFS`` for a cold read-through — so clients can attribute
        every byte to the tier that produced it. Warm serving speed is
        timed into ``Worker.ReadBlockTime`` (one sample a stream,
        seconds a MiB of the tier reads alone; the injected read
        latency lands inside it). The ``with`` releases the block
        reader's eviction pin as soon as the stream ends or is
        cancelled, and the ``finally`` still records the partial
        progress."""
        clock = time.monotonic
        fault_host = worker.address.tiered_identity.value("host") \
            or worker.address.host
        block_id = req["block_id"]
        offset = req.get("offset", 0)
        length = req.get("length", -1)
        # clamp: chunk_size<=0 from a buggy client would spin the
        # cached-tier loop forever without advancing pos
        chunk = max(1, req.get("chunk_size", DEFAULT_CHUNK))
        m = metrics()
        # the server span (opened by the RPC wrapper) stays live across
        # the generator's resumptions on this thread; phase timings are
        # accumulated locally and emitted ONCE at stream end
        sp = current_span()
        if worker.store.has_block(block_id):
            produce_s = 0.0
            produced_b = 0
            wire_s = 0.0
            try:
                with worker.open_reader(block_id) as r:
                    tier = r.tier_alias or "MEM"
                    m.counter(f"Worker.BlocksServed.{tier}").inc()
                    served = m.counter(f"Worker.BytesServed.{tier}")
                    end = r.length if length < 0 \
                        else min(r.length, offset + length)
                    pos = offset
                    while pos < end:  # the reference's hot loop
                        n = min(chunk, end - pos)
                        t0 = clock()
                        data = r.read(pos, n)
                        if faults.armed():
                            # inside the timed region on purpose: the
                            # injected straggler must show up in
                            # Worker.ReadBlockTime like a real one
                            faults.injector().maybe_sleep_read(
                                fault_host)
                        produce_s += clock() - t0
                        produced_b += len(data)
                        if sp is None:
                            yield {"data": data, "offset": pos,
                                   "source": tier}
                        else:
                            t_y = clock()
                            yield {"data": data, "offset": pos,
                                   "source": tier}
                            wire_s += clock() - t_y
                        served.inc(n)
                        pos += n
            finally:
                if sp is not None:
                    sp.phase("tier_read", produce_s * 1000.0)
                    sp.phase("wire", wire_s * 1000.0)
                if produced_b >= P99_SAMPLE_MIN_BYTES and \
                        chunk >= P99_SAMPLE_MIN_CHUNK:
                    m.timer("Worker.ReadBlockTime").update(
                        produce_s * ((1 << 20) / produced_b))
            return
        ufs = req.get("ufs")
        if not ufs:
            raise BlockDoesNotExistError(
                f"block {block_id} not cached and no UFS fallback given")
        desc = UfsBlockDescriptor(
            block_id=block_id, ufs_path=ufs["ufs_path"],
            offset=ufs["offset"], length=ufs["length"],
            mount_id=ufs.get("mount_id", 0))
        # streaming read-through: chunks go out as stripes land, so the
        # client's first byte costs one stripe, not the whole block; the
        # tiered-store fill proceeds in parallel inside the fetch.
        # A blocked reader is ON_DEMAND — it overtakes (and, when
        # coalescing, promotes) queued background fills — and carries
        # the caller's principal for the per-tenant stripe caps
        fetch = worker.open_ufs_fetch(desc, cache=req.get("cache", True),
                                      tenant=_principal())
        m.counter("Worker.BlocksServed.UFS").inc()
        served = m.counter("Worker.BytesServed.UFS")
        end = desc.length if length < 0 else min(desc.length,
                                                 offset + length)
        pos = offset
        wire_s = 0.0
        for data in fetch.iter_range(offset, max(0, end - offset),
                                     chunk_size=chunk):
            if sp is None:
                yield {"data": data, "offset": pos, "source": "UFS"}
            else:
                t_y = clock()
                yield {"data": data, "offset": pos, "source": "UFS"}
                wire_s += clock() - t_y
            served.inc(len(data))
            pos += len(data)
        if sp is not None:
            sp.phase("wire", wire_s * 1000.0)
        # the cache-fill commit trails the last stripe; close the
        # stream only once it lands so "read completed" keeps implying
        # "block cached" for clients and heartbeats. A fetch that FAILED
        # after serving this sub-range fails the stream too; a slow
        # commit alone (timeout, error is None) stays best-effort
        if not fetch.wait_done(30.0) and fetch.error is not None:
            raise fetch.error if isinstance(fetch.error, Exception) \
                else IOError(str(fetch.error))

    svc.stream_out("read_block", read_block)

    # -------------------------------------------------- scatter/gather read
    def read_many(req: dict) -> dict:
        """Batch of small reads against ONE block, served in one RPC:
        ``{block_id, offsets: [..], sizes: [..]}`` -> one concatenated
        payload + per-op lengths, in request order. One reader open, one
        block lock, one serialization; an op past EOF yields a short
        slice, as the same per-op ``read_block`` calls would."""
        block_id = req["block_id"]
        offsets = req["offsets"]
        sizes = req["sizes"]
        if len(offsets) != len(sizes):
            raise InvalidArgumentError(
                f"read_many: {len(offsets)} offsets vs {len(sizes)} sizes")
        m = metrics()
        sp = current_span()
        t0 = time.perf_counter()
        lengths = []
        parts = []
        with worker.open_reader(block_id) as r:
            tier = r.tier_alias or "MEM"
            served = m.counter(f"Worker.BytesServed.{tier}")
            for off, size in zip(offsets, sizes):
                data = r.read(off, max(0, size))
                parts.append(data)
                lengths.append(len(data))
                served.inc(len(data))
        m.counter(f"Worker.BlocksServed.{tier}").inc()
        m.counter("Worker.BatchReadOps").inc(len(offsets))
        if sp is not None:
            # the whole gather is one tier_read burst; batch_read is the
            # assembly slice the critical-path analyzer attributes to
            # this subsystem
            sp.phase("batch_read", (time.perf_counter() - t0) * 1000.0)
        return {"data": b"".join(parts), "lengths": lengths,
                "source": tier}

    svc.unary("read_many", read_many)

    # ------------------------------------------------------ shm lease plane
    shm = worker.shm_store
    svc.unary("shm_open", lambda r: shm.open(r["session_id"],
                                             r["block_id"]))
    svc.unary("shm_renew", lambda r: shm.renew(r["session_id"],
                                               r["lease_id"]))
    svc.unary("shm_release", lambda r: {"released": shm.release(
        r["session_id"], r["lease_id"])})

    # ---------------------------------------------------------- write stream
    def write_block(requests: Iterator[dict]) -> dict:
        header = next(requests)
        block_id = header["block_id"]
        session_id = header["session_id"]
        worker.create_block(session_id, block_id,
                            initial_bytes=header.get("size_hint",
                                                     DEFAULT_CHUNK),
                            tier_alias=header.get("tier", ""))
        length = 0
        try:
            with worker.get_temp_writer(session_id, block_id) as w:
                for msg in requests:
                    if msg.get("cancel"):
                        raise InvalidArgumentError("write cancelled")
                    data = msg.get("data")
                    if data:
                        w.append(data)
                        length += len(data)
            worker.commit_block(session_id, block_id,
                                pinned=header.get("pinned", False))
        except BaseException:
            best_effort("write abort", worker.abort_block,
                        session_id, block_id)
            raise
        return {"length": length}

    svc.stream_in("write_block", write_block)

    # ------------------------------------------------------- short circuit
    def open_local_block(req: dict) -> dict:
        lease = worker.open_local_block(req["block_id"])
        leases.put(req["session_id"], req["block_id"], lease)
        return {"path": lease.path, "length": lease.length}

    def close_local_block(req: dict) -> dict:
        return {"closed": leases.close(req["session_id"], req["block_id"])}

    def create_local_block(req: dict) -> dict:
        path = worker.create_block(
            req["session_id"], req["block_id"],
            initial_bytes=req.get("size_hint", DEFAULT_CHUNK),
            tier_alias=req.get("tier", ""))
        return {"path": path}

    def complete_local_block(req: dict) -> dict:
        if req.get("cancel"):
            worker.abort_block(req["session_id"], req["block_id"])
        else:
            worker.commit_block(req["session_id"], req["block_id"],
                                pinned=req.get("pinned", False))
        return {}

    svc.unary("open_local_block", open_local_block)
    svc.unary("close_local_block", close_local_block)
    svc.unary("create_local_block", create_local_block)
    svc.unary("complete_local_block", complete_local_block)

    # -------------------------------------------------------------- control
    def async_cache(r: dict) -> dict:
        """``qos_class`` (optional wire string, default ASYNC_FILL) lets
        the prefetch agent tag its speculative loads PREFETCH so they
        drain after client-issued fills and on-demand reads; the
        caller's principal is the fill's tenant."""
        return {"accepted": worker.async_cache.submit(
            UfsBlockDescriptor(
                block_id=r["block_id"], ufs_path=r["ufs_path"],
                offset=r["offset"], length=r["length"],
                mount_id=r.get("mount_id", 0)),
            priority=priority_from_name(r.get("qos_class", "")),
            tenant=_principal())}

    svc.unary("async_cache", async_cache)
    svc.unary("prefetch_pin", lambda r: {
        "pinned": worker.store.pin_prefetch(r["block_id"],
                                            r.get("ttl_s", 600.0))})
    svc.unary("prefetch_unpin", lambda r: (
        worker.store.unpin_prefetch(r["block_id"]), {})[-1])
    svc.unary("remove_block", lambda r: (
        worker.store.remove_block(r["block_id"]), {})[-1])
    svc.unary("move_block", lambda r: (
        worker.store.move_block(r["block_id"], r["tier"]), {})[-1])
    svc.unary("session_heartbeat", lambda r: {})
    svc.unary("persist_file", lambda r: {"fingerprint": worker.persist_file(
        r["ufs_path"], r["block_ids"], r.get("mount_id", 0))})

    def cleanup_session(req: dict) -> dict:
        leases.close_session(req["session_id"])
        worker.cleanup_session(req["session_id"])
        return {}

    svc.unary("cleanup_session", cleanup_session)
    return svc
