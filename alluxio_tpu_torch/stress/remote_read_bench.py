"""Remote warm-read bench (suite row ``remote-warm-read``; a copy of
``alluxio_tpu/stress/remote_read_bench.py``).

Measures the striped parallel remote-read pipeline
(``client/remote_read.py``) against the single-stream reader it
replaced, under a **bandwidth-limited-per-connection worker model**:
each opened range stream pays a fixed round trip to first byte and then
delivers at a fixed per-connection bandwidth — the DCN regime the paper
targets (and the one Hiding Latencies in Network-Based Image Loading,
arXiv 2503.22643, shows parallel connections close). All costs are
modeled sleeps, so the numbers isolate the client pipeline; sleeps are
tens of ms and dwarf host jitter.

Reported:

- ``single_gbps`` / ``striped_gbps`` — warm remote-read throughput of
  the legacy one-stream loop vs the striped reader at ``--stripes``
  concurrent range streams;
- ``single_ttfb_ms`` / ``striped_ttfb_ms`` — median time-to-first-byte;
- a hedge row: reads against a replica pair where one replica
  deterministically stalls, reporting hedges issued, hedge wins, and
  the straggler-suppressed read latency.

The suite row FAILS (``errors=1``) when striped throughput at 4 stripes
is below ``--min-speedup`` (default 1.5×) of single-stream, or when the
injected straggler produces zero hedge wins.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from typing import List, Optional

from alluxio_tpu_torch.stress.base import BenchResult


class ModeledWorkerSource:
    """A ``ReadSource`` over one modeled DCN connection to a replica:
    ``rtt`` to first byte, then ``conn_bytes_per_s`` per connection.
    ``stall_every`` > 0 makes every Nth open stall ``stall_s`` before
    its first byte — the injected straggler."""

    def __init__(self, key: str, data: bytes, *, rtt_s: float,
                 conn_bytes_per_s: float, stall_every: int = 0,
                 stall_s: float = 0.0) -> None:
        self.key = key
        self.worker_key = key
        self.address = None
        self._data = data
        self._rtt_s = rtt_s
        self._bw = conn_bytes_per_s
        self._stall_every = stall_every
        self._stall_s = stall_s
        self._opens = 0
        self._lock = threading.Lock()

    def set_stall(self, every: int, stall_s: float) -> None:
        with self._lock:
            self._stall_every = every
            self._stall_s = stall_s
            self._opens = 0

    def open(self, offset: int, length: int, chunk_size: int):
        with self._lock:
            self._opens += 1
            stalled = self._stall_every > 0 and \
                self._opens % self._stall_every == 0
        return _ModeledStream(self, offset, length, chunk_size, stalled)


class _ModeledStream:
    def __init__(self, src: ModeledWorkerSource, offset: int, length: int,
                 chunk_size: int, stalled: bool) -> None:
        self._src = src
        self._offset = offset
        self._length = length
        self._chunk = chunk_size
        self._stalled = stalled
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __iter__(self):
        src = self._src
        first = src._rtt_s + (src._stall_s if self._stalled else 0.0)
        pos = self._offset
        end = self._offset + self._length
        while pos < end:
            n = min(self._chunk, end - pos)
            # a cancelled stream stops costing bandwidth: sleep in small
            # slices so a hedge loser releases its modeled connection
            deadline = time.perf_counter() + first + n / src._bw
            first = 0.0
            while True:
                if self.cancelled:
                    return
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    break
                time.sleep(min(remain, 0.01))
            yield {"data": src._data[pos:pos + n], "source": "MEM"}
            pos += n


def _single_stream_read(source: ModeledWorkerSource, length: int,
                        chunk_size: int):
    """The legacy ``GrpcBlockInStream.pread`` shape: one stream, chunks
    re-joined through a bytearray. Returns (bytes, ttfb_s)."""
    out = bytearray()
    t0 = time.perf_counter()
    ttfb: Optional[float] = None
    for msg in source.open(0, length, chunk_size):
        if ttfb is None:
            ttfb = time.perf_counter() - t0
        out.extend(msg["data"])
    return bytes(out), ttfb or 0.0


def run(*, block_mb: int = 4, stripe_kb: int = 1024, stripes: int = 4,
        rtt_ms: float = 20.0, conn_mbps: float = 16.0, blocks: int = 3,
        hedge_quantile: float = 0.95, stall_ms: float = 300.0,
        min_speedup: float = 1.5) -> BenchResult:
    import os

    from alluxio_tpu_torch.client.remote_read import (
        RemoteReadConf, RemoteReadRuntime,
    )

    t_start = time.monotonic()
    block_bytes = block_mb << 20
    chunk = 256 << 10
    data = os.urandom(1 << 20) * block_mb
    bw = conn_mbps * (1 << 20)

    def mk(key: str, **kw) -> ModeledWorkerSource:
        return ModeledWorkerSource(key, data, rtt_s=rtt_ms / 1e3,
                                   conn_bytes_per_s=bw, **kw)

    # --- phase 1: throughput, single stream vs striped -------------------
    single_s: List[float] = []
    single_ttfb: List[float] = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        out, ttfb = _single_stream_read(mk("w0"), block_bytes, chunk)
        single_s.append(time.perf_counter() - t0)
        single_ttfb.append(ttfb)
        assert out == data
    single_gbps = blocks * block_bytes / sum(single_s) / (1 << 30)

    conf = RemoteReadConf(stripe_size=stripe_kb << 10, concurrency=stripes,
                          window_bytes=0, hedge_quantile=0.0)
    rt = RemoteReadRuntime(conf)
    # pooled-channel model: one replica, `stripes` independent
    # connections — each source is its own modeled TCP stream
    pool = [mk(f"w0~{i}") for i in range(stripes)]
    # warm the stripe executor off the clock (thread spawn on a
    # throttled CI host is ms-scale and would land on the first block)
    rt.read(block_id=0, sources=pool, offset=0,
            length=conf.stripe_size * stripes, chunk_size=chunk).read_view()
    striped_s: List[float] = []
    striped_ttfb: List[float] = []
    for b in range(blocks):
        read = rt.read(block_id=b + 1, sources=pool, offset=0,
                       length=block_bytes, chunk_size=chunk)
        t0 = time.perf_counter()
        got = 0
        ttfb = None
        for view in read.iter_views(chunk_size=chunk):
            if ttfb is None:
                ttfb = time.perf_counter() - t0
            got += len(view)
        striped_s.append(time.perf_counter() - t0)
        striped_ttfb.append(ttfb or 0.0)
        assert got == block_bytes
        assert bytes(read.read_view()) == data
    striped_gbps = blocks * block_bytes / sum(striped_s) / (1 << 30)
    speedup = striped_gbps / single_gbps if single_gbps > 0 else 0.0
    print(f"[remoteread] single {single_gbps:.3f} GB/s / "
          f"{statistics.median(single_ttfb) * 1e3:.1f} ms ttfb, striped "
          f"x{stripes} {striped_gbps:.3f} GB/s / "
          f"{statistics.median(striped_ttfb) * 1e3:.1f} ms ttfb "
          f"({speedup:.2f}x)", file=sys.stderr, flush=True)
    rt.close()

    # --- phase 2: hedged requests vs an injected straggler replica -------
    hconf = RemoteReadConf(stripe_size=stripe_kb << 10, concurrency=stripes,
                           window_bytes=0, hedge_quantile=hedge_quantile)
    hrt = RemoteReadRuntime(hconf)
    fast = mk("w-fast")
    slow = mk("w-slow")
    replicas = [fast, slow]
    # seed the rolling EWMAs with clean reads while the straggler is
    # still healthy — a hedger needs a baseline to call anything a tail
    for b in range(3):
        r = hrt.read(block_id=100 + b, sources=replicas, offset=0,
                     length=block_bytes, chunk_size=chunk)
        assert bytes(r.read_view()) == data
    # now every 2nd stream on the straggler stalls before its first
    # byte — a tail, not a uniformly slow worker (cancelled losers are
    # never observed, so its EWMA stays honest)
    slow.set_stall(2, stall_ms / 1e3)
    hedges = wins = 0
    hedged_s: List[float] = []
    for b in range(blocks):
        r = hrt.read(block_id=200 + b, sources=replicas, offset=0,
                     length=block_bytes, chunk_size=chunk)
        t0 = time.perf_counter()
        assert bytes(r.read_view()) == data
        hedged_s.append(time.perf_counter() - t0)
        hedges += r.hedges
        wins += r.hedge_wins
    hrt.close()
    print(f"[remoteread] straggler phase: {hedges} hedges, {wins} wins, "
          f"median read {statistics.median(hedged_s) * 1e3:.1f} ms "
          f"(straggler stall {stall_ms:.0f} ms)",
          file=sys.stderr, flush=True)

    ok = speedup >= min_speedup and wins > 0
    if speedup < min_speedup:
        print(f"[remoteread] striped speedup {speedup:.2f}x is below the "
              f"{min_speedup}x gate", file=sys.stderr)
    if wins == 0:
        print("[remoteread] no hedge wins against the injected straggler",
              file=sys.stderr)

    return BenchResult(
        bench="remote-warm-read",
        params={"block_mb": block_mb, "stripe_kb": stripe_kb,
                "stripes": stripes, "rtt_ms": rtt_ms,
                "conn_mbps": conn_mbps, "blocks": blocks,
                "hedge_quantile": hedge_quantile, "stall_ms": stall_ms,
                "min_speedup": min_speedup},
        metrics={"single_gbps": round(single_gbps, 4),
                 "striped_gbps": round(striped_gbps, 4),
                 # report headline
                 "gb_per_s": round(striped_gbps, 4),
                 "speedup": round(speedup, 3),
                 "single_ttfb_ms": round(
                     statistics.median(single_ttfb) * 1e3, 2),
                 "striped_ttfb_ms": round(
                     statistics.median(striped_ttfb) * 1e3, 2),
                 "hedges": hedges, "hedge_wins": wins,
                 "hedged_read_ms": round(
                     statistics.median(hedged_s) * 1e3, 2),
                 "gate_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)
