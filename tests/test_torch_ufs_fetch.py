"""The port's striped, coalescing cold fetch against the JAX package's, on
the CPU (the counterparts of ``tests/test_ufs_fetch.py``).

Every scenario runs once on each package — its ``build_store_from_conf``,
``UfsBlockFetcher``, ``AsyncCacheManager`` and ``LocalUnderFileSystem`` —
with the same payloads, made from a seed with numpy, and returns what it
observed: the bytes served, the UFS reads made, the counters moved, the
store's state. The port's observations must equal the JAX package's, and
both must meet the JAX test's own expectations.

On the wire: a cold block read through ``read_block`` from the port's
worker by the JAX client and by the port's client, and from a JAX worker
by the port's client, gives the same bytes, chunk offsets, sources and
counters as the JAX client reading the JAX worker.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

KB = 1024
PACKAGES = ("jax", "port")


def _pkg(name, tmp_path):
    """One package's fetch pipeline, a store (a 64 MiB MEM tier and an
    SSD tier under ``tmp_path``) and its metrics registry."""
    if name == "jax":
        from alluxio_tpu.conf import Configuration, Keys
        from alluxio_tpu.metrics import metrics
        from alluxio_tpu.underfs.local import LocalUnderFileSystem
        from alluxio_tpu.worker import ufs_fetch, ufs_io
        from alluxio_tpu.worker.process import build_store_from_conf
    else:
        from alluxio_tpu_torch.conf import Configuration, Keys
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.underfs.local import LocalUnderFileSystem
        from alluxio_tpu_torch.worker import ufs_fetch, ufs_io
        from alluxio_tpu_torch.worker.process import build_store_from_conf
    root = tmp_path / name
    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_DATA_FOLDER, str(root / "worker"))
    conf.set(Keys.WORKER_SHM_DIR, str(root / "shm"))
    conf.set(Keys.WORKER_RAMDISK_SIZE, 64 << 20)
    ufs_dir = root / "ufs"
    ufs_dir.mkdir(parents=True)
    return SimpleNamespace(
        name=name, conf=conf, Keys=Keys, store=build_store_from_conf(conf),
        ufs_dir=ufs_dir, local=lambda: LocalUnderFileSystem(str(ufs_dir)),
        FetchConf=ufs_fetch.FetchConf, Fetcher=ufs_fetch.UfsBlockFetcher,
        FetchError=ufs_fetch.FetchError, plan_stripes=ufs_fetch.plan_stripes,
        Desc=ufs_io.UfsBlockDescriptor, Async=ufs_io.AsyncCacheManager,
        count=lambda n: metrics().counter(n).count)


def _both(tmp_path, scenario, *args):
    """Run ``scenario(P, *args)`` on each package; the port's observation
    must equal the JAX package's."""
    got = {n: scenario(_pkg(n, tmp_path), *args) for n in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]


def _payload(seed, length):
    return np.random.default_rng(seed).integers(
        0, 256, length, dtype=np.uint8).tobytes()


def _write(P, name, length, seed):
    payload = _payload(seed, length)
    (P.ufs_dir / name).write_bytes(payload)
    return str(P.ufs_dir / name), payload


class RecordingUfs:
    """Counts every ranged read of a package's local UFS; optionally
    gates offsets behind events, rejects sub-block ranges or fails."""

    def __init__(self, delegate):
        self._delegate = delegate
        self.calls = []  # (offset, length)
        self.lock = threading.Lock()
        self.gates = {}  # offset -> threading.Event
        self.gate_all = None
        self.reject_ranged_below = None
        self.fail_all = False

    def read_range(self, path, offset, length):
        with self.lock:
            self.calls.append((offset, length))
        gate = self.gates.get(offset) or self.gate_all
        if gate is not None:
            assert gate.wait(20), "test gate never released"
        if self.fail_all:
            raise OSError("UFS down")
        if self.reject_ranged_below is not None and \
                length < self.reject_ranged_below:
            raise OSError("ranged reads unsupported")
        return self._delegate.read_range(path, offset, length)

    def offsets(self):
        return sorted(o for o, _ in self.calls)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# -- reassembly ---------------------------------------------------------------
def _reassembly(P, length, stripe):
    path, payload = _write(P, f"obj-{length}-{stripe}", length,
                           seed=length * 31 + stripe)
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=stripe, concurrency=3, per_mount_limit=4))
    try:
        bid = length * 100_003 + stripe
        desc = P.Desc(block_id=bid, ufs_path=path, offset=0, length=length)
        fetch = fetcher.fetch(P.local(), desc, cache=True)
        assert fetch.result() == payload
        assert fetch.wait_done(10)
        cached = None
        if length > 0:
            with P.store.get_reader(bid) as r:
                cached = r.read(0, length)
            assert cached == payload
        # odd sub-ranges stream back the same bytes a pread would give
        rng = np.random.default_rng(7)
        fetch2 = fetcher.fetch(P.local(), P.Desc(
            block_id=bid + 1, ufs_path=path, offset=0, length=length),
            cache=False)
        ranges = []
        for _ in range(4):
            off = int(rng.integers(0, length + 1)) if length else 0
            ln = int(rng.integers(0, length - off + 1)) if length else 0
            chunks = list(fetch2.iter_range(off, ln, chunk_size=97))
            assert b"".join(chunks) == payload[off:off + ln]
            ranges.append((off, ln, [len(c) for c in chunks]))
        return (fetch.stripes, ranges, P.store.has_block(bid + 1))
    finally:
        fetcher.close()


@pytest.mark.parametrize("length,stripe", [
    (1, 1), (5, 2), (1023, 100), (4097, 512), (8192, 8192),
    (10_000, 3_333), (777, 1_000), (65_537, 4_096), (0, 64),
])
def test_stripe_reassembly_matches_jax(tmp_path, length, stripe):
    _both(tmp_path, _reassembly, length, stripe)


def _interior(P):
    path, payload = _write(P, "big", 10_000, seed=3)
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=700, concurrency=2, per_mount_limit=4))
    try:
        desc = P.Desc(block_id=42, ufs_path=path, offset=1234, length=5000)
        ufs = RecordingUfs(P.local())
        got = fetcher.fetch(ufs, desc, cache=False).result()
        assert got == payload[1234:6234]
        return got, ufs.offsets()
    finally:
        fetcher.close()


def test_block_interior_offset(tmp_path):
    """A block that starts mid-file stripes over file coordinates and
    serves block-relative bytes."""
    _, offsets = _both(tmp_path, _interior)
    assert offsets == list(range(1234, 6234, 700))


# -- streaming ----------------------------------------------------------------
def _first_chunk(P):
    path, payload = _write(P, "gated", 400, seed=1)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    for off in (100, 200, 300):  # stripe 0 flows; the rest are held
        ufs.gates[off] = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=100, concurrency=1, per_mount_limit=2))
    try:
        desc = P.Desc(block_id=9, ufs_path=path, offset=0, length=400)
        fetch = fetcher.fetch(ufs, desc, cache=True)
        it = fetch.iter_range(0, 400, chunk_size=100)
        first = next(it)  # arrives while stripes 1..3 are blocked
        assert first == payload[:100] and not fetch.done
        coalesced0 = P.count("Worker.UfsFetchCoalesced")
        again = fetcher.fetch(ufs, desc, cache=True)
        assert again is fetch and fetch.waiters == 2
        coalesced = P.count("Worker.UfsFetchCoalesced") - coalesced0
        got = {}

        def drain_b():
            got["b"] = [len(c) for c in again.iter_range(0, 400,
                                                          chunk_size=64)]

        tb = threading.Thread(target=drain_b)
        tb.start()
        release.set()
        rest = list(it)
        tb.join(10)
        assert first + b"".join(rest) == payload
        assert fetch.wait_done(10)  # cache commit trails the last byte
        return (coalesced, got["b"], ufs.offsets(), P.store.has_block(9))
    finally:
        release.set()
        fetcher.close()


def test_first_chunk_streams_before_block_completes(tmp_path):
    coalesced, chunks_b, offsets, cached = _both(tmp_path, _first_chunk)
    assert coalesced == 1 and sum(chunks_b) == 400
    assert offsets == [0, 100, 200, 300] and cached


# -- fallback -----------------------------------------------------------------
def _ranged_rejection(P):
    path, payload = _write(P, "noranged", 4_000, seed=2)
    ufs = RecordingUfs(P.local())
    ufs.reject_ranged_below = 4_000  # every sub-block range errors
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=1_000, concurrency=2, per_mount_limit=4))
    try:
        fb0 = P.count("Worker.UfsFetchFallbacks")
        desc = P.Desc(block_id=11, ufs_path=path, offset=0, length=4_000,
                      mount_id=5)
        fetch = fetcher.fetch(ufs, desc, cache=True)
        assert fetch.result() == payload and fetch.wait_done(10)
        full_read = (0, 4_000) in ufs.calls
        # the mount is remembered: the next fetch is one whole-block read
        ufs.calls.clear()
        desc2 = P.Desc(block_id=12, ufs_path=path, offset=0, length=4_000,
                       mount_id=5)
        assert fetcher.fetch(ufs, desc2, cache=False).result() == payload
        return (fetch.fallback, P.count("Worker.UfsFetchFallbacks") - fb0,
                P.store.has_block(11), full_read, ufs.calls,
                5 in fetcher._unstriped_mounts)
    finally:
        fetcher.close()


def test_ranged_rejection_falls_back_to_single_range(tmp_path):
    assert _both(tmp_path, _ranged_rejection) == \
        (True, 1, True, True, [(0, 4_000)], True)


def _total_failure(P):
    path, payload = _write(P, "down", 2_000, seed=4)
    ufs = RecordingUfs(P.local())
    ufs.fail_all = True
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=500, concurrency=2, per_mount_limit=4))
    try:
        f0 = P.count("Worker.UfsFetchFailures")
        desc = P.Desc(block_id=13, ufs_path=path, offset=0, length=2_000)
        fetch = fetcher.fetch(ufs, desc, cache=True)
        with pytest.raises(P.FetchError):
            fetch.result()
        with pytest.raises(P.FetchError):
            b"".join(fetch.iter_range(0, 10))
        cached_after_failure = P.store.has_block(13)
        # registry cleanup trails the error wake-up
        assert _wait(lambda: not fetcher.in_flight(13))
        ufs.fail_all = False
        assert fetcher.fetch(ufs, desc, cache=True).result() == payload
        assert _wait(lambda: P.store.has_block(13))
        return (cached_after_failure,
                P.count("Worker.UfsFetchFailures") - f0)
    finally:
        fetcher.close()


def test_total_failure_raises_for_every_waiter_then_retries(tmp_path):
    """A failure reaches every waiter, aborts the fill, and the next read
    tries the UFS again."""
    assert _both(tmp_path, _total_failure) == (False, 1)


# -- coalescing ---------------------------------------------------------------
def _concurrent_readers(P):
    path, payload = _write(P, "hot", 4_000, seed=5)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    ufs.gate_all = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=1_000, concurrency=4, per_mount_limit=8))
    try:
        started0 = P.count("Worker.UfsFetchStarted")
        coalesced0 = P.count("Worker.UfsFetchCoalesced")
        desc = P.Desc(block_id=21, ufs_path=path, offset=0, length=4_000)
        first = fetcher.fetch(ufs, desc, cache=True)
        results = []

        def read():
            results.append(fetcher.fetch(ufs, desc, cache=True).result())

        threads = [threading.Thread(target=read) for _ in range(8)]
        for t in threads:
            t.start()
        # all 8 attach BEFORE any byte lands
        assert _wait(lambda: first.waiters == 9)
        release.set()
        for t in threads:
            t.join(10)
        assert results == [payload] * 8 and first.result() == payload
        assert first.wait_done(10)
        return (ufs.offsets(), P.count("Worker.UfsFetchStarted") - started0,
                P.count("Worker.UfsFetchCoalesced") - coalesced0,
                P.store.has_block(21))
    finally:
        release.set()
        fetcher.close()


def test_concurrent_cold_readers_share_one_ufs_fetch(tmp_path):
    assert _both(tmp_path, _concurrent_readers) == \
        ([0, 1_000, 2_000, 3_000], 1, 8, True)


def _shrunk(P):
    path, payload = _write(P, "shrunk", 1_500, seed=11)
    ufs = RecordingUfs(P.local())
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=500, concurrency=2, per_mount_limit=4))
    try:
        desc = P.Desc(block_id=70, ufs_path=path, offset=0, length=2_000,
                      mount_id=9)
        fetch = fetcher.fetch(ufs, desc, cache=True)
        assert fetch.result() == payload  # 1500 B, not zero-padded
        assert b"".join(fetch.iter_range(0, 2_000)) == payload
        assert fetch.wait_done(10)
        with P.store.get_reader(70) as r:
            cached = (r.length, r.read(0, 1_500) == payload)
        demoted = 9 in fetcher._unstriped_mounts
        # every stripe past EOF: still not the range-rejection signature
        desc2 = P.Desc(block_id=72, ufs_path=path, offset=1_400,
                       length=2_000, mount_id=9)
        fetch2 = fetcher.fetch(ufs, desc2, cache=False)
        assert fetch2.result() == payload[1_400:]
        assert fetch2.wait_done(10)
        return (cached, demoted, fetch2.any_stripe_ok, fetch2.fallback_ok,
                9 in fetcher._unstriped_mounts, P.store.has_block(72))
    finally:
        fetcher.close()


def test_shrunk_ufs_object_serves_available_bytes(tmp_path):
    assert _both(tmp_path, _shrunk) == \
        ((1_500, True), False, False, True, False, False)


def _transient(P):
    path, payload = _write(P, "flaky", 2_000, seed=12)

    class FlakyUfs(RecordingUfs):
        trips = 0

        def read_range(self, p, o, length):
            # fail both attempts of stripe +1000 (one failure is absorbed
            # by the per-stripe retry)
            if o == 1_000 and self.trips < 2:
                self.trips += 1
                with self.lock:
                    self.calls.append((o, length))
                raise OSError("transient 500")
            return super().read_range(p, o, length)

    ufs = FlakyUfs(P.local())
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=500, concurrency=1, per_mount_limit=4))
    try:
        desc = P.Desc(block_id=71, ufs_path=path, offset=0, length=2_000,
                      mount_id=8)
        fetch = fetcher.fetch(ufs, desc, cache=False)
        assert fetch.result() == payload  # the fallback rescued the read
        first = (fetch.fallback, 8 in fetcher._unstriped_mounts)
        ufs.trips = 1  # the next +1000 read fails once, then succeeds
        desc2 = P.Desc(block_id=73, ufs_path=path, offset=0, length=2_000,
                       mount_id=8)
        fetch2 = fetcher.fetch(ufs, desc2, cache=False)
        assert fetch2.result() == payload
        return first, fetch2.fallback
    finally:
        fetcher.close()


def test_transient_stripe_error_does_not_demote_mount(tmp_path):
    assert _both(tmp_path, _transient) == ((True, False), False)


def _async_close(P):
    path, _ = _write(P, "pill", 100, seed=13)
    mgr = P.Async(P.store, lambda mount_id: P.local(), fetcher=None,
                  num_threads=3, queue_max=1)
    mgr.close()
    for t in mgr._threads:
        t.join(5)
    return (any(t.is_alive() for t in mgr._threads),
            mgr.submit(P.Desc(block_id=80, ufs_path=path, offset=0,
                              length=100)))


def test_async_cache_close_stops_all_threads_with_tiny_queue(tmp_path):
    assert _both(tmp_path, _async_close) == (False, False)


def _caching_join(P):
    path, payload = _write(P, "upgrade", 2_000, seed=9)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    ufs.gate_all = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=500, concurrency=2, per_mount_limit=4))
    try:
        desc = P.Desc(block_id=60, ufs_path=path, offset=0, length=2_000)
        first = fetcher.fetch(ufs, desc, cache=False)
        joined = fetcher.fetch(ufs, desc, cache=True)
        assert joined is first
        release.set()
        assert joined.result() == payload and joined.wait_done(10)
        return P.store.has_block(60), ufs.offsets()
    finally:
        release.set()
        fetcher.close()


def test_caching_join_upgrades_noncache_fetch(tmp_path):
    assert _both(tmp_path, _caching_join) == \
        (True, [0, 500, 1_000, 1_500])


def _late_caching_join(P):
    path, payload = _write(P, "lateupg", 400, seed=10)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    for off in (100, 200, 300):  # stripe 0 lands; the rest held
        ufs.gates[off] = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=100, concurrency=1, per_mount_limit=2))
    try:
        desc = P.Desc(block_id=61, ufs_path=path, offset=0, length=400)
        first = fetcher.fetch(ufs, desc, cache=False)
        it = first.iter_range(0, 400, chunk_size=100)
        assert next(it) == payload[:100]  # the frontier has moved
        joined = fetcher.fetch(ufs, desc, cache=True)
        assert joined is first
        release.set()
        assert joined.result() == payload and joined.wait_done(10)
        with P.store.get_reader(61) as r:
            assert r.read(0, 400) == payload
        return P.store.has_block(61), ufs.offsets()
    finally:
        release.set()
        fetcher.close()


def test_late_caching_join_fills_from_buffer(tmp_path):
    assert _both(tmp_path, _late_caching_join) == \
        (True, [0, 100, 200, 300])


# -- async cache --------------------------------------------------------------
def _bounded_queue(P):
    path, _ = _write(P, "q", 1_000, seed=6)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    ufs.gate_all = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=1_000, concurrency=1, per_mount_limit=2))
    mgr = P.Async(P.store, lambda mount_id: ufs, fetcher=fetcher,
                  num_threads=1, queue_max=1)
    try:
        rej0 = P.count("Worker.AsyncCacheRejected")
        descs = [P.Desc(block_id=30 + i, ufs_path=path, offset=0,
                        length=1_000) for i in range(3)]
        accepted = [mgr.submit(descs[0])]
        # the cache thread takes descs[0] off the queue
        assert _wait(lambda: mgr._queue.qsize() == 0)
        accepted += [mgr.submit(descs[1]), mgr.submit(descs[2])]
        rejected = P.count("Worker.AsyncCacheRejected") - rej0
        release.set()
        assert mgr.wait_idle()
        return (accepted, rejected,
                [P.store.has_block(30 + i) for i in range(3)])
    finally:
        release.set()
        mgr.close()
        fetcher.close()


def test_async_cache_bounded_queue_rejects_and_counts(tmp_path):
    assert _both(tmp_path, _bounded_queue) == \
        ([True, True, False], 1, [True, True, False])


def _dedupe(P):
    path, payload = _write(P, "dedupe", 2_000, seed=7)
    ufs = RecordingUfs(P.local())
    release = threading.Event()
    ufs.gate_all = release
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=500, concurrency=2, per_mount_limit=4))
    mgr = P.Async(P.store, lambda mount_id: ufs, fetcher=fetcher,
                  num_threads=1, queue_max=8)
    try:
        desc = P.Desc(block_id=50, ufs_path=path, offset=0, length=2_000)
        foreground = fetcher.fetch(ufs, desc, cache=True)
        # a passive-cache request for a block already being read through
        # is a no-op, not a second UFS fetch
        accepted = mgr.submit(desc)
        release.set()
        assert foreground.result() == payload and foreground.wait_done(10)
        return accepted, ufs.offsets(), P.store.has_block(50)
    finally:
        release.set()
        mgr.close()
        fetcher.close()


def test_async_cache_dedupes_against_foreground_fetch(tmp_path):
    assert _both(tmp_path, _dedupe) == \
        (False, [0, 500, 1_000, 1_500], True)


# -- configuration and the stripe planner -------------------------------------
def _conf_defaults(P):
    fc = P.FetchConf.from_conf(P.conf)
    return (fc.stripe_size, fc.concurrency, fc.per_mount_limit,
            fc.qos_enabled, fc.tenant_limit,
            P.conf.get_int(P.Keys.WORKER_ASYNC_CACHE_QUEUE_MAX),
            P.conf.get_int(P.Keys.WORKER_ASYNC_CACHE_THREADS))


def test_fetch_span_names_tenant_and_class(tmp_path):
    """The port's fetch span (tags the JAX span lacks) names the starting
    caller's tenant and the fetch's final class: a PREFETCH fetch that an
    on-demand reader joins while its stripes are held ends ON_DEMAND."""
    from alluxio_tpu_torch.qos import ON_DEMAND, PREFETCH
    from alluxio_tpu_torch.utils import tracing

    P = _pkg("port", tmp_path)
    path, payload = _write(P, "tagged", 4_000, seed=21)
    ufs = RecordingUfs(P.local())
    ufs.gate_all = threading.Event()
    fetcher = P.Fetcher(P.store, P.FetchConf(
        stripe_size=1_000, concurrency=2, per_mount_limit=4,
        qos_enabled=True, tenant_limit=8))
    tracing.set_tracing_enabled(True)
    since_ms = time.time() * 1000.0
    try:
        held = fetcher.fetch(ufs, P.Desc(block_id=81, ufs_path=path,
                                         offset=0, length=4_000),
                             cache=False, priority=PREFETCH, tenant="flood")
        joined = fetcher.fetch(ufs, P.Desc(block_id=81, ufs_path=path,
                                           offset=0, length=4_000),
                               cache=False, priority=ON_DEMAND,
                               tenant="victim")
        assert joined is held
        alone = fetcher.fetch(ufs, P.Desc(block_id=82, ufs_path=path,
                                          offset=0, length=4_000),
                              cache=False, priority=PREFETCH, tenant="bulk")
        ufs.gate_all.set()
        assert held.result() == payload == alone.result()
        assert held.wait_done(10) and alone.wait_done(10)
        spans = {sp["tags"]["block_id"]: sp for sp in
                 tracing.tracer().snapshot(limit=1 << 12)
                 if sp["name"] == "atpu.worker.ufs_fetch"
                 and sp["start_ms"] >= since_ms}
    finally:
        tracing.set_tracing_enabled(False)
        ufs.gate_all.set()
        fetcher.close()
    tags = {b: tuple(sp["tags"][k] for k in ("tenant", "class", "waiters"))
            for b, sp in spans.items()}
    assert tags == {"81": ("flood", "ON_DEMAND", "2"),
                    "82": ("bulk", "PREFETCH", "1")}


def test_conf_defaults_match_jax(tmp_path):
    assert _both(tmp_path, _conf_defaults) == \
        (4 << 20, 4, 16, False, 8, 512, 2)


def test_plan_stripes_matches_jax():
    """A seeded sweep of (length, stripe) pairs plans the same stripes in
    both packages, each plan covering the block exactly."""
    from alluxio_tpu.worker.ufs_fetch import plan_stripes as jax_plan
    from alluxio_tpu_torch.worker.ufs_fetch import plan_stripes

    rng = np.random.default_rng(17)
    pairs = [(n, s) for n in (0, 1, 99, 100, 101, 1_000_003)
             for s in (1, 7, 100, 1 << 20)]
    pairs += [(int(n), int(s)) for n, s in zip(
        rng.integers(-3, 1 << 22, 200), rng.integers(1, 1 << 20, 200))]
    for length, stripe in pairs:
        plan = plan_stripes(length, stripe)
        assert plan == jax_plan(length, stripe), (length, stripe)
        assert plan[0][0] == 0
        covered = 0
        for off, ln in plan:
            assert off == covered
            covered += ln
        assert covered == max(0, length)


# -- the worker's read_block --------------------------------------------------
def _read_block_in_process(P):
    """``read_block`` of the package's worker service, called in process,
    on a cold block with a UFS descriptor: chunks tagged UFS, the block
    cached after, a warm re-read served from the store."""
    if P.name == "jax":
        from alluxio_tpu.rpc.worker_service import worker_service
        from alluxio_tpu.underfs.registry import UfsManager
        from alluxio_tpu.worker.process import BlockWorker
    else:
        from alluxio_tpu_torch.rpc.worker_service import worker_service
        from alluxio_tpu_torch.underfs.registry import UfsManager
        from alluxio_tpu_torch.worker.process import BlockWorker
    from tests.testutils.torch_worker import StandInMaster

    P.conf.set(P.Keys.WORKER_RAMDISK_SIZE, 16 * KB)
    path, payload = _write(P, "obj", 3 * KB, seed=8)
    ufs = UfsManager()
    ufs.add_mount(3, str(P.ufs_dir))
    worker = BlockWorker(P.conf, StandInMaster(), ufs_manager=ufs)
    worker._master_sync.register_with_master()
    try:
        read_block = worker_service(worker).methods["read_block"][0]
        chunks = list(read_block({
            "block_id": 77, "chunk_size": 512,
            "ufs": {"ufs_path": path, "offset": 0, "length": KB,
                    "mount_id": 3}}))
        assert b"".join(c["data"] for c in chunks) == payload[:KB]
        cached = worker.store.has_block(77)
        warm = list(read_block({"block_id": 77}))
        assert b"".join(c["data"] for c in warm) == payload[:KB]
        return ([(c["offset"], len(c["data"]), c["source"])
                 for c in chunks], cached,
                [c["source"] != "UFS" for c in warm])
    finally:
        worker.stop()


def test_cold_read_block_streams_and_caches(tmp_path):
    chunks, cached, warm = _both(tmp_path, _read_block_in_process)
    assert chunks == [(0, 512, "UFS"), (512, 512, "UFS")]
    assert cached and all(warm)


# -- on the wire, both ways ---------------------------------------------------
WIRE_BLOCK = 64 * KB
WIRE_STRIPE = 16 * KB
WIRE_CHUNK = 24 * KB
WORKER_COUNTERS = ("Worker.UfsFetchStarted", "Worker.UfsFetchBytes",
                   "Worker.UfsBlocksRead", "Worker.UfsBytesRead",
                   "Worker.BlocksServed.UFS", "Worker.BytesServed.UFS",
                   "Worker.UfsFetchFallbacks", "Worker.UfsFetchFailures")


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """A JAX cluster with one JAX worker and the port's worker beside it,
    both striping cold fetches at 16 KiB, and a file persisted in the
    UFS only."""
    from alluxio_tpu.conf import Keys as JaxKeys
    from alluxio_tpu.minicluster import LocalCluster
    from alluxio_tpu_torch.conf import Keys

    from tests.testutils.torch_worker import PortWorker

    base = tmp_path_factory.mktemp("wire")
    with LocalCluster(str(base), num_workers=1, block_size=WIRE_BLOCK,
                      conf_overrides={
                          JaxKeys.USER_SHM_ENABLED: False,
                          JaxKeys.WORKER_UFS_FETCH_STRIPE_SIZE:
                              WIRE_STRIPE}) as c:
        pw = PortWorker(c, str(base), conf_overrides={
            Keys.WORKER_UFS_FETCH_STRIPE_SIZE: WIRE_STRIPE})
        payload = _payload(90, WIRE_BLOCK)
        fs = c.file_system()
        fs.write_all("/cold", payload, write_type="THROUGH")
        fs.close()
        fsm = c.fs_client()
        info = fsm.get_status("/cold")
        bid = fsm.get_file_block_info_list("/cold")[0].block_info.block_id
        ufs = {"ufs_path": info.ufs_path, "offset": 0,
               "length": WIRE_BLOCK, "mount_id": info.mount_id}
        try:
            yield SimpleNamespace(cluster=c, pw=pw, payload=payload,
                                  block_id=bid, ufs=ufs)
        finally:
            pw.stop()


def _cold_read(wire, client_side, worker_side):
    """One cold ``read_block`` of the file's block by ``client_side``'s
    ``WorkerClient`` from ``worker_side``'s worker; returns the chunks
    (offset, length, source), the bytes and the serving worker's counter
    deltas, then makes the block cold again."""
    if worker_side == "jax":
        from alluxio_tpu.metrics import metrics
        worker = wire.cluster.workers[0].worker
        address = wire.cluster.workers[0].address
    else:
        from alluxio_tpu_torch.metrics import metrics
        worker = wire.pw.worker
        address = f"127.0.0.1:{wire.pw.port}"
    if client_side == "jax":
        from alluxio_tpu.rpc.clients import WorkerClient
    else:
        from alluxio_tpu_torch.rpc.clients import WorkerClient
    if worker.store.has_block(wire.block_id):
        worker.store.remove_block(wire.block_id)
    m = metrics()
    before = {n: m.counter(n).count for n in WORKER_COUNTERS}
    client = WorkerClient(address)
    chunks = list(client.read_block(wire.block_id, chunk_size=WIRE_CHUNK,
                                    ufs=wire.ufs))
    cached = worker.store.has_block(wire.block_id)
    worker.store.remove_block(wire.block_id)
    return ([(c["offset"], len(c["data"]), c["source"]) for c in chunks],
            b"".join(c["data"] for c in chunks),
            {n: m.counter(n).count - before[n] for n in WORKER_COUNTERS},
            cached)


@pytest.mark.parametrize("client_side,worker_side", [
    ("jax", "port"), ("port", "port"), ("port", "jax")])
def test_cold_read_block_on_the_wire_matches_jax(wire, client_side,
                                                 worker_side):
    want = _cold_read(wire, "jax", "jax")
    got = _cold_read(wire, client_side, worker_side)
    assert got == want
    chunks, data, counters, cached = got
    assert data == wire.payload and cached
    # chunks end at stripe boundaries: 16 KiB stripes, 24 KiB chunks
    assert chunks == [(o, WIRE_STRIPE, "UFS")
                      for o in range(0, WIRE_BLOCK, WIRE_STRIPE)]
    assert counters["Worker.UfsFetchStarted"] == 1
    assert counters["Worker.UfsFetchBytes"] == WIRE_BLOCK
    assert counters["Worker.UfsBlocksRead"] == 1
    assert counters["Worker.UfsFetchFallbacks"] == 0


def test_cold_fetch_into_the_device_tier_on_cpu(tmp_path):
    """The card test's cold-fetch case (``tests/test_torch_cuda.py``) on
    the CPU: blocks the worker fetches striped from the UFS, streamed
    into the loader's device tier and scanned; the scan equals the JAX
    package's ``scaled_sum`` of the same blocks."""
    import jax.numpy as jnp

    from alluxio_tpu.ops import reduce_kernel as jax_rk
    from tests.testutils.torch_worker import cold_fetch_loader_case

    got = cold_fetch_loader_case(tmp_path, "cpu", n=2, words=1 << 18,
                                 stripe_bytes=256 * KB)
    data = np.concatenate([np.random.default_rng(500 + i).integers(
        -2**31, 2**31 - 1, size=1 << 18, dtype=np.int32) for i in range(2)])
    want = int(jax_rk.scaled_sum(jax_rk.pad_to_kernel_shape(
        jnp.asarray(data)), jnp.int32(3), interpret=True))
    assert got == want


@pytest.mark.parametrize("worker_side", ["jax", "port"])
def test_cancelled_cold_stream_still_caches(wire, worker_side):
    """A client that cancels a cold ``read_block`` after its first chunk
    releases the stream; the fetch runs on, its fill commits, and the
    registry lets the block go — on the port's worker as on the JAX
    worker."""
    from alluxio_tpu_torch.rpc.clients import WorkerClient

    if worker_side == "jax":
        worker = wire.cluster.workers[0].worker
        address = wire.cluster.workers[0].address
    else:
        worker = wire.pw.worker
        address = f"127.0.0.1:{wire.pw.port}"
    if worker.store.has_block(wire.block_id):
        worker.store.remove_block(wire.block_id)
    call = WorkerClient(address).read_block_stream(
        wire.block_id, chunk_size=WIRE_STRIPE, ufs=wire.ufs)
    it = iter(call)
    first = next(it)
    call.cancel()
    assert list(it) == []
    assert first["offset"] == 0 and first["source"] == "UFS"
    assert first["data"] == wire.payload[:WIRE_STRIPE]
    assert _wait(lambda: worker.store.has_block(wire.block_id), 10)
    assert _wait(lambda: not worker.ufs_fetcher.in_flight(wire.block_id))
    with worker.store.get_reader(wire.block_id) as r:
        assert r.read(0, WIRE_BLOCK) == wire.payload
    worker.store.remove_block(wire.block_id)
