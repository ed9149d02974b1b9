"""The port's same-host SHM plane against the JAX package's, on the CPU.

(a) Both packages' ``ShmStore`` over their own ``TieredBlockStore``
    (MEM + SSD, the same seeded blocks) run the same seeded script of
    grants, renewals, releases, session closes, reaps and clock steps on
    a fake ``time.monotonic``: the same results, typed errors (by class
    name), stats and SHM pins after every step.
(b) The port's counterparts of the JAX ``TestShmStoreLeases`` and
    ``TestEvictionVsMapped`` (``tests/test_shm_smallread.py``): a leased
    (mapped) block is never evicted, an expired lease is reclaimed — on
    the fake clock, not on sleeps.
(c) On the wire: the port's ``ShmTransport`` against a JAX worker, and
    the JAX ``ShmTransport`` against the port's worker (each the one
    worker of a JAX ``LocalCluster``): the same bytes, segment-cache hits
    with no second lease, the typed errors arriving as the same class,
    and every lease gone after the session's cleanup.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_worker_store import JAX, PORT, make_store  # noqa: E402

KB = 1024
SESSION = 11


def _shm(pkg):
    import importlib

    prefix = "alluxio_tpu_torch" if pkg is PORT else "alluxio_tpu"
    return (importlib.import_module(f"{prefix}.worker.shm_store").ShmStore,
            importlib.import_module(f"{prefix}.shm"))


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


def put_block(store, block_id, data, tier="MEM"):
    store.create_block(SESSION, block_id, initial_bytes=len(data),
                       tier_alias=tier)
    with store.get_temp_writer(SESSION, block_id) as w:
        w.append(data)
    return store.commit_block(SESSION, block_id)


def outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return ("error", type(e).__name__)
    if isinstance(out, dict) and "path" in out:
        out = dict(out, path=out["path"].rsplit("/", 1)[-1])
    return ("ok", out)


# -- (a) seeded scripts -------------------------------------------------------
def _script(seed: int):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(60):
        op = rng.choice(["open", "open", "open", "renew", "release",
                         "close_session", "reap", "tick"])
        steps.append((str(op), int(rng.integers(1, 4)),
                      int(rng.integers(0, 9)), int(rng.integers(1, 12)),
                      float(rng.choice([0.2, 0.7, 1.5, 4.0]))))
    return steps


def _run(pkg, root, clock, seed):
    ShmStore, _ = _shm(pkg)
    store = make_store(pkg, root, mem_dirs=(16 * KB,), ssd_cap=16 * KB)
    for bid in range(1, 7):
        put_block(store, bid, bytes([bid]) * 700)
    put_block(store, 7, b"ssd" * 100, tier="SSD")  # not mappable
    shm = ShmStore(store, lease_ttl_s=2.0, max_leases=5)
    trace = []
    for op, session, bid, lease_id, dt in _script(seed):
        if op == "open":
            res = outcome(shm.open, session, bid)
        elif op == "renew":
            res = outcome(shm.renew, session, lease_id)
        elif op == "release":
            res = outcome(shm.release, session, lease_id)
        elif op == "close_session":
            res = outcome(shm.close_session, session)
        elif op == "reap":
            res = outcome(shm.reap_expired)
        else:
            clock.now += dt
            res = ("ok", None)
        trace.append((op, res, shm.stats(),
                      sorted(store.shm_leased_blocks)))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_lease_script_matches_jax(tmp_path, clock, seed):
    start = clock.now
    jax_trace = _run(JAX, tmp_path / "jax", clock, seed)
    clock.now = start
    port_trace = _run(PORT, tmp_path / "port", clock, seed)
    assert port_trace == jax_trace
    assert any(r[1][0] == "error" for r in port_trace)  # denials happen


# -- (b) the port's counterparts of the JAX lease and eviction tests --------
class TestShmStoreLeases:
    def test_grant_returns_mappable_segment(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 1, b"shm-bytes")
        shm = ShmStore(store, lease_ttl_s=30.0)
        lease = shm.open(SESSION, 1)
        assert lease["length"] == 9 and lease["ttl_s"] == 30.0
        with open(lease["path"], "rb") as f:
            assert f.read() == b"shm-bytes"
        assert shm.stats()["live_leases"] == 1
        assert 1 in store.shm_leased_blocks

    def test_only_top_tier_is_mappable(self, tmp_path):
        ShmStore, mod = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 2, b"on-ssd", tier="SSD")
        shm = ShmStore(store)
        with pytest.raises(mod.ShmSegmentUnavailableError):
            shm.open(SESSION, 2)
        with pytest.raises(mod.ShmSegmentUnavailableError):
            shm.open(SESSION, 999)

    def test_lease_table_full_denies(self, tmp_path):
        ShmStore, mod = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 1, b"a")
        put_block(store, 2, b"b")
        shm = ShmStore(store, max_leases=1)
        shm.open(SESSION, 1)
        with pytest.raises(mod.ShmLeaseDeniedError):
            shm.open(SESSION, 2)

    def test_renew_extends_release_drops(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 1, b"x")
        shm = ShmStore(store, lease_ttl_s=30.0)
        lid = shm.open(SESSION, 1)["lease_id"]
        assert shm.renew(SESSION, lid)["ok"]
        assert not shm.renew(SESSION + 1, lid)["ok"]
        assert shm.release(SESSION, lid)
        assert not shm.renew(SESSION, lid)["ok"]
        assert 1 not in store.shm_leased_blocks

    def test_close_session_releases_everything(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 1, b"a")
        put_block(store, 2, b"b")
        shm = ShmStore(store)
        shm.open(SESSION, 1)
        shm.open(SESSION, 2)
        keep = shm.open(SESSION + 1, 1)
        shm.close_session(SESSION)
        assert shm.stats() == {"live_leases": 1, "leased_blocks": 1,
                               "sessions": 1, "max_leases": 1024,
                               "lease_ttl_s": 30.0}
        assert shm.lease_of(keep["lease_id"]) is not None
        assert 1 in store.shm_leased_blocks

    def test_crashed_client_reclaimed_by_ttl(self, tmp_path, clock):
        ShmStore, _ = _shm(PORT)
        store = make_store(PORT, tmp_path)
        put_block(store, 1, b"x")
        shm = ShmStore(store, lease_ttl_s=0.1)  # floored at 1 s
        shm.open(SESSION, 1)
        clock.now += 0.9
        assert shm.reap_expired() == 0
        clock.now += 0.2
        assert shm.reap_expired() == 1
        assert shm.stats()["live_leases"] == 0
        assert 1 not in store.shm_leased_blocks


class TestEvictionVsMapped:
    def _store(self, tmp_path):
        return make_store(PORT, tmp_path, mem_dirs=(2 * KB,), ssd_cap=0)

    def test_leased_blocks_skip_eviction(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = self._store(tmp_path)
        put_block(store, 1, b"a" * KB)
        put_block(store, 2, b"b" * KB)
        shm = ShmStore(store, lease_ttl_s=30.0)
        lease = shm.open(SESSION, 1)
        with open(lease["path"], "rb") as f:
            import mmap

            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        store.access_block(2)  # the leased block is now the coldest
        put_block(store, 3, b"c" * KB)  # must evict 2, never leased 1
        report = store.block_report()["MEM"]
        assert 1 in report and 3 in report and 2 not in report
        assert mm[:KB] == b"a" * KB
        mm.close()

    def test_all_leased_means_out_of_space(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = self._store(tmp_path)
        put_block(store, 1, b"a" * KB)
        put_block(store, 2, b"b" * KB)
        shm = ShmStore(store)
        shm.open(SESSION, 1)
        shm.open(SESSION, 2)
        with pytest.raises(PORT.errors.WorkerOutOfSpaceError):
            put_block(store, 3, b"c" * KB)

    def test_expired_lease_is_evictable(self, tmp_path, clock):
        ShmStore, _ = _shm(PORT)
        store = self._store(tmp_path)
        put_block(store, 1, b"a" * KB)
        put_block(store, 2, b"b" * KB)
        shm = ShmStore(store, lease_ttl_s=1.0)
        shm.open(SESSION, 1)
        shm.open(SESSION, 2)
        clock.now += 1.1
        put_block(store, 3, b"c" * KB)  # expired pins reclaimed inline
        assert 3 in store.block_report()["MEM"]

    def test_remove_block_drops_the_pin(self, tmp_path):
        ShmStore, _ = _shm(PORT)
        store = self._store(tmp_path)
        put_block(store, 1, b"a" * KB)
        ShmStore(store).open(SESSION, 1)
        store.remove_block(1)
        assert 1 not in store.shm_leased_blocks

    def test_concurrent_grants_and_eviction_pressure(self, tmp_path):
        """Grants racing allocation pressure: a grant never holds the
        registry lock across the store's, so neither side deadlocks."""
        import sys

        ShmStore, mod = _shm(PORT)
        store = make_store(PORT, tmp_path, mem_dirs=(4 * KB,), ssd_cap=0)
        for i in range(4):
            put_block(store, i, bytes([i]) * KB)
        shm = ShmStore(store, lease_ttl_s=5.0)
        errors = []

        def leaser(bid):
            for _ in range(20):
                try:
                    lease = shm.open(SESSION, bid)
                    shm.release(SESSION, lease["lease_id"])
                except (mod.ShmLeaseDeniedError,
                        mod.ShmSegmentUnavailableError):
                    pass
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        def writer():
            for n in range(10):
                try:
                    put_block(store, 100 + n, b"w" * KB)
                except PORT.errors.WorkerOutOfSpaceError:
                    pass
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=leaser, args=(i,))
                       for i in range(4)] + [threading.Thread(target=writer)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert not errors
        assert shm.stats()["live_leases"] == 0
        assert not store.shm_leased_blocks


# -- (c) on the wire, both ways ----------------------------------------------
BLOCK = 64 * KB


@pytest.fixture(params=["jax-worker", "port-worker"])
def wire(request, tmp_path):
    """(worker address, its ShmStore, block ids with their bytes) for a
    JAX worker or the port's, each the one worker of a JAX cluster with
    two blocks written ``MUST_CACHE``."""
    from alluxio_tpu.minicluster import LocalCluster

    from tests.testutils.torch_worker import PortWorker

    jax_side = request.param == "jax-worker"
    with LocalCluster(str(tmp_path), num_workers=1 if jax_side else 0,
                      block_size=BLOCK) as cluster:
        pw = None
        if jax_side:
            w = cluster.workers[0]
            address, shm = w.address, w.worker.shm_store
        else:
            pw = PortWorker(cluster, str(tmp_path))
            address, shm = f"localhost:{pw.port}", pw.worker.shm_store
        try:
            fs = cluster.file_system()
            blocks = {}
            for i in range(2):
                data = np.random.default_rng(60 + i).integers(
                    0, 256, BLOCK, dtype=np.uint8).tobytes()
                fs.write_all(f"/s{i}", data, write_type="MUST_CACHE")
                blocks[fs.get_status(f"/s{i}").block_ids[0]] = data
            fs.close()
            yield address, shm, blocks
        finally:
            if pw is not None:
                pw.stop()


def _client_side(side: str):
    import importlib

    prefix = "alluxio_tpu_torch" if side == "port" else "alluxio_tpu"
    return (importlib.import_module(f"{prefix}.rpc.clients").WorkerClient,
            importlib.import_module(f"{prefix}.client.shm_transport"
                                    ).ShmTransport,
            importlib.import_module(f"{prefix}.shm"))


def _transport_script(side, address, shm, blocks):
    """Reads, cache hits, typed errors and session cleanup through one
    package's ShmTransport against one worker; returns what it saw."""
    from alluxio_tpu_torch.utils import ids

    WorkerClient, ShmTransport, errors = _client_side(side)
    client = WorkerClient(address)
    session = ids.create_session_id()
    t = ShmTransport(session, cache_max=1)
    seen = []
    (b0, d0), (b1, d1) = blocks.items()
    s = t.open_stream(client, b0)
    seen.append(("pread", s.pread(100, 300) == d0[100:400],
                 s.numpy_view().tobytes() == d0, s.last_source))
    seen.append(("many", s.pread_many([0, 5, BLOCK - 3], [4, 0, 9]) ==
                 [d0[0:4], b"", d0[BLOCK - 3:]]))
    stats = shm.stats()
    t.open_stream(client, b0)  # a segment-cache hit: no new lease
    seen.append(("hit", shm.stats() == stats, t.cached_blocks()))
    t.open_stream(client, b1)  # evicts b0's segment and releases it
    seen.append(("lru", shm.stats()["live_leases"], t.cached_blocks()))
    for bad in (999_999,):
        try:
            t.open_stream(client, bad)
            seen.append(("missing", "no error"))
        except Exception as e:  # noqa: BLE001
            seen.append(("missing", type(e).__name__,
                         type(e) is errors.ShmSegmentUnavailableError))
    old_max = shm.max_leases
    shm.max_leases = 1
    try:
        t2 = ShmTransport(ids.create_session_id())
        t2.open_stream(client, b0)
        seen.append(("full", "no error"))
    except Exception as e:  # noqa: BLE001
        seen.append(("full", type(e).__name__,
                     type(e) is errors.ShmLeaseDeniedError))
    finally:
        shm.max_leases = old_max
    client.cleanup_session(session)
    t.close()
    seen.append(("cleanup", shm.stats()["live_leases"]))
    return seen


def test_transports_interoperate(wire):
    """The JAX transport and the port's against the same worker: the
    same observations, typed errors arriving as each side's own class."""
    address, shm, blocks = wire
    jax_seen = _transport_script("jax", address, shm, blocks)
    port_seen = _transport_script("port", address, shm, blocks)
    assert port_seen == jax_seen
    assert jax_seen == [
        ("pread", True, True, "SHM"), ("many", True), ("hit", True, 1),
        ("lru", 1, 1), ("missing", "ShmSegmentUnavailableError", True),
        ("full", "ShmLeaseDeniedError", True), ("cleanup", 0)]


def test_shm_loader_on_cpu(tmp_path):
    """The card test's SHM case on the CPU: blocks read through the SHM
    rung into the loader equal their files, the native pre-fault ran for
    each, and no lease or pin is left after close."""
    from tests.testutils.torch_worker import shm_loader_case

    shm_loader_case(tmp_path, "cpu", words=1 << 16)
