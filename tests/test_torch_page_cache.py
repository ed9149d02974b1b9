"""The port's client page cache (``alluxio_tpu_torch.client.cache``) on
the CPU against the JAX package's: one put/get/delete script through both
managers gives the same answers, hits, misses, evictions and stats; the
device tier promotes and then hits with the JAX device page's bytes;
pages cross between the two packages' ``LocalPageStore``s; and
``CachingFileInStream`` serves the JAX stream's bytes (all exact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.client.cache import manager as jm  # noqa: E402
from alluxio_tpu.client.cache import page_store as jps  # noqa: E402
from alluxio_tpu.client.cache.evictor import \
    CacheEvictor as JaxEvictor  # noqa: E402
from alluxio_tpu.client.cache.meta import PageId as JaxPageId  # noqa: E402
from alluxio_tpu.metrics import metrics as jax_metrics  # noqa: E402
from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore  # noqa: E402
from alluxio_tpu_torch.client.cache.manager import \
    LocalCacheManager  # noqa: E402
from alluxio_tpu_torch.client.cache.meta import PageId  # noqa: E402
from alluxio_tpu_torch.client.cache.page_store import (  # noqa: E402
    LocalPageStore, MemPageStore,
)
from alluxio_tpu_torch.metrics import metrics  # noqa: E402

COUNTERS = ("Client.PageCacheHits", "Client.PageCacheMisses",
            "Client.PagesCached", "Client.PagesEvicted",
            "Client.HbmPageHits", "Client.HbmPagePromotions")


def _counts(registry):
    return {n: registry.counter(n).count for n in COUNTERS}


def _delta(before, after):
    return {n: after[n] - before[n] for n in COUNTERS}


def _stores(kind, tmp_path):
    if kind == "mem":
        return MemPageStore(), jps.MemPageStore()
    return (LocalPageStore(str(tmp_path / "port")),
            jps.LocalPageStore(str(tmp_path / "jax")))


@pytest.mark.parametrize("evictor", ["LRU", "LFU"])
@pytest.mark.parametrize("kind", ["mem", "local"])
def test_script_matches_jax(tmp_path, kind, evictor):
    """A seeded script of put/get/delete/delete_file under a capacity of
    a few pages: the same return values and, per step, the same counter
    moves and stats() from both managers."""
    mine_store, ref_store = _stores(kind, tmp_path)
    mine = LocalCacheManager(mine_store, capacity_bytes=5000, page_size=1024,
                             evictor=evictor)
    ref = jm.LocalCacheManager(ref_store, capacity_bytes=5000,
                               page_size=1024,
                               evictor=JaxEvictor.create(evictor))
    rng = np.random.default_rng(11)
    files = ["a", "b", "c"]
    for step in range(300):
        op = rng.choice(["put", "get", "get", "delete", "delete_file"],
                        p=[.4, .25, .25, .08, .02])
        f, i = str(rng.choice(files)), int(rng.integers(0, 6))
        m0, r0 = _counts(metrics()), _counts(jax_metrics())
        if op == "put":
            data = rng.integers(0, 256, int(rng.integers(100, 1400)),
                                dtype=np.uint8).tobytes()
            assert mine.put(PageId(f, i), data) == \
                ref.put(JaxPageId(f, i), data)
        elif op == "get":
            off = int(rng.integers(0, 50))
            n = int(rng.choice([-1, 10, 200]))
            assert mine.get(PageId(f, i), off, n) == \
                ref.get(JaxPageId(f, i), off, n)
        elif op == "delete":
            assert mine.delete(PageId(f, i)) == ref.delete(JaxPageId(f, i))
        else:
            assert mine.delete_file(f) == ref.delete_file(f)
        assert _delta(m0, _counts(metrics())) == \
            _delta(r0, _counts(jax_metrics())), (step, op)
        assert mine.stats() == ref.stats()
        assert mine.has(PageId(f, i)) == ref.has(JaxPageId(f, i))
    assert mine.stats()["pages"] > 0


def test_get_device_promotes_then_hits_with_jax_bytes():
    """``get_device``: a host-tier page, then a ``host_fallback`` page,
    promoted into the device tier, then served as device hits; the
    bytes are the JAX manager's device page's."""
    from alluxio_tpu.client.cache.hbm_store import \
        HbmPageStore as JaxHbmPageStore

    rng = np.random.default_rng(3)
    host_page = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    fallback = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    mine = LocalCacheManager(MemPageStore(), capacity_bytes=1 << 20,
                             hbm_store=HbmPageStore(1 << 20, device="cpu"))
    ref = jm.LocalCacheManager(jps.MemPageStore(), capacity_bytes=1 << 20,
                               hbm_store=JaxHbmPageStore(1 << 20))
    assert mine.get_device(PageId("f", 9)) is None  # nowhere
    assert ref.get_device(JaxPageId("f", 9)) is None
    assert mine.put(PageId("f", 0), host_page)
    assert ref.put(JaxPageId("f", 0), host_page)
    for idx, kw in ((0, {}), (1, {"host_fallback": lambda: fallback})):
        m0, r0 = _counts(metrics()), _counts(jax_metrics())
        lease, want = mine.get_device(PageId("f", idx), **kw), \
            ref.get_device(JaxPageId("f", idx), **kw)
        assert lease.array.device.type == "cpu"
        assert lease.array.dtype == torch.uint8
        assert lease.array.numpy().tobytes() == \
            np.asarray(want.array).tobytes()
        lease.close()
        want.close()
        assert _delta(m0, _counts(metrics())) == \
            _delta(r0, _counts(jax_metrics()))
        assert _delta(m0, _counts(metrics()))["Client.HbmPagePromotions"] \
            == 1
        # the second get is a device hit: no promotion, the same tensor
        m0 = _counts(metrics())
        with mine.get_device(PageId("f", idx)) as again:
            assert again.array.numpy().tobytes() == \
                np.asarray(want.array).tobytes()
        d = _delta(m0, _counts(metrics()))
        assert (d["Client.HbmPageHits"], d["Client.HbmPagePromotions"]) \
            == (1, 0)
    assert mine.has(PageId("f", 1))  # the fallback page reached the host
    assert mine.stats() == ref.stats()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_restore_crosses_packages(tmp_path, direction):
    """Pages one package's LocalPageStore wrote (``<root>/<file>/<i>``)
    are restored by the other's manager with identical bytes."""
    root = str(tmp_path / "pages")
    rng = np.random.default_rng(5)
    pages = {("1f", i): rng.integers(0, 256, 700 + 13 * i,
                                     dtype=np.uint8).tobytes()
             for i in range(4)}
    pages[("a/b", 0)] = b"slashed file id"
    writer_cls, reader_cls, reader_store, pid_cls = (
        (jm.LocalCacheManager, LocalCacheManager, LocalPageStore, PageId)
        if direction == "jax_to_port" else
        (LocalCacheManager, jm.LocalCacheManager, jps.LocalPageStore,
         JaxPageId))
    writer_store = (jps.LocalPageStore if direction == "jax_to_port"
                    else LocalPageStore)(root)
    writer_pid = JaxPageId if direction == "jax_to_port" else PageId
    writer = writer_cls(writer_store, capacity_bytes=1 << 20)
    for (f, i), data in pages.items():
        assert writer.put(writer_pid(f, i), data)
    reader = reader_cls(reader_store(root), capacity_bytes=1 << 20)
    assert reader.restore() == len(pages)
    for (f, i), data in pages.items():
        assert reader.get(pid_cls(f.replace("/", "_"), i)) == data
    assert reader.stats()["host_bytes"] == sum(map(len, pages.values()))


def test_caching_stream_random_reads(tmp_path):
    """``CachingFileInStream`` over a JAX LocalCluster file: random
    preads equal the file and the JAX caching stream's, and repeats hit
    the page cache (``test_local_cluster``'s case, mirrored)."""
    from alluxio_tpu.client.cache.stream import \
        CachingFileInStream as JaxCachingFileInStream
    from alluxio_tpu.minicluster import LocalCluster
    from alluxio_tpu_torch.client.cache.stream import CachingFileInStream

    with LocalCluster(str(tmp_path / "c"), num_workers=1,
                      block_size=64 * 1024) as cluster:
        fs = cluster.file_system()
        data = bytes(range(256)) * 400
        fs.write_all("/paged", data)
        mine = CachingFileInStream(fs.open_file("/paged"), LocalCacheManager(
            LocalPageStore(str(tmp_path / "pc")), capacity_bytes=1024 * 1024,
            page_size=4096))
        ref = JaxCachingFileInStream(fs.open_file("/paged"),
                                     jm.LocalCacheManager(
                                         jps.LocalPageStore(
                                             str(tmp_path / "jpc")),
                                         capacity_bytes=1024 * 1024,
                                         page_size=4096))
        hits = metrics().counter("Client.PageCacheHits")
        try:
            assert mine.pread(5000, 16) == data[5000:5016]
            h0 = hits.count
            assert mine.pread(5008, 16) == data[5008:5024]  # same page
            assert hits.count - h0 >= 1
            assert mine.pread(90000, 16) == data[90000:90016]
            rng = np.random.default_rng(8)
            for _ in range(40):
                off = int(rng.integers(0, len(data)))
                n = int(rng.integers(1, 9000))
                got = mine.pread(off, n)
                assert got == ref.pread(off, n) == data[off:off + n]
            mine.seek(100)
            assert mine.read(50) == data[100:150] and mine.tell() == 150
            assert mine.length == len(data)
            assert mine.block_stream(0).read_all() == data[:64 * 1024]
        finally:
            mine.close()
            ref.close()
