"""The port's device page store (on the CPU), mirroring
``tests/test_jax_path.py::TestHbmStore``, and the carry-over of a filled
JAX store's pages into it (bytes compared exactly)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.client.cache.hbm_store import \
    HbmPageStore as JaxHbmPageStore  # noqa: E402
from alluxio_tpu.client.cache.meta import PageId as JaxPageId  # noqa: E402
from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore  # noqa: E402
from alluxio_tpu_torch.client.cache.meta import PageId  # noqa: E402
from alluxio_tpu_torch.convert import hbm_store_from_numpy  # noqa: E402


def _store(capacity):
    return HbmPageStore(capacity_bytes=capacity, device="cpu")


class TestHbmStore:
    def test_put_get_pin_evict(self):
        store = _store(4096)
        p1, p2 = PageId("f", 0), PageId("f", 1)
        assert store.put(p1, b"a" * 2048)
        assert store.put(p2, b"b" * 2048)
        lease = store.get(p1)
        assert lease is not None
        assert bytes(lease.array[:2].numpy()) == b"aa"
        # full store + p1 pinned: p2 is the only evictable page
        assert store.put(PageId("f", 2), b"c" * 2048)
        assert store.has(p1) and not store.has(p2)
        lease.close()
        assert store.put(PageId("f", 3), b"d" * 4096)  # evicts everything
        assert not store.has(p1)

    def test_pinned_pages_block_oversized_put(self):
        store = _store(1024)
        store.put(PageId("f", 0), b"x" * 1024)
        lease = store.get(PageId("f", 0))
        assert not store.put(PageId("f", 1), b"y" * 1024)  # all pinned
        lease.close()
        assert store.put(PageId("f", 1), b"y" * 1024)

    def test_eviction_keeps_consumer_array_alive(self):
        store = _store(1024)
        p0 = PageId("f", 0)
        store.put(p0, b"k" * 1024)
        with store.get(p0) as lease:
            held = lease.array
        assert store.put(PageId("f", 1), b"m" * 1024)
        assert not store.has(p0)
        # eviction dropped the store's reference only
        assert bytes(held[:2].numpy()) == b"kk"


class TestPortStore:
    def test_adopt_keeps_the_tensor_and_checks_device(self):
        store = _store(4096)
        t = torch.arange(16, dtype=torch.int32)
        assert store.adopt(PageId("f", 0), t)
        with store.get(PageId("f", 0)) as lease:
            assert lease.array is t  # no second transfer, no copy
        assert store.used_bytes == 64
        with pytest.raises(ValueError):
            store.adopt(PageId("f", 1), torch.empty(
                4, dtype=torch.uint8, device="meta"))

    def test_put_copies_out_of_the_host_buffer(self):
        store = _store(4096)
        host = np.frombuffer(b"z" * 64, dtype=np.uint8)  # read-only view
        assert store.put(PageId("f", 0), host)
        with store.get(PageId("f", 0)) as lease:
            assert lease.array.dtype == torch.uint8
            assert bytes(lease.array.numpy()) == b"z" * 64
        assert not store.put(PageId("f", 1), b"q" * 8192)  # over capacity

    def test_lfu_evictor_skips_pinned(self):
        store = HbmPageStore(2048, device="cpu", evictor="LFU")
        a, b = PageId("f", 0), PageId("f", 1)
        store.put(a, b"a" * 1024)
        store.put(b, b"b" * 1024)
        for _ in range(3):
            store.get(a).close()
        assert store.put(PageId("f", 2), b"c" * 1024)
        assert store.has(a) and not store.has(b)  # least-frequent went

    def test_store_from_filled_jax_store(self):
        rng = np.random.default_rng(4)
        jstore = JaxHbmPageStore(capacity_bytes=1 << 20)
        ids = [("1a2b", i) for i in range(5)]
        for fid, i in ids:
            data = rng.integers(0, 256, size=1000 + 37 * i,
                                dtype=np.uint8).tobytes()
            assert jstore.put(JaxPageId(fid, i), data)
        pages = {}
        for fid, i in ids:
            with jstore.get(JaxPageId(fid, i)) as lease:
                pages[(fid, i)] = np.asarray(lease.array)
        store = hbm_store_from_numpy(pages, capacity_bytes=1 << 20,
                                     device="cpu")
        assert store.page_count == len(ids)
        assert store.used_bytes == jstore.used_bytes
        for (fid, i), arr in pages.items():
            with store.get(PageId(fid, i)) as lease:
                assert lease.array.device.type == "cpu"
                assert lease.array.numpy().tobytes() == arr.tobytes()
        with pytest.raises(ValueError):
            hbm_store_from_numpy(pages, capacity_bytes=100, device="cpu")
