"""LocalCacheManager: the client-embedded page cache.

The port of ``alluxio_tpu/client/cache/manager.py``, with the port's
:class:`~alluxio_tpu_torch.client.cache.hbm_store.HbmPageStore` as the
optional device tier above the host tier:

    device tier (torch.Tensor pages, pin-leased)   <- get_device() hits
    HOST/DISK (LocalPageStore | MemPageStore, LRU/LFU evicted)

``put`` lands pages in the host store; ``get_device`` promotes a host page
(or the caller's ``host_fallback()`` bytes) into the device tier on
access and serves device-resident pages on repeat access — a second pass
over warm pages never touches host memory. The keyword constructor has
the defaults of the JAX keys (512 MB host tier, 1 MiB pages, LRU, no
device tier); ``from_conf`` reads the ``atpu.user.client.cache.*`` keys
as the JAX one does (the file-system client's page cache). The
counters keep the JAX names (``Client.PageCache*``, ``Client.PagesCached``,
``Client.PagesEvicted``, ``Client.HbmPage*``).
"""

from __future__ import annotations

import threading
from typing import Optional, Union

from alluxio_tpu_torch.client.cache.evictor import CacheEvictor
from alluxio_tpu_torch.client.cache.hbm_store import (DevicePageLease,
                                                      HbmPageStore)
from alluxio_tpu_torch.client.cache.meta import PageId, PageInfo, PageMetaStore
from alluxio_tpu_torch.client.cache.page_store import LocalPageStore, PageStore
from alluxio_tpu_torch.metrics import metrics


class LocalCacheManager:
    def __init__(self, store: PageStore, *, capacity_bytes: int = 512 << 20,
                 page_size: int = 1 << 20,
                 evictor: Union[str, CacheEvictor] = "LRU",
                 hbm_store: Optional[HbmPageStore] = None) -> None:
        self._store = store
        self._capacity = capacity_bytes
        self.page_size = page_size
        self._evictor = evictor if not isinstance(evictor, str) \
            else CacheEvictor.create(evictor)
        self._meta = PageMetaStore()
        self._hbm = hbm_store
        self._lock = threading.RLock()
        self._m = metrics()

    @staticmethod
    def from_conf(conf) -> "LocalCacheManager":
        """A cache built from a port ``Configuration``; a device tier of
        ``atpu.user.client.cache.hbm.size`` bytes on the card when that
        is above 0."""
        from alluxio_tpu_torch.conf import Keys

        store = LocalPageStore(conf.get(Keys.USER_CLIENT_CACHE_DIR))
        hbm_bytes = conf.get_bytes(Keys.USER_CLIENT_CACHE_HBM_SIZE)
        hbm = HbmPageStore(hbm_bytes) if hbm_bytes > 0 else None
        return LocalCacheManager(
            store, capacity_bytes=conf.get_bytes(Keys.USER_CLIENT_CACHE_SIZE),
            page_size=conf.get_bytes(Keys.USER_CLIENT_CACHE_PAGE_SIZE),
            evictor=CacheEvictor.create(
                conf.get(Keys.USER_CLIENT_CACHE_EVICTOR)),
            hbm_store=hbm)

    # -- host-tier put/get ---------------------------------------------------
    def put(self, page_id: PageId, data: bytes) -> bool:
        with self._lock:
            if self._meta.has(page_id):
                return True
            while self._meta.bytes_in_tier("HOST") + len(data) > \
                    self._capacity:
                victim = self._evictor.evict()
                if victim is None:
                    return False
                self._delete_host(victim)
            self._store.put(page_id, data)
            self._meta.add(PageInfo(page_id, len(data), tier="HOST"))
            self._evictor.update_on_put(page_id)
            self._m.counter("Client.PagesCached").inc()
            return True

    def get(self, page_id: PageId, offset: int = 0,
            length: int = -1) -> Optional[bytes]:
        with self._lock:
            if not self._meta.has(page_id):
                self._m.counter("Client.PageCacheMisses").inc()
                return None
        data = self._store.get(page_id, offset, length)
        if data is None:  # store lost it (restart, purge)
            with self._lock:
                self._meta.remove(page_id)
                self._evictor.update_on_delete(page_id)
            self._m.counter("Client.PageCacheMisses").inc()
            return None
        self._evictor.update_on_get(page_id)
        self._m.counter("Client.PageCacheHits").inc()
        return data

    def has(self, page_id: PageId) -> bool:
        return self._meta.has(page_id)

    def _delete_host(self, page_id: PageId) -> None:
        self._store.delete(page_id)
        self._meta.remove(page_id)
        self._evictor.update_on_delete(page_id)
        self._m.counter("Client.PagesEvicted").inc()

    def delete(self, page_id: PageId) -> bool:
        with self._lock:
            existed = self._meta.has(page_id)
            if existed:
                self._delete_host(page_id)
        if self._hbm is not None:
            self._hbm.delete(page_id)
        return existed

    def delete_file(self, file_id: str) -> int:
        n = 0
        for pid in list(self._meta.pages_of_file(file_id)):
            if self.delete(pid):
                n += 1
        return n

    # -- device tier ---------------------------------------------------------
    @property
    def hbm(self) -> Optional[HbmPageStore]:
        return self._hbm

    def get_device(self, page_id: PageId,
                   host_fallback=None) -> Optional[DevicePageLease]:
        """Device-resident get: a device-tier hit returns the page's
        lease; on a miss, promote from the host tier (or
        ``host_fallback()`` bytes) into the device tier, then serve. None
        if the page is nowhere. The lease's tensor is on the store's
        device, ordered after its fill on the caller's current stream: a
        CUDA store never hands back a host tensor."""
        if self._hbm is None:
            return None
        lease = self._hbm.get(page_id)
        if lease is not None:
            self._m.counter("Client.HbmPageHits").inc()
            lease.wait()
            return lease
        data = self.get(page_id)
        if data is None and host_fallback is not None:
            data = host_fallback()
            if data is not None:
                self.put(page_id, data)
        if data is None:
            return None
        self._m.counter("Client.HbmPagePromotions").inc()
        if self._hbm.put(page_id, data):
            lease = self._hbm.get(page_id)
            if lease is not None:
                lease.wait()
            return lease
        return None

    # -- maintenance ---------------------------------------------------------
    def restore(self) -> int:
        """Re-adopt pages an earlier process (of either package) left in
        a LocalPageStore."""
        n = 0
        if isinstance(self._store, LocalPageStore):
            for pid, size in self._store.restore_pages():
                self._meta.add(PageInfo(pid, size, tier="HOST"))
                self._evictor.update_on_put(pid)
                n += 1
        return n

    def stats(self) -> dict:
        return {
            "pages": len(self._meta),
            "host_bytes": self._meta.bytes_in_tier("HOST"),
            "hbm_bytes": self._hbm.used_bytes if self._hbm else 0,
            "hbm_pinned": self._hbm.pinned_count() if self._hbm else 0,
        }

    def close(self) -> None:
        self._store.close()
        if self._hbm is not None:
            self._hbm.close()
