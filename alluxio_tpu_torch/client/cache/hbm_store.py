"""Device page store: cached pages resident in GPU memory.

The port of ``alluxio_tpu/client/cache/hbm_store.py``. Pages are
``torch.Tensor``s living on an explicit device; a warm get returns the
device tensor itself — no host traffic, consumable by a kernel directly.

Eviction vs consumer liveness: a page handed to a consumer may be an
operand of a kernel still queued on the stream. Gets return **pin
leases**: the store refuses to evict a page while leases are outstanding.
Eviction only drops the store's reference; the store never ``resize_``s,
``set_``s or overwrites a page, so a consumer that holds the tensor keeps
valid memory, and PyTorch frees it when the last reference dies.

CUDA stream hazard: the caching allocator may hand freed memory to a new
allocation as soon as the work queued on the page's *allocation stream*
has been ordered before it. Pages here are allocated and filled on the
caller's current stream (``host_to_device``) and consumed on that same
stream, so that ordering holds. A caller that fills a page on a side copy
stream must make the consuming stream wait on it and call
``tensor.record_stream(consumer_stream)`` before ``adopt()``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from alluxio_tpu_torch.client.cache.evictor import CacheEvictor
from alluxio_tpu_torch.client.cache.meta import PageId
from alluxio_tpu_torch.device import resolve_device


def host_to_device(host: np.ndarray, device):
    """Copy a host array (possibly a read-only mmap view) to ``device``.

    On a CUDA device the bytes go through a pinned staging buffer and an
    asynchronous copy on the current stream: a copy from pageable memory
    would be synchronous, and ``torch.from_numpy`` warns on the read-only
    views the short-circuit path hands out. PyTorch's pinned-memory
    allocator keeps the staging buffer until the copy has completed, so
    several copies stay in flight. On the CPU the result is a private
    copy (the mmap under the view may be closed later)."""
    import torch

    host = np.ascontiguousarray(host)
    if device.type == "cpu":
        return torch.from_numpy(np.array(host, copy=True))
    dtype = torch.from_numpy(np.empty(0, dtype=host.dtype)).dtype
    staging = torch.empty(host.shape, dtype=dtype, pin_memory=True)
    np.copyto(staging.numpy(), host)
    return staging.to(device, non_blocking=True)


class DevicePageLease:
    """A pinned device page; ``array`` is the tensor. Close to unpin."""

    def __init__(self, store: "HbmPageStore", page_id: PageId, array) -> None:
        self._store = store
        self.page_id = page_id
        self.array = array
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._store._unpin(self.page_id)

    def __enter__(self) -> "DevicePageLease":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class HbmPageStore:
    """Device-memory page store with pin-lease eviction safety.

    Eviction policy is a pluggable :class:`CacheEvictor` (LRU default)
    with pinned pages skipped: the evictor nominates victims, the store
    vetoes pinned ones. ``device=None`` means the current CUDA device."""

    def __init__(self, capacity_bytes: int, device=None,
                 evictor: str = "LRU") -> None:
        self._capacity = capacity_bytes
        self._device = resolve_device(device)
        self._pages: Dict[PageId, object] = {}
        self._sizes: Dict[PageId, int] = {}
        self._pins: Dict[PageId, int] = {}
        self._used = 0
        self._lock = threading.RLock()
        self._evictor = evictor if not isinstance(evictor, str) \
            else CacheEvictor.create(evictor)

    # -- capacity -----------------------------------------------------------
    @property
    def device(self):
        return self._device

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def capacity_bytes(self) -> int:
        return self._capacity

    @property
    def page_count(self) -> int:
        with self._lock:
            return len(self._pages)

    def has(self, page_id: PageId) -> bool:
        with self._lock:
            return page_id in self._pages

    # -- put/get ------------------------------------------------------------
    def put(self, page_id: PageId, host_buffer) -> bool:
        """Transfer a host buffer (bytes / numpy view / mmap view) into
        device memory as a uint8 page. Returns False if it cannot fit
        after eviction."""
        arr = np.frombuffer(host_buffer, dtype=np.uint8)
        with self._lock:
            if page_id in self._pages:
                return True
            if arr.nbytes > self._capacity:
                return False  # precheck: skip a doomed transfer
            return self.adopt(page_id, host_to_device(arr, self._device))

    def adopt(self, page_id: PageId, tensor) -> bool:
        """Retain an ALREADY device-resident tensor (e.g. the loader just
        copied it for a consumer) without a second transfer. Returns False
        when it cannot fit after eviction."""
        if tensor.device != self._device:
            raise ValueError(f"page on {tensor.device}, store on "
                             f"{self._device}")
        with self._lock:
            if page_id in self._pages:
                return True
            size = tensor.numel() * tensor.element_size()
            if size > self._capacity or not self._ensure_room(size):
                return False
            self._pages[page_id] = tensor
            self._sizes[page_id] = size
            self._used += size
            self._evictor.update_on_put(page_id)
            return True

    def get(self, page_id: PageId) -> Optional[DevicePageLease]:
        """Warm hit: the device tensor itself, pinned until lease close."""
        with self._lock:
            arr = self._pages.get(page_id)
            if arr is None:
                return None
            self._pins[page_id] = self._pins.get(page_id, 0) + 1
            self._evictor.update_on_get(page_id)
            return DevicePageLease(self, page_id, arr)

    def _unpin(self, page_id: PageId) -> None:
        with self._lock:
            n = self._pins.get(page_id, 0) - 1
            if n <= 0:
                self._pins.pop(page_id, None)
            else:
                self._pins[page_id] = n

    def delete(self, page_id: PageId, force: bool = False) -> bool:
        """Evict = drop the store's reference ONLY: the tensor a consumer
        got from an earlier ``get`` stays valid until its last reference
        dies."""
        with self._lock:
            if not force and self._pins.get(page_id, 0) > 0:
                return False  # pinned by a live lease
            if self._pages.pop(page_id, None) is None:
                return False
            self._used -= self._sizes.pop(page_id, 0)
            self._pins.pop(page_id, None)
            self._evictor.update_on_delete(page_id)
            return True

    def _ensure_room(self, size: int) -> bool:
        """Evict per the evictor's policy until ``size`` fits, skipping
        pinned pages."""
        while self._used + size > self._capacity:
            victim = self._evictor.evict_matching(
                lambda p: self._pins.get(p, 0) == 0 and p in self._pages)
            if victim is None:
                # evictor view stale/empty: any unpinned page as last resort
                victim = next((pid for pid in self._pages
                               if self._pins.get(pid, 0) == 0), None)
            if victim is None:
                return False
            self.delete(victim)
        return True

    def pinned_count(self) -> int:
        with self._lock:
            return sum(1 for n in self._pins.values() if n > 0)

    def close(self) -> None:
        with self._lock:
            for pid in list(self._pages):
                self.delete(pid, force=True)
