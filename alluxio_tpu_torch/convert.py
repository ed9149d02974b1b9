"""Carry the device tier's state into the port.

This system's state is the contents of its device page store. The JAX
``HbmPageStore`` keeps each page as a uint8 array; taken through
``np.asarray`` they become ``{(file_id_hex, page_index): ndarray}``,
which :func:`hbm_store_from_numpy` turns into a port ``HbmPageStore``
holding the same pages on a torch device.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
from alluxio_tpu_torch.client.cache.meta import PageId


def hbm_store_from_numpy(pages: Mapping[Tuple[str, int], np.ndarray], *,
                         capacity_bytes: int, device=None) -> HbmPageStore:
    """A page store on ``device`` (``None``: the card) holding ``pages``.
    Raises ``ValueError`` if the pages do not fit in ``capacity_bytes``:
    a carried-over tier never drops a page silently."""
    total = sum(np.asarray(a).nbytes for a in pages.values())
    if total > capacity_bytes:
        raise ValueError(f"{total} bytes of pages exceed the store's "
                         f"capacity of {capacity_bytes}")
    store = HbmPageStore(capacity_bytes, device)
    for (file_id, index), arr in pages.items():
        host = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        store.put(PageId(file_id, int(index)), host)
    return store
