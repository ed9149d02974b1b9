"""Client-embedded page cache with a device top tier (the port of
``alluxio_tpu/client/cache``)."""

from alluxio_tpu_torch.client.cache.manager import (  # noqa: F401
    LocalCacheManager,
)
from alluxio_tpu_torch.client.cache.meta import PageId, PageInfo  # noqa: F401
from alluxio_tpu_torch.client.cache.page_store import (  # noqa: F401
    LocalPageStore, MemPageStore,
)
