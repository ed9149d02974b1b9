"""Under-storage connectors (a copy of ``alluxio_tpu/underfs/__init__.py``;
reference: ``underfs/`` + ``core/common/.../underfs``)."""

from alluxio_tpu_torch.underfs.base import (  # noqa: F401
    CreateOptions, DeleteOptions, UfsMode, UfsStatus, UnderFileSystem,
)
from alluxio_tpu_torch.underfs.local import LocalUnderFileSystem  # noqa: F401
from alluxio_tpu_torch.underfs.object_base import (  # noqa: F401
    MemObjectStore, MemUnderFileSystem, ObjectStoreClient,
    ObjectUnderFileSystem,
)
from alluxio_tpu_torch.underfs.registry import (  # noqa: F401
    UfsManager, create_ufs, register_factory, supported_schemes,
)
