"""Typed configuration (a copy of ``alluxio_tpu/conf``, with the keys the
port reads)."""

from alluxio_tpu_torch.conf.property_key import (  # noqa: F401
    ConsistencyLevel, Keys, KeyType, PropertyKey, REGISTRY, Templates,
    parse_bytes, parse_duration_s,
)
from alluxio_tpu_torch.conf.configuration import (  # noqa: F401
    Configuration, Source,
)
