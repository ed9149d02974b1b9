"""Typed configuration (a copy of ``alluxio_tpu/conf``)."""

from alluxio_tpu_torch.conf.property_key import (  # noqa: F401
    ConsistencyLevel, Keys, KeyType, PropertyKey, REGISTRY, Scope, Template,
    Templates, parse_bytes, parse_duration_s,
)
from alluxio_tpu_torch.conf.configuration import (  # noqa: F401
    Configuration, Source, global_configuration, reset_global_configuration,
)
