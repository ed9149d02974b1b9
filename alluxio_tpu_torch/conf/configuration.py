"""Typed runtime configuration: the part of
``alluxio_tpu/conf/configuration.py`` that the port's worker and worker
client read (callers build and pass their own ``Configuration``; the
port keeps no process-wide one).

A value set on the object beats an ``ATPU_*`` environment variable,
which beats the key's default; every lookup is parsed through the key's
declared type. The JAX package's other layers (site file, cluster and
path defaults, mount options) and its live-reconfiguration hash come
with the slices that read them.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

from alluxio_tpu_torch.conf.property_key import (
    REGISTRY, PropertyKey, Template,
)

_ENV_PREFIX = "ATPU_"


def _env_to_key(env_name: str) -> str:
    # ATPU_MASTER_RPC_PORT -> atpu.master.rpc.port
    return env_name.lower().replace("_", ".")


class Configuration:
    """An instanced configuration."""

    def __init__(self, initial: Optional[Dict[str, Any]] = None,
                 load_env: bool = True) -> None:
        self._values: Dict[str, Any] = {}
        if load_env:
            for env_name, v in os.environ.items():
                if env_name.startswith(_ENV_PREFIX):
                    name = _env_to_key(env_name)
                    if REGISTRY.is_valid(name):
                        self.set(name, v)
        for k, v in (initial or {}).items():
            self.set(k, v)

    def set(self, key: "PropertyKey | str", value: Any) -> None:
        # canonicalize aliases so set()/get() agree on the storage name
        self._values[self._resolve_key(key).name] = value

    def _resolve_key(self, key: "PropertyKey | str") -> PropertyKey:
        if isinstance(key, PropertyKey):
            return key
        pk = REGISTRY.get(str(key))
        if pk is None:
            tmpl = Template.match(str(key))
            if tmpl is not None:
                # registers the concrete key with its templated default
                return tmpl.format(*re.fullmatch(tmpl.regex, str(key)).groups())
            raise KeyError(f"unknown property key: {key}")
        return pk

    def get(self, key: "PropertyKey | str") -> Any:
        pk = self._resolve_key(key)
        return pk.parse(self._values.get(pk.name, pk.default))

    # typed getters
    def get_int(self, key) -> int:
        return int(self.get(key))

    def get_float(self, key) -> float:
        return float(self.get(key))

    def get_bool(self, key) -> bool:
        return bool(self.get(key))

    def get_bytes(self, key) -> int:
        return int(self.get(key))

    def get_duration_s(self, key) -> float:
        return float(self.get(key))

    def get_list(self, key) -> list:
        v = self.get(key)
        return list(v) if v else []
