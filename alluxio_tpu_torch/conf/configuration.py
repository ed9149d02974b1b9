"""Layered, typed runtime configuration: a copy of
``alluxio_tpu/conf/configuration.py``, with its site-properties file and
its process-wide global configuration.

Re-design of the reference's ``conf/InstancedConfiguration.java:43`` +
``conf/AlluxioProperties.java`` + ``conf/Source.java``: values are resolved
through a priority stack of sources (RUNTIME > PATH_DEFAULT > CLUSTER_DEFAULT
> SYSTEM_PROPERTY/env > SITE_PROPERTY file > DEFAULT), every lookup is parsed
through the key's declared type, and a content hash supports the reference's
live-reconfiguration handshake (``client/file/ConfigHashSync.java:36``).
"""

from __future__ import annotations

import enum
import hashlib
import os
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

from alluxio_tpu_torch.conf.property_key import (
    REGISTRY, PropertyKey, Template,
)


class Source(enum.IntEnum):
    """Priority-ordered provenance of a config value (higher wins).
    Order mirrors the reference's ``Source.Type``: cluster defaults served
    by the master sit just above built-in defaults, so any locally-set
    site/env/runtime value beats them."""

    DEFAULT = 0
    CLUSTER_DEFAULT = 1
    SITE_PROPERTY = 2
    ENVIRONMENT = 3
    PATH_DEFAULT = 4
    RUNTIME = 5
    MOUNT_OPTION = 6


_ENV_PREFIX = "ATPU_"


def _env_to_key(env_name: str) -> str:
    # ATPU_MASTER_RPC_PORT -> atpu.master.rpc.port
    return env_name.lower().replace("_", ".")


class Configuration:
    """An instanced, layered configuration."""

    def __init__(self, initial: Optional[Dict[str, Any]] = None,
                 load_env: bool = True) -> None:
        self._lock = threading.RLock()
        # name -> (raw value, source); highest-priority source wins at get()
        self._values: Dict[str, Tuple[Any, Source]] = {}
        if load_env:
            for env_name, v in os.environ.items():
                if env_name.startswith(_ENV_PREFIX):
                    name = _env_to_key(env_name)
                    if REGISTRY.is_valid(name):
                        self._put(name, v, Source.ENVIRONMENT)
        if initial:
            for k, v in initial.items():
                self.set(k, v)

    # -- mutation -----------------------------------------------------------
    def _put(self, name: str, value: Any, source: Source) -> None:
        with self._lock:
            cur = self._values.get(name)
            if cur is None or source >= cur[1]:
                self._values[name] = (value, source)

    def set(self, key: "PropertyKey | str", value: Any,
            source: Source = Source.RUNTIME) -> None:
        # canonicalize aliases so set()/get() agree on the storage name
        self._put(self._resolve_key(key).name, value, source)

    def unset(self, key: "PropertyKey | str") -> None:
        name = self._resolve_key(key).name
        with self._lock:
            self._values.pop(name, None)

    def merge(self, props: Dict[str, Any], source: Source) -> None:
        for k, v in props.items():
            if REGISTRY.is_valid(k):
                self._put(k, v, source)

    def load_site_properties(self, path: str) -> None:
        """Load a java-properties-style ``key=value`` file."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip()
                if REGISTRY.is_valid(k):
                    self._put(k, v, Source.SITE_PROPERTY)

    # -- resolution ---------------------------------------------------------
    def _resolve_key(self, key: "PropertyKey | str") -> PropertyKey:
        if isinstance(key, PropertyKey):
            return key
        pk = REGISTRY.get(str(key))
        if pk is None:
            tmpl = Template.match(str(key))
            if tmpl is not None:
                # registers the concrete key with its templated default
                import re
                m = re.fullmatch(tmpl.regex, str(key))
                return tmpl.format(*m.groups())
            raise KeyError(f"unknown property key: {key}")
        return pk

    def is_set(self, key: "PropertyKey | str") -> bool:
        pk = self._resolve_key(key)
        with self._lock:
            return pk.name in self._values or pk.default is not None

    def get(self, key: "PropertyKey | str") -> Any:
        pk = self._resolve_key(key)
        with self._lock:
            entry = self._values.get(pk.name)
        raw = entry[0] if entry is not None else pk.default
        return pk.parse(raw)

    def get_or(self, key: "PropertyKey | str", fallback: Any) -> Any:
        v = self.get(key)
        return fallback if v is None else v

    def source(self, key: "PropertyKey | str") -> Source:
        pk = self._resolve_key(key)
        with self._lock:
            entry = self._values.get(pk.name)
        return entry[1] if entry is not None else Source.DEFAULT

    # convenience typed getters
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

    def get_ms(self, key) -> int:
        return int(self.get(key) * 1000)

    def get_list(self, key) -> list:
        v = self.get(key)
        return list(v) if v else []

    # -- introspection / distribution --------------------------------------
    def items(self) -> Iterator[Tuple[str, Any, Source]]:
        with self._lock:
            snapshot = dict(self._values)
        for name, (value, source) in sorted(snapshot.items()):
            yield name, value, source

    def to_map(self, min_source: Source = Source.DEFAULT) -> Dict[str, Any]:
        """Raw values at or above a source level — used for cluster-default
        distribution from master to clients/workers
        (reference: ``meta_master.proto:196-211``)."""
        return {name: value for name, value, source in self.items()
                if source >= min_source}

    def hash(self) -> str:
        """Content hash for the live-reconfiguration handshake
        (reference: ``ConfigHashSync.java:36``)."""
        h = hashlib.md5()
        for name, value, _ in self.items():
            h.update(f"{name}={value};".encode())
        return h.hexdigest()

    def copy(self) -> "Configuration":
        c = Configuration(load_env=False)
        with self._lock:
            c._values = dict(self._values)
        return c

    def validate(self) -> None:
        """Parse every set value through its key's type; raise on error."""
        for name, value, _ in self.items():
            pk = REGISTRY.get(name)
            if pk is not None:
                pk.parse(value)


# Global process-wide configuration (reference: ServerConfiguration singleton,
# core/server/common/.../conf/ServerConfiguration.java). Tests construct their
# own Configuration instances instead.
_GLOBAL: Optional[Configuration] = None
_GLOBAL_LOCK = threading.Lock()


def site_configuration() -> Configuration:
    """A new configuration: the environment, then the site file named by
    ``ATPU_SITE_PROPERTIES`` (default ``/etc/alluxio_tpu/site.properties``)
    when it exists. The environment wins over the file."""
    conf = Configuration()
    site = os.environ.get("ATPU_SITE_PROPERTIES",
                          "/etc/alluxio_tpu/site.properties")
    if os.path.exists(site):
        conf.load_site_properties(site)
    return conf


def global_configuration() -> Configuration:
    """The process-wide configuration, made once by
    :func:`site_configuration`."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = site_configuration()
        return _GLOBAL


def reset_global_configuration() -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
