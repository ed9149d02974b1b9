"""Wire types crossing RPC boundaries: a copy of the part of
``alluxio_tpu/utils/wire.py`` that the worker's data plane, the
client's block routing and the master speak — ``LocalityTier``, ``TieredIdentity``
(with ``from_spec``), ``WorkerNetAddress``, ``BlockLocation``,
``BlockInfo``, ``WorkerInfo``, ``FileBlockInfo``, ``FileInfo``,
``MountPointInfo`` and ``MasterInfo`` (reference:
``core/common/src/main/java/alluxio/wire/``).

Each type serializes to and from plain dicts (msgpack-friendly) through
``to_wire``/``from_wire`` exactly as the JAX package's do, field for
field, so a dict one package packs the other decodes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _wire_dataclass(cls):
    """Attach dict (de)serialization to a dataclass.

    The converters are SPECIALIZED lazily on first use (the ``_NESTED``
    registry below is only complete once the module finishes loading):
    plain scalar fields ride a single ``__dict__`` copy, containers get
    a shallow copy, and only fields registered in ``_NESTED`` pay the
    recursive conversion. The generic per-field getattr/hasattr loop
    this replaces was the top CPU item in master list_status profiles
    (~39 us per 30-field FileInfo; now ~6 us)."""
    fields_ = dataclasses.fields(cls)
    _names = tuple(f.name for f in fields_)
    _containers = tuple(
        f.name for f in fields_
        if any(t in str(f.type) for t in ("List", "Dict", "list", "dict")))
    spec: Dict[str, Any] = {}

    def _specialize() -> tuple:
        nested = tuple(n for (c, n), _ in _NESTED.items()
                       if c == cls.__name__)
        plain_dicts = frozenset(f.name for f in fields_
                                if _is_plain_dict_field(f))
        copy_only = tuple(n for n in _containers if n not in nested)
        # ONE atomic assignment: concurrent first callers must never
        # observe a half-built spec
        s = (nested, copy_only, plain_dicts)
        spec["s"] = s
        return s

    def to_wire(self) -> Dict[str, Any]:
        nested, copy_only, _ = spec.get("s") or _specialize()
        known = self._wire_names
        out = {k: v for k, v in self.__dict__.items() if k in known}
        for n in copy_only:
            v = out[n]
            if v is not None:
                out[n] = v.copy()
        for n in nested:
            v = out[n]
            if v is None:
                continue
            if isinstance(v, list):
                out[n] = [x.to_wire() if hasattr(x, "to_wire") else x
                          for x in v]
            elif isinstance(v, dict):
                out[n] = {k: (x.to_wire() if hasattr(x, "to_wire") else x)
                          for k, x in v.items()}
            elif hasattr(v, "to_wire"):
                out[n] = v.to_wire()
        return out

    @classmethod
    def from_wire(klass, d: Dict[str, Any]):
        nested, _, plain_dicts = spec.get("s") or _specialize()
        known = klass._wire_names
        if d.keys() == known:
            # exact match (the overwhelmingly common case: our own
            # server's wire dict): one flat C-level copy, then adopt as
            # __dict__ — no filtered comprehension, no 30-kwarg
            # __init__. Listing fan-out decodes N of these per call, so
            # the per-key copy was the client-side hot spot. The copy
            # (not in-place adoption) keeps the CALLER's dict unmutated
            # — callers may retain it (journal payloads, the master's
            # listing cache), and rewriting nested dicts into dataclass
            # objects inside it would corrupt it for re-serialization.
            d = dict(d)
            for n in nested:
                v = d[n]
                if v is None:
                    continue
                sub = _NESTED[(klass.__name__, n)]
                if isinstance(v, list):
                    d[n] = [sub.from_wire(x) if isinstance(x, dict)
                            else x for x in v]
                elif isinstance(v, dict) and n not in plain_dicts:
                    d[n] = sub.from_wire(v)
            obj = object.__new__(klass)
            obj.__dict__ = d
            return obj
        kwargs = {k: v for k, v in d.items() if k in known}
        for n in nested:
            v = kwargs.get(n)
            if v is None:
                continue
            sub = _NESTED[(klass.__name__, n)]
            if isinstance(v, list):
                kwargs[n] = [sub.from_wire(x) if isinstance(x, dict)
                             else x for x in v]
            elif isinstance(v, dict) and n not in plain_dicts:
                kwargs[n] = sub.from_wire(v)
        if len(kwargs) == len(known):
            # complete wire dict (the overwhelmingly common case: our
            # own server sent it): adopt it as __dict__ directly and
            # skip the 30-kwarg __init__ — ~2x faster per entry, which
            # matters at listing fan-out. Partial dicts (forward/back
            # compat) take the kwargs path for defaulting.
            obj = object.__new__(klass)
            obj.__dict__ = kwargs
            return obj
        return klass(**kwargs)

    cls._wire_names = frozenset(_names)
    cls.to_wire = to_wire
    cls.from_wire = from_wire
    return cls


def _is_plain_dict_field(f) -> bool:
    return "Dict" in str(f.type) or "dict" in str(f.type)


_NESTED: Dict[tuple, type] = {}


@_wire_dataclass
@dataclass
class LocalityTier:
    """One (tier-name, value) locality pair, e.g. ("slice", "slice-0")."""

    tier: str = ""
    value: str = ""


#: Ordered tier names, closest first. TPU-native ordering (SURVEY.md 2.11).
LOCALITY_ORDER = ("host", "slice", "pod", "region")


@_wire_dataclass
@dataclass
class TieredIdentity:
    """Ordered locality identity (reference: ``wire/TieredIdentity.java:36``).

    ``closeness`` replaces the reference's nearest-match resolution
    (``TieredIdentity.java:69``): lower is closer; tie broken by tier order.
    """

    tiers: List[LocalityTier] = field(default_factory=list)

    def value(self, tier: str) -> Optional[str]:
        for t in self.tiers:
            if t.tier == tier:
                return t.value
        return None

    def closeness(self, other: "TieredIdentity") -> int:
        """0 = same host; k = first k locality tiers differ; large = remote."""
        for i, name in enumerate(LOCALITY_ORDER):
            mine, theirs = self.value(name), other.value(name)
            if mine is not None and mine == theirs:
                return i
        return len(LOCALITY_ORDER)

    def nearest(self, candidates: List["TieredIdentity"]) -> Optional[int]:
        """Index of the closest candidate, or None if empty."""
        if not candidates:
            return None
        scored = [(self.closeness(c), i) for i, c in enumerate(candidates)]
        return min(scored)[1]

    @staticmethod
    def from_spec(spec: "List[str] | str | None", hostname: str = "") -> "TieredIdentity":
        """Parse ``["host=h","slice=s"]`` / ``"host=h,slice=s"`` specs."""
        tiers: List[LocalityTier] = []
        if spec:
            parts = spec.split(",") if isinstance(spec, str) else spec
            for p in parts:
                if "=" in p:
                    k, _, v = p.partition("=")
                    tiers.append(LocalityTier(k.strip(), v.strip()))
        if hostname and not any(t.tier == "host" for t in tiers):
            tiers.insert(0, LocalityTier("host", hostname))
        return TieredIdentity(tiers)


_NESTED[("TieredIdentity", "tiers")] = LocalityTier


@_wire_dataclass
@dataclass
class WorkerNetAddress:
    host: str = ""
    rpc_port: int = 0
    data_port: int = 0
    web_port: int = 0
    domain_socket_path: str = ""
    #: Same-host shm dir for short-circuit mmap reads (TPU-native analogue of
    #: the reference's short-circuit block paths).
    shm_dir: str = ""
    tiered_identity: TieredIdentity = field(default_factory=TieredIdentity)

    def key(self) -> str:
        return f"{self.host}:{self.rpc_port}"


_NESTED[("WorkerNetAddress", "tiered_identity")] = TieredIdentity


@_wire_dataclass
@dataclass
class BlockLocation:
    worker_id: int = 0
    address: WorkerNetAddress = field(default_factory=WorkerNetAddress)
    tier_alias: str = "MEM"
    medium_type: str = ""


_NESTED[("BlockLocation", "address")] = WorkerNetAddress


@_wire_dataclass
@dataclass
class BlockInfo:
    block_id: int = 0
    length: int = 0
    locations: List[BlockLocation] = field(default_factory=list)
    #: HBM (device-mesh) residency reported by JAX clients — kept
    #: SEPARATE from ``locations``: these are not worker-served replicas
    #: (no data server behind them), so replication counting and the
    #: worker read path must not see them
    device_locations: List[BlockLocation] = field(default_factory=list)


_NESTED[("BlockInfo", "locations")] = BlockLocation
_NESTED[("BlockInfo", "device_locations")] = BlockLocation


@_wire_dataclass
@dataclass
class WorkerInfo:
    id: int = 0
    address: WorkerNetAddress = field(default_factory=WorkerNetAddress)
    state: str = "LIVE"
    capacity_bytes: int = 0
    used_bytes: int = 0
    start_time_ms: int = 0
    last_contact_ms: int = 0
    capacity_bytes_on_tiers: Dict[str, int] = field(default_factory=dict)
    used_bytes_on_tiers: Dict[str, int] = field(default_factory=dict)
    block_count: int = 0


_NESTED[("WorkerInfo", "address")] = WorkerNetAddress


@_wire_dataclass
@dataclass
class FileBlockInfo:
    block_info: BlockInfo = field(default_factory=BlockInfo)
    offset: int = 0
    ufs_locations: List[str] = field(default_factory=list)


_NESTED[("FileBlockInfo", "block_info")] = BlockInfo


@_wire_dataclass
@dataclass
class FileInfo:
    file_id: int = 0
    name: str = ""
    path: str = ""
    ufs_path: str = ""
    length: int = 0
    block_size_bytes: int = 0
    creation_time_ms: int = 0
    last_modification_time_ms: int = 0
    last_access_time_ms: int = 0
    completed: bool = False
    folder: bool = False
    pinned: bool = False
    pinned_media: List[str] = field(default_factory=list)
    cacheable: bool = True
    persisted: bool = False
    persistence_state: str = "NOT_PERSISTED"
    block_ids: List[int] = field(default_factory=list)
    in_memory_percentage: int = 0
    ttl: int = -1
    ttl_action: str = "DELETE"
    owner: str = ""
    group: str = ""
    mode: int = 0o644
    mount_point: bool = False
    mount_id: int = 0
    replication_min: int = 0
    replication_max: int = -1
    file_block_infos: List[FileBlockInfo] = field(default_factory=list)
    xattr: Dict[str, str] = field(default_factory=dict)


_NESTED[("FileInfo", "file_block_infos")] = FileBlockInfo


@_wire_dataclass
@dataclass
class MountPointInfo:
    alluxio_path: str = ""
    ufs_uri: str = ""
    ufs_type: str = ""
    ufs_capacity_bytes: int = -1
    ufs_used_bytes: int = -1
    read_only: bool = False
    shared: bool = False
    mount_id: int = 0
    properties: Dict[str, str] = field(default_factory=dict)


@_wire_dataclass
@dataclass
class MasterInfo:
    leader_master_address: str = ""
    master_addresses: List[str] = field(default_factory=list)
    rpc_port: int = 0
    safe_mode: bool = False
    start_time_ms: int = 0
    up_time_ms: int = 0
    version: str = ""
    cluster_id: str = ""
