"""Typed configuration property keys: a copy of
``alluxio_tpu/conf/property_key.py``.

The machinery (typed keys, a registry with aliases, ``Template`` families
such as the per-tier worker settings, the duration and byte parsers, the
credential mask of the display surfaces) is the JAX package's, and so is
the catalog: every JAX key, with the JAX name, type, default, scope and
consistency level, so one properties file configures either package and
``validateConf`` accepts and refuses the same keys; the keys are grouped
by the layer of the port that reads them. ``Templates`` has the JAX
families too, the tier watermarks and mount-table options among them.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class Scope(enum.Flag):
    """Which process types consume a key (reference: ``conf/Scope.java``)."""

    MASTER = enum.auto()
    WORKER = enum.auto()
    CLIENT = enum.auto()
    JOB_MASTER = enum.auto()
    JOB_WORKER = enum.auto()
    SERVER = MASTER | WORKER | JOB_MASTER | JOB_WORKER
    ALL = SERVER | CLIENT
    NONE = 0


_DURATION_RE = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*(ms|s|sec|m|min|h|hr|d|day)?\s*$")
_BYTES_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(b|kb|mb|gb|tb|pb|k|m|g|t|p|ki|mi|gi|ti|pi)?\s*$",
    re.I)

_DURATION_UNITS = {
    None: 0.001,  # bare numbers are milliseconds, matching the reference
    "ms": 0.001,
    "s": 1.0,
    "sec": 1.0,
    "m": 60.0,
    "min": 60.0,
    "h": 3600.0,
    "hr": 3600.0,
    "d": 86400.0,
    "day": 86400.0,
}

_BYTE_UNITS = {
    None: 1,
    "b": 1,
    # "ki/mi/gi" are the Kubernetes quantity spellings — accepted so
    # chart values flow into ATPU_* env vars verbatim
    "k": 1 << 10, "kb": 1 << 10, "ki": 1 << 10,
    "m": 1 << 20, "mb": 1 << 20, "mi": 1 << 20,
    "g": 1 << 30, "gb": 1 << 30, "gi": 1 << 30,
    "t": 1 << 40, "tb": 1 << 40, "ti": 1 << 40,
    "p": 1 << 50, "pb": 1 << 50, "pi": 1 << 50,
}


def parse_duration_s(value: Any) -> float:
    """Parse ``"5s"``, ``"100ms"``, ``"1h"`` (or a bare ms count) to seconds."""
    if isinstance(value, (int, float)):
        return float(value) / 1000.0
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse duration: {value!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


def parse_bytes(value: Any) -> int:
    """Parse ``"64MB"``, ``"1g"`` (or a bare byte count) to bytes."""
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return int(value)
    m = _BYTES_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse byte size: {value!r}")
    unit = m.group(2).lower() if m.group(2) else None
    return int(float(m.group(1)) * _BYTE_UNITS[unit])


def parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"cannot parse bool: {value!r}")


class KeyType(enum.Enum):
    STRING = "string"
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    BYTES = "bytes"        # human sizes: "64MB"
    DURATION = "duration"  # human durations: "5s" -> seconds (float)
    LIST = "list"          # comma separated
    ENUM = "enum"


_PARSERS: Dict[KeyType, Callable[[Any], Any]] = {
    KeyType.STRING: str,
    KeyType.INT: lambda v: int(str(v), 0) if not isinstance(v, int) else v,
    KeyType.FLOAT: float,
    KeyType.BOOL: parse_bool,
    KeyType.BYTES: parse_bytes,
    KeyType.DURATION: parse_duration_s,
    KeyType.LIST: lambda v: list(v) if isinstance(v, (list, tuple)) else [p for p in str(v).split(",") if p],
}


class ConsistencyLevel(enum.Enum):
    """Cross-cluster consistency requirement for a key's value; the
    master's config checker reports conflicts on ENFORCE keys as errors
    (reference: ``meta/checkconf/ServerConfigurationChecker.java``)."""

    IGNORE = "IGNORE"
    WARN = "WARN"
    ENFORCE = "ENFORCE"


@dataclass(frozen=True)
class PropertyKey:
    """One typed configuration key."""

    name: str
    key_type: KeyType = KeyType.STRING
    default: Any = None
    description: str = ""
    scope: Scope = Scope.ALL
    consistency: ConsistencyLevel = ConsistencyLevel.IGNORE
    aliases: tuple = ()
    choices: tuple = ()  # for ENUM
    dynamic: bool = False  # may be updated at runtime (live reconfiguration)
    # Mirrors the reference's DisplayType.CREDENTIALS
    # (conf/PropertyKey.java): values must be masked on every config
    # display surface (web UI, REST, shell report).
    credentials: bool = False

    def parse(self, raw: Any) -> Any:
        if raw is None:
            return None
        if self.key_type is KeyType.ENUM:
            s = str(raw).upper()
            if self.choices and s not in self.choices:
                raise ValueError(
                    f"{self.name}: invalid value {raw!r}; choices: {self.choices}")
            return s
        return _PARSERS[self.key_type](raw)

    def __str__(self) -> str:
        return self.name


class KeyRegistry:
    """Global catalog of defined keys, with alias resolution."""

    def __init__(self) -> None:
        self._keys: Dict[str, PropertyKey] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, key: PropertyKey) -> PropertyKey:
        existing = self._keys.get(key.name)
        if existing is not None:
            return existing
        self._keys[key.name] = key
        for a in key.aliases:
            self._aliases[a] = key.name
        return key

    def get(self, name: str) -> Optional[PropertyKey]:
        if name in self._keys:
            return self._keys[name]
        canonical = self._aliases.get(name)
        if canonical:
            return self._keys[canonical]
        return None

    def is_valid(self, name: str) -> bool:
        return self.get(name) is not None or Template.match(name) is not None

    def all_keys(self) -> Dict[str, PropertyKey]:
        return dict(self._keys)


REGISTRY = KeyRegistry()


def _k(name: str, key_type: KeyType = KeyType.STRING, default: Any = None,
       description: str = "", scope: Scope = Scope.ALL,
       consistency: ConsistencyLevel = ConsistencyLevel.IGNORE,
       aliases: tuple = (), choices: tuple = (), dynamic: bool = False,
       credentials: bool = False) -> PropertyKey:
    return REGISTRY.register(PropertyKey(
        name=name, key_type=key_type, default=default, description=description,
        scope=scope, consistency=consistency, aliases=aliases, choices=choices,
        dynamic=dynamic, credentials=credentials))


# Defensive net for keys minted outside the registry (templates, mount
# options echoed into config): anything that LOOKS like a secret is
# treated as one on display surfaces.
_CREDENTIAL_NAME_RE = re.compile(
    r"(?i)(password|secret|token|credential|access[._-]?key|[._-]key$)")


def is_credential_key(name: str) -> bool:
    """True if ``name`` must be masked on config display surfaces."""
    pk = REGISTRY.get(name)
    if pk is not None and pk.credentials:
        return True
    return _CREDENTIAL_NAME_RE.search(name) is not None


def mask_credential(name: str, value: Any) -> Any:
    """Value as it may appear on a display surface (web UI, REST, shell):
    credential keys come back as ``******`` unless unset."""
    if is_credential_key(name) and value not in (None, "", "None"):
        return "******"
    return value


@dataclass(frozen=True)
class Template:
    """A parameterized key family, e.g. per-tier worker storage settings.

    Reference: ``conf/PropertyKey.java:5668`` (``Template`` enum with regex
    matching).  ``WORKER_TIER_DIRS_PATH.format(0)`` mints the concrete key.
    """

    pattern: str  # str.format pattern with {} placeholders
    regex: str
    key_type: KeyType = KeyType.STRING
    default_fn: Callable[..., Any] = lambda *a: None
    scope: Scope = Scope.ALL

    _ALL: "list[Template]" = field(default_factory=list, repr=False)

    def format(self, *args) -> PropertyKey:
        name = self.pattern.format(*args)
        existing = REGISTRY.get(name)
        if existing:
            return existing
        return REGISTRY.register(PropertyKey(
            name=name, key_type=self.key_type, default=self.default_fn(*args),
            scope=self.scope))

    @classmethod
    def match(cls, name: str) -> Optional["Template"]:
        for t in _TEMPLATES:
            if re.fullmatch(t.regex, name):
                return t
        return None


_TEMPLATES: list = []


def _template(pattern: str, regex: str, key_type: KeyType = KeyType.STRING,
              default_fn: Callable[..., Any] = lambda *a: None,
              scope: Scope = Scope.ALL) -> Template:
    t = Template(pattern=pattern, regex=regex, key_type=key_type,
                 default_fn=default_fn, scope=scope)
    _TEMPLATES.append(t)
    return t


class Keys:
    # --- worker: store, tiers, async cache, RPC ---
    TIERED_IDENTITY = _k(
        "atpu.locality.identity", KeyType.LIST, default=None,
        description="Ordered locality tiers 'host=h,slice=s,pod=p' "
                    "(reference: wire/TieredIdentity.java:36; TPU twist: "
                    "host < ICI slice < pod < DCN).")
    WORKER_HOSTNAME = _k("atpu.worker.hostname", default="localhost")
    WORKER_RPC_PORT = _k("atpu.worker.rpc.port", KeyType.INT, default=29999)
    WORKER_DATA_FOLDER = _k("atpu.worker.data.folder", default="/tmp/alluxio_tpu/worker")
    WORKER_RAMDISK_SIZE = _k("atpu.worker.ramdisk.size", KeyType.BYTES, default="1GB")
    WORKER_TIERED_STORE_LEVELS = _k("atpu.worker.tieredstore.levels", KeyType.INT,
                                    default=2, scope=Scope.WORKER)
    WORKER_BLOCK_HEARTBEAT_INTERVAL = _k(
        "atpu.worker.block.heartbeat.interval", KeyType.DURATION, default="1s",
        scope=Scope.WORKER)
    WORKER_ALLOCATOR_CLASS = _k("atpu.worker.allocator.class", KeyType.ENUM,
                                default="MAX_FREE",
                                choices=("MAX_FREE", "ROUND_ROBIN", "GREEDY"),
                                scope=Scope.WORKER)
    WORKER_ANNOTATOR_CLASS = _k("atpu.worker.block.annotator.class", KeyType.ENUM,
                                default="LRU", choices=("LRU", "LRFU"),
                                scope=Scope.WORKER)
    WORKER_LRFU_STEP_FACTOR = _k("atpu.worker.block.annotator.lrfu.step.factor",
                                 KeyType.FLOAT, default=0.25, scope=Scope.WORKER)
    WORKER_LRFU_ATTENUATION_FACTOR = _k(
        "atpu.worker.block.annotator.lrfu.attenuation.factor", KeyType.FLOAT,
        default=2.0, scope=Scope.WORKER)
    WORKER_SHM_DIR = _k("atpu.worker.shm.dir", default="/dev/shm/alluxio_tpu",
                        scope=Scope.WORKER,
                        description="Backing dir for the MEM tier; files here are "
                                    "mmap-able by same-host clients for the "
                                    "short-circuit zero-copy read path.")
    WORKER_ASYNC_CACHE_QUEUE_MAX = _k(
        "atpu.worker.async.cache.queue.max", KeyType.INT, default=512,
        scope=Scope.WORKER,
        description="Pending passive-cache requests held before new "
                    "submissions are rejected (counted in "
                    "Worker.AsyncCacheRejected). Passive caching is "
                    "advisory; an unbounded backlog only delays it "
                    "past usefulness.")
    WORKER_ASYNC_CACHE_THREADS = _k(
        "atpu.worker.async.cache.threads", KeyType.INT, default=2,
        scope=Scope.WORKER,
        description="Worker threads draining the passive-cache queue "
                    "(reference: alluxio.worker.network.async.cache."
                    "manager.threads.max).")
    WORKER_QOS_ENABLED = _k(
        "atpu.worker.qos.enabled", KeyType.BOOL, default=False,
        scope=Scope.WORKER,
        description="Priority-class scheduling + per-tenant quotas on "
                    "the worker data plane: the per-mount UFS stripe "
                    "executors and the async cache queue drain "
                    "ON_DEMAND > ASYNC_FILL > PREFETCH (on-demand "
                    "reads overtake QUEUED background work; in-flight "
                    "work is never interrupted), and per-tenant "
                    "concurrency caps apply. Also authenticates worker "
                    "RPCs (SIMPLE metadata identity) so requests carry "
                    "a principal. Off: FIFO drain, no caps — "
                    "byte-identical to a build without QoS.")
    WORKER_SHM_LEASE_TTL = _k(
        "atpu.worker.shm.lease.ttl", KeyType.DURATION, default="30s",
        scope=Scope.WORKER,
        description="TTL of a client's SHM segment lease. The lease pins "
                    "the block against eviction; clients renew lazily "
                    "(shm_renew) while a segment stays mapped, and a "
                    "crashed client's pins self-expire after one TTL — "
                    "the crash-safe reclamation path needs no death "
                    "detection.")
    WORKER_SHM_MAX_LEASES = _k(
        "atpu.worker.shm.max.leases", KeyType.INT, default=1024,
        scope=Scope.WORKER,
        description="Concurrent SHM leases the worker grants before "
                    "denying shm_open (clients fall back to the remote "
                    "path) — bounds how much of the MEM tier client pins "
                    "can hold unevictable.")

    # --- client / user: the worker client's RPC retries ---
    USER_RPC_RETRY_MAX_DURATION = _k(
        "atpu.user.rpc.retry.max.duration", KeyType.DURATION,
        default="30s", scope=Scope.CLIENT,
        aliases=("atpu.user.rpc.retry.duration",),
        description="Wall-clock budget a client RPC retries transient "
                    "errors within before giving up (reference: "
                    "alluxio.user.rpc.retry.max.duration). The 30s "
                    "default matches the previously hard-coded client "
                    "behavior; overload drills shorten it so flooded "
                    "clients fail fast instead of piling 30s of "
                    "backoff behind a shedding master.")
    USER_RPC_RETRY_BASE_SLEEP = _k("atpu.user.rpc.retry.base.sleep", KeyType.DURATION,
                                   default="50ms", scope=Scope.CLIENT)
    USER_RPC_RETRY_MAX_SLEEP = _k("atpu.user.rpc.retry.max.sleep", KeyType.DURATION,
                                  default="3s", scope=Scope.CLIENT)

    # --- client / user: the SHM plane, remote reads, batches ---
    USER_SHM_ENABLED = _k(
        "atpu.user.shm.enabled", KeyType.BOOL, default=True,
        scope=Scope.CLIENT,
        description="Same-host zero-copy SHM transport: when the serving "
                    "worker is co-located, the client leases the block's "
                    "MEM-tier segment (shm_open RPC), mmaps it, and reads "
                    "through a memoryview with no RPC, serialization, or "
                    "copy per read. Fallback to the remote path is "
                    "transparent (segment unavailable, lease denied, "
                    "worker restart). Off: reads are byte-identical to a "
                    "build without the subsystem.")
    USER_SHM_SEGMENT_CACHE_MAX = _k(
        "atpu.user.shm.segment.cache.max", KeyType.INT, default=64,
        scope=Scope.CLIENT,
        description="Mapped SHM segments held per client process (LRU); "
                    "evicting a segment unmaps it and releases its worker "
                    "lease. Bounds client address-space use, not "
                    "correctness — a miss re-leases on next read.")
    USER_SHM_LEASE_RENEW_FRACTION = _k(
        "atpu.user.shm.lease.renew.fraction", KeyType.FLOAT, default=0.5,
        scope=Scope.CLIENT,
        description="A cached segment whose lease has consumed this "
                    "fraction of its TTL is renewed lazily on the next "
                    "read touching it (one shm_renew RPC amortized over "
                    "many zero-copy reads).")
    USER_REMOTE_READ_STRIPE_SIZE = _k(
        "atpu.user.remote.read.stripe.size", KeyType.BYTES, default="4MB",
        scope=Scope.CLIENT,
        description="Stripe size for parallel remote (DCN) block reads: a "
                    "read larger than one stripe is split into ranges "
                    "fetched over concurrent read_block streams across "
                    "replicas / pooled channels. 0 disables striping "
                    "(byte-identical legacy single-stream reads).")
    USER_REMOTE_READ_CONCURRENCY = _k(
        "atpu.user.remote.read.concurrency", KeyType.INT, default=4,
        scope=Scope.CLIENT,
        description="Stripes of one remote read in flight concurrently; "
                    "also bounds the pooled-channel fan-out to a single "
                    "worker.")
    USER_REMOTE_READ_WINDOW_BYTES = _k(
        "atpu.user.remote.read.window.bytes", KeyType.BYTES, default="32MB",
        scope=Scope.CLIENT,
        description="In-flight window for striped remote reads: stripes "
                    "are only issued while their offset is within this "
                    "many bytes of the consumer's drain point, capping "
                    "readahead past the contiguous frontier. 0 removes "
                    "the cap (concurrency still bounds in-flight "
                    "stripes).")
    USER_REMOTE_READ_HEDGE_QUANTILE = _k(
        "atpu.user.remote.read.hedge.quantile", KeyType.FLOAT, default=0.95,
        scope=Scope.CLIENT,
        description="A stripe outliving this latency quantile of its "
                    "worker's rolling EWMA is re-issued to another "
                    "replica/channel; first answer wins, the loser is "
                    "cancelled. 0 disables hedging.")
    USER_BATCH_READ_ENABLED = _k(
        "atpu.user.batch.read.enabled", KeyType.BOOL, default=True,
        scope=Scope.CLIENT,
        description="Scatter/gather batch reads: read_many coalesces a "
                    "batch of small same-block reads into ONE read_many "
                    "RPC landing in one preallocated buffer (one "
                    "serialize + one wire round-trip instead of N). Off: "
                    "each read is an individual RPC, byte-identical to "
                    "today's per-op path.")
    USER_BATCH_READ_MAX_OP_BYTES = _k(
        "atpu.user.batch.read.max.op.bytes", KeyType.BYTES, default="64KB",
        scope=Scope.CLIENT,
        description="Reads at or below this size are eligible for "
                    "read_many coalescing; larger ops route to the "
                    "striped remote-read path where per-op RPC cost is "
                    "already amortized.")
    USER_BATCH_READ_MAX_OPS = _k(
        "atpu.user.batch.read.max.ops", KeyType.INT, default=256,
        scope=Scope.CLIENT,
        description="Ops coalesced into one read_many RPC; a larger "
                    "batch is split into ceil(n/max) RPCs so one "
                    "response message stays bounded.")
    USER_NATIVE_FASTPATH_ENABLED = _k(
        "atpu.user.native.fastpath.enabled", KeyType.BOOL, default=True,
        scope=Scope.CLIENT,
        description="Native (C++) fastpath for assembled small-read "
                    "plans: SHM batch copies, read_many response "
                    "scatter, and stripe commits execute as one packed "
                    "op table per batch with the GIL released for the "
                    "whole call (docs/native.md). Takes effect only "
                    "when the on-demand g++ build succeeds; a missing "
                    "toolchain or any native error falls back to the "
                    "byte-identical pure-Python path and counts "
                    "Client.NativeFallbacks. Off: the client is "
                    "byte-identical to a build without the subsystem.")

    # --- client: the table read path (table/) ---
    USER_TABLE_PUSHDOWN_ENABLED = _k(
        "atpu.user.table.pushdown.enabled", KeyType.BOOL, default=True,
        scope=Scope.CLIENT,
        description="Projection-aware Parquet reads (docs/table_reads.md): "
                    "the table reader parses the footer once (cached), "
                    "plans the exact column-chunk byte ranges of the "
                    "projection per row group, and executes them through "
                    "the choose_route ladder — same-host chunks as SHM "
                    "zero-copy views, small wire-crossing chunks "
                    "coalesced into read_many batches, large chunks as "
                    "striped reads — with decode of row group k "
                    "overlapped against transfer of k+1. Off: reads go "
                    "through the legacy seek+read pyarrow path, "
                    "byte-identical to a build without the subsystem.")
    USER_TABLE_PIPELINE_DEPTH = _k(
        "atpu.user.table.pipeline.depth", KeyType.INT, default=2,
        scope=Scope.CLIENT,
        description="Row groups in flight ahead of the decoder in the "
                    "planned table-read pipeline: transfer of row group "
                    "k+depth is issued while k decodes, so decode time "
                    "hides under transfer time. 1 serializes transfer "
                    "and decode (no overlap); the depth bounds buffered "
                    "row-group bytes.")
    USER_TABLE_READ_PARALLELISM = _k(
        "atpu.user.table.read.parallelism", KeyType.INT, default=4,
        scope=Scope.CLIENT,
        description="Files a multi-file projection (read_columns over a "
                    "partitioned table) opens/plans/reads concurrently: "
                    "partition-spanning projections overlap their footer "
                    "fetches and row-group pipelines instead of running "
                    "file-serial. 1 restores the serial loop.")
    USER_TABLE_COALESCE_SLACK_BYTES = _k(
        "atpu.user.table.coalesce.slack.bytes", KeyType.BYTES,
        default="256KB", scope=Scope.CLIENT,
        description="Adjacent planned column-chunk ranges whose gap is "
                    "at or under this slack merge into one read — the "
                    "discarded gap bytes buy fewer round trips (gap "
                    "bytes are fetched and dropped). 0 never merges "
                    "across a gap (only touching ranges coalesce).")
    USER_TABLE_FOOTER_CACHE_MAX = _k(
        "atpu.user.table.footer.cache.max", KeyType.INT, default=256,
        scope=Scope.CLIENT,
        description="Parsed Parquet footers held per client process "
                    "(LRU), keyed on path + metadata version so a "
                    "rewritten file re-parses: a warm projection re-plans "
                    "from the cache with zero footer I/O.")
    USER_TABLE_FOOTER_READ_BYTES = _k(
        "atpu.user.table.footer.read.bytes", KeyType.BYTES, default="64KB",
        scope=Scope.CLIENT,
        description="First-guess tail read for a Parquet footer: one "
                    "range read of this many bytes replaces pyarrow's "
                    "probe-seek sequence of tiny reads; a footer larger "
                    "than the guess costs exactly one more ranged read "
                    "(sized from the footer-length trailer).")

    # --- worker: the read-only web endpoint ---
    WORKER_WEB_PORT = _k("atpu.worker.web.port", KeyType.INT, default=30000)
    WORKER_WEB_ENABLED = _k(
        "atpu.worker.web.enabled", KeyType.BOOL, default=False,
        scope=Scope.WORKER,
        description="Serve the worker's read-only HTTP/JSON state "
                    "endpoint (reference: AlluxioWorkerRestServiceHandler).")
    WORKER_WEB_BIND_HOST = _k(
        "atpu.worker.web.bind.host", default="0.0.0.0",
        scope=Scope.WORKER)

    # --- worker: tier management ---
    WORKER_MANAGEMENT_TIER_ALIGN_ENABLED = _k(
        "atpu.worker.management.tier.align.enabled", KeyType.BOOL, default=True,
        scope=Scope.WORKER)
    WORKER_MANAGEMENT_TIER_PROMOTE_ENABLED = _k(
        "atpu.worker.management.tier.promote.enabled", KeyType.BOOL, default=True,
        scope=Scope.WORKER)
    WORKER_MANAGEMENT_TASK_INTERVAL = _k(
        "atpu.worker.management.task.interval", KeyType.DURATION, default="1s",
        scope=Scope.WORKER)
    WORKER_MANAGEMENT_PROMOTE_QUOTA_PERCENT = _k(
        "atpu.worker.management.tier.promote.quota.percent", KeyType.INT, default=90,
        scope=Scope.WORKER)

    # --- worker: the striped cold fetch and its QoS ---
    WORKER_UFS_FETCH_STRIPE_SIZE = _k(
        "atpu.worker.ufs.fetch.stripe.size", KeyType.BYTES, default="4MB",
        scope=Scope.WORKER,
        description="Stripe size for striped parallel cold UFS block "
                    "fetches; also the streaming read-through's "
                    "time-to-first-byte unit (a waiter gets its first "
                    "chunk after one stripe lands, not the whole block).")
    WORKER_UFS_FETCH_CONCURRENCY = _k(
        "atpu.worker.ufs.fetch.concurrency", KeyType.INT, default=4,
        scope=Scope.WORKER,
        description="Stripes of one block fetched concurrently. "
                    "Effective parallelism is also bounded by "
                    "atpu.worker.ufs.fetch.per.mount.limit.")
    WORKER_UFS_FETCH_PER_MOUNT_LIMIT = _k(
        "atpu.worker.ufs.fetch.per.mount.limit", KeyType.INT, default=16,
        scope=Scope.WORKER,
        description="Concurrent UFS stripe reads per mount across ALL "
                    "in-flight block fetches — the worker's connection "
                    "budget against one backing store.")
    WORKER_UFS_FETCH_TENANT_LIMIT = _k(
        "atpu.worker.ufs.fetch.tenant.limit", KeyType.INT, default=8,
        scope=Scope.WORKER,
        description="With worker QoS on: concurrent UFS stripe tasks "
                    "one tenant (principal) may occupy per mount; "
                    "excess work is parked until the tenant frees a "
                    "slot, so one flooding tenant cannot monopolize "
                    "the per-mount connection budget. 0 = unlimited.")

    # --- metrics: sinks and the worker's metrics heartbeat ---
    METRICS_SINKS = _k(
        "atpu.metrics.sinks", KeyType.STRING, default="",
        scope=Scope.ALL,
        description="Comma-separated metric sinks to start (console, "
                    "csv, jsonl, graphite) — reference: "
                    "metrics/sink/*Sink.java.")
    METRICS_SINK_INTERVAL = _k(
        "atpu.metrics.sink.interval", KeyType.DURATION, default="10s",
        scope=Scope.ALL)
    METRICS_SINK_CSV_DIR = _k(
        "atpu.metrics.sink.csv.dir", KeyType.STRING,
        default="/tmp/atpu-metrics", scope=Scope.ALL,
        description="Directory for the CSV sink (one file per metric).")
    METRICS_SINK_JSONL_PATH = _k(
        "atpu.metrics.sink.jsonl.path", KeyType.STRING,
        default="/tmp/atpu-metrics/metrics.jsonl", scope=Scope.ALL)
    METRICS_SINK_GRAPHITE_ADDRESS = _k(
        "atpu.metrics.sink.graphite.address", KeyType.STRING,
        default="", scope=Scope.ALL,
        description="host:port of the Graphite/Carbon plaintext "
                    "listener (reference: metrics/sink/"
                    "GraphiteSink.java).")
    METRICS_SINK_GRAPHITE_PREFIX = _k(
        "atpu.metrics.sink.graphite.prefix", KeyType.STRING,
        default="alluxio-tpu", scope=Scope.ALL)
    METRICS_SINK_GRAPHITE_TIMEOUT = _k(
        "atpu.metrics.sink.graphite.timeout", KeyType.DURATION,
        default="5s", scope=Scope.ALL,
        description="Connect/send deadline for the Graphite sink. The "
                    "send also runs on a dedicated sender thread, so a "
                    "dead carbon host can never stall the shared "
                    "metrics-sink heartbeat.")
    WORKER_METRICS_HEARTBEAT_INTERVAL = _k(
        "atpu.worker.metrics.heartbeat.interval", KeyType.DURATION,
        default="10s", scope=Scope.WORKER,
        description="Cadence of worker metric snapshots shipped to the "
                    "master for cluster aggregation.")

    # --- security: authentication (the worker's authenticator) ---
    SECURITY_AUTH_TYPE = _k("atpu.security.authentication.type", KeyType.ENUM,
                            default="SIMPLE", choices=("NOSASL", "SIMPLE", "CUSTOM"),
                            consistency=ConsistencyLevel.ENFORCE)
    SECURITY_LOGIN_USERNAME = _k("atpu.security.login.username")
    SECURITY_LOGIN_IMPERSONATION_USERNAME = _k(
        "atpu.security.login.impersonation.username",
        description="User to act as; the connecting user must be allowed by "
                    "the master's impersonation rules.")
    SECURITY_AUTH_CUSTOM_PROVIDER = _k(
        "atpu.security.authentication.custom.provider",
        description="dotted.module:attr of an AuthenticationProvider for "
                    "CUSTOM auth (reference: AuthenticationProvider SPI).")
    SECURITY_LOGIN_TOKEN = _k(
        "atpu.security.login.token",
        description="Opaque credential forwarded to a CUSTOM provider.",
        credentials=True)

    # --- fault injection (chaos / self-healing tests; see utils/faults.py)
    DEBUG_FAULT_READ_LATENCY = _k(
        "atpu.debug.fault.read.latency", KeyType.DURATION, default="0ms",
        scope=Scope.WORKER,
        description="FAULT INJECTION (tests/chaos only): extra latency "
                    "added to every warm read_block chunk this worker "
                    "serves — inflates Worker.ReadBlockTime so the p99 "
                    "regression rule can be exercised end to end.")
    DEBUG_FAULT_HEARTBEAT_FREEZE = _k(
        "atpu.debug.fault.worker.heartbeat.freeze", KeyType.BOOL,
        default=False, scope=Scope.WORKER,
        description="FAULT INJECTION (tests/chaos only): the worker "
                    "silently skips its metrics heartbeats — drives the "
                    "heartbeat-staleness rule without killing the "
                    "process.")
    DEBUG_FAULT_UFS_ERROR_RATE = _k(
        "atpu.debug.fault.ufs.error.rate", KeyType.FLOAT, default=0.0,
        scope=Scope.WORKER,
        description="FAULT INJECTION (tests/chaos only): deterministic "
                    "fraction (0..1) of UFS stripe reads that fail with "
                    "an injected IOError.")
    DEBUG_FAULT_RPC_REJECT_RATE = _k(
        "atpu.debug.fault.rpc.reject.rate", KeyType.FLOAT, default=0.0,
        scope=Scope.ALL,
        description="FAULT INJECTION (tests/chaos only): deterministic "
                    "fraction (0..1) of RPC dispatches shed with the "
                    "same typed ResourceExhausted + retry-after the "
                    "admission controller emits — drills shedding and "
                    "client retry-after honoring without a real "
                    "flood. The fault scope matches the RPC's "
                    "service.method key.")
    DEBUG_FAULT_SHM_MAP_ERROR_RATE = _k(
        "atpu.debug.fault.shm.map.error.rate", KeyType.FLOAT, default=0.0,
        scope=Scope.CLIENT,
        description="FAULT INJECTION (tests/chaos only): deterministic "
                    "fraction (0..1) of client SHM segment maps that "
                    "fail with an injected OSError — drills the "
                    "SHM->remote transparent-fallback path.")
    DEBUG_FAULT_SHM_LEASE_DENY_RATE = _k(
        "atpu.debug.fault.shm.lease.deny.rate", KeyType.FLOAT, default=0.0,
        scope=Scope.WORKER,
        description="FAULT INJECTION (tests/chaos only): deterministic "
                    "fraction (0..1) of worker shm_open lease grants "
                    "denied as if the lease table were full — drills "
                    "lease-denied fallback without filling "
                    "atpu.worker.shm.max.leases.")
    DEBUG_FAULT_NATIVE_EXEC_ERROR_RATE = _k(
        "atpu.debug.fault.native.exec.error.rate", KeyType.FLOAT,
        default=0.0, scope=Scope.CLIENT,
        description="FAULT INJECTION (tests/chaos only): deterministic "
                    "fraction (0..1) of native fastpath batches that "
                    "fail mid-table (one op poisoned, earlier ops "
                    "really write) — drills the byte-identical "
                    "fallback to the pure-Python read path.")
    DEBUG_FAULT_SCOPE = _k(
        "atpu.debug.fault.scope", KeyType.STRING, default="",
        scope=Scope.WORKER,
        description="Substring a node's locality host / metrics source "
                    "must contain for the atpu.debug.fault.* hooks to "
                    "apply; empty = every node that loaded the conf "
                    "(in-process miniclusters share one injector).")

    # --- master: RPC, safe mode, worker timeout, heartbeats ---
    HOME = _k("atpu.home", default="/tmp/alluxio_tpu")
    MASTER_HOSTNAME = _k("atpu.master.hostname", default="localhost", scope=Scope.ALL)
    MASTER_RPC_PORT = _k("atpu.master.rpc.port", KeyType.INT, default=19998)
    MASTER_RPC_ADDRESSES = _k(
        "atpu.master.rpc.addresses", scope=Scope.ALL,
        description="Comma-separated master addresses for HA deployments; "
                    "overrides hostname:port when set (reference: "
                    "alluxio.master.rpc.addresses).")
    MASTER_SAFEMODE_WAIT = _k("atpu.master.safemode.wait", KeyType.DURATION,
                              default="5s", scope=Scope.MASTER,
                              description="Window after primacy during which "
                                          "client ops are rejected while workers "
                                          "re-register (reference: DefaultSafeModeManager).")
    MASTER_WORKER_TIMEOUT = _k("atpu.master.worker.timeout", KeyType.DURATION,
                               default="5min", scope=Scope.MASTER,
                               description="Silent-worker expiry "
                                           "(reference: LostWorkerDetectionHeartbeatExecutor, "
                                           "DefaultBlockMaster.java:1087).")
    MASTER_LOST_WORKER_DETECTION_INTERVAL = _k(
        "atpu.master.lost.worker.detection.interval", KeyType.DURATION, default="10s",
        scope=Scope.MASTER)
    MASTER_TTL_CHECK_INTERVAL = _k("atpu.master.ttl.check.interval",
                                   KeyType.DURATION, default="1h", scope=Scope.MASTER)
    MASTER_ACTIVE_SYNC_INTERVAL = _k(
        "atpu.master.activesync.interval", KeyType.DURATION, default="30s",
        scope=Scope.MASTER,
        description="Poll interval for active sync points (reference: "
                    "ActiveSyncManager.java:81; polling replaces iNotify).")
    MASTER_REPLICATION_CHECK_INTERVAL = _k(
        "atpu.master.replication.check.interval", KeyType.DURATION, default="1min",
        scope=Scope.MASTER)
    MASTER_REPLICATION_MAX_INFLIGHT = _k(
        "atpu.master.replication.max.inflight", KeyType.INT, default=256,
        scope=Scope.MASTER,
        description="Replicate/evict jobs the replication checker keeps "
                    "in flight at once; deficits beyond it wait for the "
                    "next heartbeat (counted in "
                    "Master.ReplicationJobsDeferred) — bounds job-master "
                    "load after a mass worker loss.")
    MASTER_LOST_FILES_DETECTION_INTERVAL = _k(
        "atpu.master.lost.files.detection.interval", KeyType.DURATION,
        default="5min", scope=Scope.MASTER,
        description="How often the master scans lost blocks for files "
                    "with no recoverable copy (reference: "
                    "LostFileDetector.java).")
    MASTER_BLOCK_INTEGRITY_CHECK_INTERVAL = _k(
        "atpu.master.block.integrity.check.interval", KeyType.DURATION,
        default="1h", scope=Scope.MASTER,
        description="How often the master frees blocks whose owning file "
                    "is gone (reference: BlockIntegrityChecker.java).")
    MASTER_UFS_CLEANUP_INTERVAL = _k(
        "atpu.master.ufs.cleanup.interval", KeyType.DURATION,
        default="1h", scope=Scope.MASTER,
        description="How often mounted UFSes are swept for abandoned "
                    "persist temp files (reference: UfsCleaner.java).")
    MASTER_PERSISTENCE_TEMP_TTL = _k(
        "atpu.master.persistence.temp.ttl", KeyType.DURATION,
        default="1h", scope=Scope.MASTER,
        description="Age after which an .atpu_persist.* temp file is "
                    "considered abandoned.")
    TABLE_TRANSFORM_MONITOR_INTERVAL = _k(
        "atpu.table.transform.manager.job.monitor.interval", KeyType.DURATION,
        default="10s", scope=Scope.MASTER,
        description="How often the table master polls running transform "
                    "jobs and commits completed layouts (reference: "
                    "TransformManager.java:82 heartbeat).")
    MASTER_PERSISTENCE_SCHEDULER_INTERVAL = _k(
        "atpu.master.persistence.scheduler.interval", KeyType.DURATION, default="1s",
        scope=Scope.MASTER)
    MASTER_UFS_PATH_CACHE_CAPACITY = _k(
        "atpu.master.ufs.path.cache.capacity", KeyType.INT, default=100_000,
        scope=Scope.MASTER)
    MASTER_MOUNT_TABLE_ROOT_UFS = _k(
        "atpu.master.mount.table.root.ufs", default="",
        scope=Scope.MASTER,
        description="UFS URI mounted at the namespace root (reference: "
                    "alluxio.master.mount.table.root.ufs). Empty: a "
                    "local directory under atpu.home.")
    MASTER_FASTPATH_ENABLED = _k(
        "atpu.master.fastpath.enabled", KeyType.BOOL, default=True,
        scope=Scope.MASTER,
        description="Serve metadata RPCs over a same-host Unix-socket "
                    "fast path (framed msgpack, no HTTP/2) alongside "
                    "gRPC; local clients short-circuit onto it and "
                    "remote ones keep using gRPC (rpc/fastpath.py).")
    MASTER_FASTPATH_DIR = _k(
        "atpu.master.fastpath.dir", default="/tmp",
        description="Directory for the fastpath Unix socket "
                    "(atpu-master-<rpc_port>.sock); clients probe the "
                    "same conventional path.")

    # --- master: HA (standby masters, the embedded Raft journal) ---
    MASTER_HA_ENABLED = _k(
        "atpu.master.ha.enabled", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Run the master fault-tolerant: file-lock election on "
                    "the shared journal dir, standby tailing until primacy.")
    MASTER_HA_STANDBY_READS_ENABLED = _k(
        "atpu.master.ha.standby.reads.enabled", KeyType.BOOL, default=True,
        scope=Scope.MASTER,
        description="Standby masters serve GetStatus/ListStatus/Exists "
                    "off their tailing journal apply, stamped with the "
                    "standby's own (journal-deterministic) md_version; "
                    "every other RPC is refused with a typed "
                    "NotPrimaryError carrying the current leader hint "
                    "(docs/ha.md).")
    MASTER_HA_PUBLISH_INTERVAL = _k(
        "atpu.master.ha.publish.interval", KeyType.DURATION, default="1s",
        scope=Scope.MASTER,
        description="How often an HA master publishes its row (role, "
                    "applied sequence, term) into the shared-journal "
                    "master registry backing `fsadmin report masters` "
                    "and the quorum-degraded health rule.")
    MASTER_EMBEDDED_JOURNAL_ADDRESSES = _k(
        "atpu.master.embedded.journal.addresses", default="",
        scope=Scope.ALL,
        description="Comma-separated host:port quorum member addresses for "
                    "the EMBEDDED (Raft) journal (reference: "
                    "alluxio.master.embedded.journal.addresses).")
    MASTER_EMBEDDED_JOURNAL_ADDRESS = _k(
        "atpu.master.embedded.journal.address", default="",
        scope=Scope.MASTER,
        description="This master's own quorum address; must appear in "
                    "atpu.master.embedded.journal.addresses.")
    MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MIN = _k(
        "atpu.master.embedded.journal.election.timeout.min",
        KeyType.DURATION, default="300ms", scope=Scope.MASTER)
    MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MAX = _k(
        "atpu.master.embedded.journal.election.timeout.max",
        KeyType.DURATION, default="600ms", scope=Scope.MASTER)
    MASTER_EMBEDDED_JOURNAL_HEARTBEAT_INTERVAL = _k(
        "atpu.master.embedded.journal.heartbeat.interval",
        KeyType.DURATION, default="100ms", scope=Scope.MASTER)
    MASTER_EMBEDDED_JOURNAL_SNAPSHOT_PERIOD_ENTRIES = _k(
        "atpu.master.embedded.journal.snapshot.period.entries", KeyType.INT,
        default=100_000, scope=Scope.MASTER)
    MASTER_STANDBY_TAIL_INTERVAL = _k(
        "atpu.master.standby.journal.tail.interval", KeyType.DURATION,
        default="1s", scope=Scope.MASTER,
        description="Standby journal tailing period (reference: "
                    "UfsJournalCheckpointThread.java:47).")

    # --- master: journal and metastore ---
    MASTER_JOURNAL_TYPE = _k("atpu.master.journal.type", KeyType.ENUM,
                             default="LOCAL", choices=("LOCAL", "UFS", "EMBEDDED", "NOOP"),
                             scope=Scope.MASTER)
    MASTER_JOURNAL_FOLDER = _k("atpu.master.journal.folder",
                               default="/tmp/alluxio_tpu/journal", scope=Scope.MASTER)
    MASTER_JOURNAL_LOG_SIZE_BYTES_MAX = _k(
        "atpu.master.journal.log.size.bytes.max", KeyType.BYTES, default="64MB",
        scope=Scope.MASTER)
    MASTER_JOURNAL_CHECKPOINT_PERIOD_ENTRIES = _k(
        "atpu.master.journal.checkpoint.period.entries", KeyType.INT,
        default=2_000_000, scope=Scope.MASTER)
    MASTER_JOURNAL_FLUSH_BATCH_TIME = _k(
        "atpu.master.journal.flush.batch.time", KeyType.DURATION, default="5ms",
        scope=Scope.MASTER,
        description="Coalescing window of the dedicated journal flusher "
                    "(group commit, reference: AsyncJournalWriter): the "
                    "flusher accumulates up to this much arrival time "
                    "into one file write + fsync; operations block only "
                    "until their batch's fsync completes. 0 flushes "
                    "every wakeup without coalescing.")
    MASTER_JOURNAL_INIT_FROM_BACKUP = _k(
        "atpu.master.journal.init.from.backup",
        description="Backup file to seed an EMPTY journal from at boot "
                    "(reference: initFromBackup, "
                    "AlluxioMasterProcess.java:173-190).")
    MASTER_METASTORE = _k("atpu.master.metastore", KeyType.ENUM, default="HEAP",
                          choices=("HEAP", "SQLITE", "LSM", "CACHING",
                                   "CACHING:HEAP", "CACHING:SQLITE",
                                   "CACHING:LSM"), scope=Scope.MASTER,
                          description="Inode/edge store backend (reference: "
                                      "HEAP/ROCKS/caching metastore). HEAP "
                                      "serves from dicts; SQLITE spills to "
                                      "disk; LSM is the billion-inode "
                                      "capacity backend (WAL + memtable + "
                                      "sorted runs, always caching-wrapped); "
                                      "CACHING[:backing] fronts a backing "
                                      "store with a write-back LRU.")
    MASTER_METASTORE_DIR = _k("atpu.master.metastore.dir",
                              default="/tmp/alluxio_tpu/metastore", scope=Scope.MASTER)
    MASTER_METASTORE_INODE_CACHE_MAX_SIZE = _k(
        "atpu.master.metastore.inode.cache.max.size", KeyType.INT, default=100_000,
        scope=Scope.MASTER)
    MASTER_METASTORE_LSM_MEMTABLE_BYTES = _k(
        "atpu.master.metastore.lsm.memtable.bytes", KeyType.BYTES,
        default="8MB", scope=Scope.MASTER,
        description="LSM metastore memtable cap: the in-memory write "
                    "buffer is flushed to an immutable sorted run when "
                    "its encoded size crosses this bound.")
    MASTER_METASTORE_LSM_COMPACTION_TRIGGER = _k(
        "atpu.master.metastore.lsm.compaction.trigger", KeyType.INT,
        default=4, scope=Scope.MASTER,
        description="Size-tiered compaction fan-in: merge a tier once "
                    "this many adjacent same-tier runs accumulate.")
    MASTER_METASTORE_LSM_WAL_SYNC = _k(
        "atpu.master.metastore.lsm.wal.sync", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="fsync the metastore WAL on every append. Off by "
                    "default: the journal is the durability source of "
                    "truth and replays over the metastore on recovery.")

    # --- master: RPC admission control ---
    MASTER_RPC_ADMISSION_ENABLED = _k(
        "atpu.master.rpc.admission.enabled", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Per-principal token-bucket admission control on "
                    "the master RPC dispatch: calls beyond a "
                    "principal's rate are shed with a typed "
                    "ResourceExhausted carrying a retry-after hint "
                    "(which the client retry policy honors) instead "
                    "of queuing in the RPC executor. Off: dispatch is "
                    "byte-identical to a build without admission "
                    "control.")
    MASTER_RPC_ADMISSION_RATE = _k(
        "atpu.master.rpc.admission.rate", KeyType.FLOAT, default=200.0,
        scope=Scope.MASTER,
        description="Sustained master RPCs per second each principal "
                    "may issue before shedding starts.")
    MASTER_RPC_ADMISSION_BURST = _k(
        "atpu.master.rpc.admission.burst", KeyType.FLOAT, default=400.0,
        scope=Scope.MASTER,
        description="Token-bucket depth per principal: how far a "
                    "principal may briefly exceed the sustained rate.")
    MASTER_RPC_ADMISSION_MAX_PRINCIPALS = _k(
        "atpu.master.rpc.admission.max.principals", KeyType.INT,
        default=4096, scope=Scope.MASTER,
        description="Bound on tracked principal buckets (the key space "
                    "is client-controlled); beyond it the least-"
                    "recently-used bucket is evicted, so a spoofed-"
                    "principal flood cannot grow master memory.")
    MASTER_RPC_ADMISSION_EXEMPT = _k(
        "atpu.master.rpc.admission.exempt", KeyType.STRING,
        default="register,heartbeat,commit_block,get_worker_id,"
                "metrics_heartbeat,file_system_heartbeat,"
                "worker_heartbeat,register_worker",
        scope=Scope.MASTER,
        description="Comma-separated RPC method names never shed: "
                    "worker registration/heartbeats and block commits "
                    "are cluster-critical — shedding them would "
                    "destabilize the cluster faster than any tenant "
                    "flood.")

    # --- master: the update check ---
    MASTER_UPDATE_CHECK_ENABLED = _k(
        "atpu.master.update.check.enabled", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Periodically probe for a newer release (reference "
                    "UpdateChecker.java; OFF by default here — "
                    "phone-home is opt-in).")
    MASTER_UPDATE_CHECK_URL = _k(
        "atpu.master.update.check.url", scope=Scope.MASTER,
        description="JSON document with {\"latest\": \"x.y.z\"}; point "
                    "at an internal mirror.")
    MASTER_UPDATE_CHECK_INTERVAL = _k(
        "atpu.master.update.check.interval", KeyType.DURATION,
        default="1d", scope=Scope.MASTER)

    # --- serving surfaces: the proxy, the log server and FUSE (read by
    # nothing in the port yet) ---
    PROXY_WEB_PORT = _k(
        "atpu.proxy.web.port", KeyType.INT, default=39999,
        scope=Scope.SERVER,
        description="Port for the REST/S3 proxy process (reference: "
                    "proxy/AlluxioProxy.java).")
    LOGSERVER_PORT = _k(
        "atpu.logserver.port", KeyType.INT, default=45600,
        scope=Scope.ALL,
        description="Port of the centralized log server (reference: "
                    "logserver/AlluxioLogServer.java).")
    LOGSERVER_HOSTNAME = _k(
        "atpu.logserver.hostname", KeyType.STRING, default="",
        scope=Scope.ALL,
        description="When set, processes ship their log records to this "
                    "log server.")
    LOGSERVER_LOGS_DIR = _k(
        "atpu.logserver.logs.dir", KeyType.STRING,
        default="/var/log/alluxio-tpu", scope=Scope.SERVER)
    LOGSERVER_BIND_HOST = _k(
        "atpu.logserver.bind.host", KeyType.STRING, default="127.0.0.1",
        scope=Scope.SERVER,
        description="Bind address for the log server; the record stream "
                    "carries no authentication, so the default is "
                    "loopback.")
    PROXY_BIND_HOST = _k(
        "atpu.proxy.bind.host", KeyType.STRING, default="127.0.0.1",
        scope=Scope.SERVER,
        description="Bind address for the S3 proxy. The S3 dialect "
                    "carries no authentication, so the default is "
                    "loopback; set 0.0.0.0 only behind a trusted "
                    "network boundary.")
    PROXY_S3_ROOT = _k(
        "atpu.proxy.s3.root", KeyType.STRING, default="/s3",
        scope=Scope.SERVER,
        description="Namespace directory whose children are S3 buckets.")
    FUSE_MOUNT_POINT = _k(
        "atpu.fuse.mount.point", KeyType.STRING,
        default="/mnt/alluxio-tpu", scope=Scope.CLIENT,
        description="Local path where the FUSE adapter mounts the "
                    "namespace (reference: fuse/AlluxioFuse.java).")
    FUSE_FS_ROOT = _k(
        "atpu.fuse.fs.root", KeyType.STRING, default="/",
        scope=Scope.CLIENT,
        description="Namespace subtree exposed at the mount point.")
    FUSE_MOUNT_OPTIONS = _k(
        "atpu.fuse.mount.options", KeyType.STRING, default="",
        scope=Scope.CLIENT,
        description="Extra -o mount options (e.g. allow_other).")
    USER_QOS_STRIPE_LIMIT = _k(
        "atpu.user.qos.stripe.limit", KeyType.INT, default=0,
        scope=Scope.CLIENT,
        description="Per-tenant cap on concurrent remote-read stripe "
                    "streams (including hedges) across every striped "
                    "read this client process runs — keeps one "
                    "tenant's DCN fan-out from monopolizing a shared "
                    "client (FUSE mount, proxy). The frontier stripe "
                    "of each read always proceeds, so the cap shapes "
                    "readahead and hedging, never liveness. "
                    "0 = unlimited (today's behavior).")

    # --- master: metadata backups ---
    MASTER_DAILY_BACKUP_ENABLED = _k("atpu.master.daily.backup.enabled",
                                     KeyType.BOOL, default=False, scope=Scope.MASTER)
    MASTER_BACKUP_DIR = _k("atpu.master.backup.directory",
                           default="/tmp/alluxio_tpu/backups", scope=Scope.MASTER)
    MASTER_DAILY_BACKUP_INTERVAL = _k(
        "atpu.master.daily.backup.interval", KeyType.DURATION,
        default="24h", scope=Scope.MASTER,
        description="How often the scheduled-backup heartbeat lands a "
                    "metadata backup (reference: DailyMetadataBackup's "
                    "time-of-day schedule, interval-based here).")
    MASTER_DAILY_BACKUP_RETENTION = _k(
        "atpu.master.daily.backup.retention", KeyType.INT, default=3,
        scope=Scope.MASTER,
        description="Scheduled backups kept after pruning (reference: "
                    "alluxio.master.daily.backup.files.retained).")

    # --- master: observability (metrics history, health rules, remediation,
    # the web server) ---
    MASTER_METRICS_MAX_SOURCES = _k(
        "atpu.master.metrics.max.sources", KeyType.INT, default=4096,
        scope=Scope.MASTER,
        description="Distinct reporting sources the master's metrics "
                    "store accepts; reports from new sources beyond it "
                    "are dropped (counted in "
                    "Master.MetricsReportsDropped) — bounds memory "
                    "against spoofed source-name floods.")
    MASTER_METRICS_HISTORY_ENABLED = _k(
        "atpu.master.metrics.history.enabled", KeyType.BOOL, default=True,
        scope=Scope.MASTER,
        description="Keep bounded per-(source, metric) time series of "
                    "the metric snapshots arriving on the metrics "
                    "heartbeat (raw + 1m/10m rollups), served at "
                    "/api/v1/master/metrics/history and `fsadmin "
                    "report history`.")
    MASTER_METRICS_HISTORY_CAPACITY = _k(
        "atpu.master.metrics.history.capacity", KeyType.INT, default=360,
        scope=Scope.MASTER,
        description="Samples retained per series per resolution (raw, "
                    "1m, 10m) — oldest evicted first. Total history "
                    "memory is bounded by max.series x 3 x capacity "
                    "points.")
    MASTER_METRICS_HISTORY_RETENTION = _k(
        "atpu.master.metrics.history.retention", KeyType.DURATION,
        default="1h", scope=Scope.MASTER,
        description="Raw samples older than this are pruned (1m "
                    "rollups keep 10x, 10m rollups 60x, still capped "
                    "by capacity).")
    MASTER_METRICS_HISTORY_MAX_SERIES = _k(
        "atpu.master.metrics.history.max.series", KeyType.INT,
        default=4096, scope=Scope.MASTER,
        description="Hard cap on distinct (source, metric) series; "
                    "samples for series beyond it (or outside the "
                    "prefix allowlist) are dropped and counted in "
                    "Master.MetricsHistorySamplesDropped — bounds "
                    "memory against metric-name cardinality floods.")
    MASTER_METRICS_HISTORY_ALLOW_PREFIXES = _k(
        "atpu.master.metrics.history.allow.prefixes", KeyType.STRING,
        default="Cluster.,Master.,Worker.,Client.,JobMaster.,"
                "JobWorker.,Process.",
        scope=Scope.MASTER,
        description="Comma-separated metric-name prefixes admitted "
                    "into the history store; anything else (e.g. a "
                    "spoofed-name flood) is dropped before it can "
                    "mint a series.")
    MASTER_HEALTH_ENABLED = _k(
        "atpu.master.health.enabled", KeyType.BOOL, default=True,
        scope=Scope.MASTER,
        description="Continuously evaluate the declarative health "
                    "rules (cluster doctor) over the metrics history; "
                    "verdicts at /api/v1/master/health and `fsadmin "
                    "report health`.")
    MASTER_HEALTH_EVAL_INTERVAL = _k(
        "atpu.master.health.eval.interval", KeyType.DURATION,
        default="10s", scope=Scope.MASTER,
        description="Period of the master's health-rule evaluation "
                    "heartbeat.")
    MASTER_HEALTH_STALL_THRESHOLD = _k(
        "atpu.master.health.stall.threshold", KeyType.FLOAT, default=0.5,
        scope=Scope.MASTER,
        description="InputBoundFraction above this (sustained over the "
                    "stall window) fires the input-stall alert.")
    MASTER_HEALTH_STALL_WINDOW = _k(
        "atpu.master.health.stall.window", KeyType.DURATION,
        default="60s", scope=Scope.MASTER,
        description="Evidence window the input-stall rule averages "
                    "over.")
    MASTER_HEALTH_METADATA_LOCK_WAIT_THRESHOLD = _k(
        "atpu.master.health.metadata.lock.wait.threshold",
        KeyType.DURATION, default="50ms", scope=Scope.MASTER,
        description="metadata-lock-contention rule: fire when the "
                    "master's inode-lock acquisition p99 "
                    "(Master.MetadataInodeLockWaitTime.p99) stays above "
                    "this over the stall window — sustained path-lock "
                    "contention on the metadata control plane.")
    MASTER_HEALTH_FIRE_AFTER = _k(
        "atpu.master.health.fire.after", KeyType.DURATION, default="30s",
        scope=Scope.MASTER,
        description="Debounce: a rule must stay violated this long "
                    "before its alert moves pending -> firing.")
    MASTER_HEALTH_RESOLVE_AFTER = _k(
        "atpu.master.health.resolve.after", KeyType.DURATION,
        default="60s", scope=Scope.MASTER,
        description="Debounce: a firing alert must stay clean this "
                    "long before it resolves.")
    MASTER_METASTORE_COMPACTION_DEBT_RUNS = _k(
        "atpu.master.metastore.compaction.debt.runs", KeyType.INT,
        default=24, scope=Scope.MASTER,
        description="Health threshold: mean Master.MetastoreRuns above "
                    "this sustained over the rule window fires the "
                    "metastore-compaction-debt alert (compaction is "
                    "not keeping up with flushes).")
    MASTER_REMEDIATION_ENABLED = _k(
        "atpu.master.remediation.enabled", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Act on firing health alerts with bounded, audited "
                    "remediations (quarantine, targeted re-replication, "
                    "client retuning pushed on the metrics heartbeat). "
                    "OFF by default: with it off the cluster behaves "
                    "exactly as if the engine did not exist. See "
                    "docs/self_healing.md.")
    MASTER_REMEDIATION_DRY_RUN = _k(
        "atpu.master.remediation.dry.run", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Evaluate and AUDIT every remediation the engine "
                    "would take without executing any of them — the "
                    "recommended first week of production rollout.")
    MASTER_REMEDIATION_MAX_ACTIONS_PER_WINDOW = _k(
        "atpu.master.remediation.max.actions.per.window", KeyType.INT,
        default=4, scope=Scope.MASTER,
        description="Hard cap on remediation actions (executed or "
                    "dry-run) per sliding window; further actions are "
                    "suppressed-but-audited. A runaway rule can "
                    "quarantine at most this many workers per window.")
    MASTER_REMEDIATION_WINDOW = _k(
        "atpu.master.remediation.window", KeyType.DURATION,
        default="10min", scope=Scope.MASTER,
        description="Sliding window the action cap counts over.")
    MASTER_REMEDIATION_COOLDOWN = _k(
        "atpu.master.remediation.cooldown", KeyType.DURATION,
        default="5min", scope=Scope.MASTER,
        description="Minimum spacing between two actions of the same "
                    "kind on the same subject — a flapping alert cannot "
                    "thrash quarantine/release or re-replicate the same "
                    "worker's blocks in a loop.")
    MASTER_REMEDIATION_PROBATION = _k(
        "atpu.master.remediation.probation", KeyType.DURATION,
        default="60s", scope=Scope.MASTER,
        description="After the triggering alert resolves, a quarantined "
                    "worker (or pushed tuning overlay) is held this much "
                    "longer before release/revert — resolution debounce "
                    "on the action side.")
    MASTER_REMEDIATION_REREPLICATE_BLOCKS = _k(
        "atpu.master.remediation.rereplicate.blocks", KeyType.INT,
        default=8, scope=Scope.MASTER,
        description="Hottest blocks (top-tier residents) re-replicated "
                    "off a worker per re-replication action.")
    MASTER_REMEDIATION_QUARANTINE_MAX_FRACTION = _k(
        "atpu.master.remediation.quarantine.max.fraction", KeyType.FLOAT,
        default=0.5, scope=Scope.MASTER,
        description="Healthy-capacity floor: at most this fraction of "
                    "registered workers (min 1) may be quarantined at "
                    "once — a systemic condition that flags the whole "
                    "fleet must not let the engine empty the placement "
                    "set and amplify the outage.")
    MASTER_WEB_ENABLED = _k(
        "atpu.master.web.enabled", KeyType.BOOL, default=False,
        scope=Scope.MASTER,
        description="Serve the read-only HTTP/JSON state endpoint "
                    "(reference: AlluxioMasterRestServiceHandler).")
    CLUSTER_NAME = _k("atpu.cluster.name", default="default-cluster",
                      consistency=ConsistencyLevel.ENFORCE)
    MASTER_WEB_PORT = _k("atpu.master.web.port", KeyType.INT, default=19999)
    MASTER_WEB_BIND_HOST = _k(
        "atpu.master.web.bind.host", KeyType.STRING, default="0.0.0.0",
        scope=Scope.MASTER,
        description="Bind address for the read-only master web/REST "
                    "endpoint.")

    # --- security: authorization (the file master's permission checks) ---
    SECURITY_AUTHORIZATION_PERMISSION_ENABLED = _k(
        "atpu.security.authorization.permission.enabled", KeyType.BOOL, default=True)
    SECURITY_AUTHORIZATION_PERMISSION_UMASK = _k(
        "atpu.security.authorization.permission.umask", KeyType.INT, default=0o022)
    SECURITY_AUTHORIZATION_PERMISSION_SUPERGROUP = _k(
        "atpu.security.authorization.permission.supergroup", default="supergroup",
        description="Members act as superusers (reference: "
                    "alluxio.security.authorization.permission.supergroup).")

    # --- tracing ---
    TRACE_ENABLED = _k(
        "atpu.trace.enabled", KeyType.BOOL, default=False,
        scope=Scope.ALL,
        description="Record RPC/operation spans into the in-process "
                    "trace ring (served at /api/v1/master/trace). "
                    "Spans carry a W3C-traceparent context across RPC "
                    "hops, so client/worker/master spans stitch into "
                    "one trace.")
    TRACE_SAMPLE_RATE = _k(
        "atpu.trace.sample.rate", KeyType.FLOAT, default=1.0,
        scope=Scope.ALL,
        description="Probability a NEW root trace is recorded (0..1). "
                    "Child spans — local and remote — inherit the "
                    "root's decision, so traces never tear.")
    TRACE_RING_CAPACITY = _k(
        "atpu.trace.ring.capacity", KeyType.INT, default=4096,
        scope=Scope.ALL,
        description="Completed spans retained per process (oldest "
                    "evicted first). Workers/clients drain the ring to "
                    "the master on the metrics heartbeat.")
    PROFILE_ENABLED = _k(
        "atpu.profile.enabled", KeyType.BOOL, default=False,
        scope=Scope.ALL,
        description="Run the sampling thread-stack profiler "
                    "(utils/profiler.py): a daemon thread periodically "
                    "snapshots every thread's Python stack and merges "
                    "them into flame-graph counts, shipped to the "
                    "master on the metrics heartbeat. Off by default — "
                    "the read path must stay byte-identical when "
                    "profiling is disabled.")
    PROFILE_SAMPLE_INTERVAL_MS = _k(
        "atpu.profile.sample.interval.ms", KeyType.INT, default=97,
        scope=Scope.ALL,
        description="Milliseconds between stack samples. A prime-ish "
                    "default avoids beating against periodic work. "
                    "Each wake forces a GIL handoff against whatever "
                    "thread is running (~1ms observed), so the cost is "
                    "per-wake, not per-stack: ~10Hz keeps the tax "
                    "under the 2% obs-profile-overhead gate while "
                    "still resolving hot paths over a heartbeat "
                    "window.")
    PROFILE_MAX_STACKS = _k(
        "atpu.profile.max.stacks", KeyType.INT, default=2048,
        scope=Scope.ALL,
        description="Distinct merged stacks retained per process; "
                    "when full, new stacks are dropped (the hot paths "
                    "are by definition already in the table).")
    PROFILE_STACK_DEPTH = _k(
        "atpu.profile.stack.depth", KeyType.INT, default=24,
        scope=Scope.ALL,
        description="Frames kept per sampled stack, innermost first — "
                    "deeper frames are truncated to bound sample cost "
                    "and wire size.")

    # --- client: the file-system client, its streams and metadata cache ---
    USER_BLOCK_SIZE_BYTES_DEFAULT = _k(
        "atpu.user.block.size.bytes.default", KeyType.BYTES, default="64MB",
        description="Default block size for new files "
                    "(reference: alluxio.user.block.size.bytes.default).")
    USER_BLOCK_READ_POLICY = _k(
        "atpu.user.block.read.location.policy", KeyType.ENUM, default="LOCAL_FIRST",
        choices=("LOCAL_FIRST", "LOCAL_FIRST_AVOID_EVICTION", "MOST_AVAILABLE",
                 "ROUND_ROBIN", "DETERMINISTIC_HASH", "SPECIFIC_HOST"),
        scope=Scope.CLIENT)
    USER_BLOCK_WRITE_POLICY = _k(
        "atpu.user.block.write.location.policy", KeyType.ENUM, default="LOCAL_FIRST",
        choices=("LOCAL_FIRST", "LOCAL_FIRST_AVOID_EVICTION", "MOST_AVAILABLE",
                 "ROUND_ROBIN", "DETERMINISTIC_HASH", "SPECIFIC_HOST"),
        scope=Scope.CLIENT)
    USER_BLOCK_WRITE_UNAVAILABLE_WINDOW = _k(
        "atpu.user.block.write.unavailable.window", KeyType.DURATION,
        default="15s", scope=Scope.CLIENT,
        description="How long a block write waits for a live worker before "
                    "failing. Covers the transient window where the only "
                    "worker missed heartbeats (host overload) and is "
                    "re-registering; 0 fails immediately (reference: client "
                    "UnavailableException retry on write).")
    USER_SHORT_CIRCUIT_ENABLED = _k("atpu.user.short.circuit.enabled", KeyType.BOOL,
                                    default=True, scope=Scope.CLIENT)
    USER_STANDBY_READS_ENABLED = _k(
        "atpu.user.standby.reads.enabled", KeyType.BOOL, default=False,
        scope=Scope.CLIENT,
        description="Route read-marked metadata RPCs (GetStatus/"
                    "ListStatus/Exists) round-robin across the standby "
                    "masters of atpu.master.rpc.addresses instead of "
                    "the primary; responses carry the standby's "
                    "md_version stamp so the client metadata cache "
                    "stays coherent (docs/ha.md).  Requires "
                    "atpu.master.ha.standby.reads.enabled on the "
                    "masters.")
    USER_FILE_PASSIVE_CACHE_ENABLED = _k(
        "atpu.user.file.passive.cache.enabled", KeyType.BOOL, default=True,
        scope=Scope.CLIENT)
    USER_FILE_READ_TYPE_DEFAULT = _k(
        "atpu.user.file.readtype.default", KeyType.ENUM, default="CACHE",
        choices=("NO_CACHE", "CACHE", "CACHE_PROMOTE"), scope=Scope.CLIENT)
    USER_FILE_WRITE_TYPE_DEFAULT = _k(
        "atpu.user.file.writetype.default", KeyType.ENUM, default="ASYNC_THROUGH",
        choices=("MUST_CACHE", "CACHE_THROUGH", "THROUGH", "ASYNC_THROUGH", "NONE"),
        scope=Scope.CLIENT)
    USER_FILE_REPLICATION_MIN = _k("atpu.user.file.replication.min", KeyType.INT,
                                   default=0, scope=Scope.CLIENT)
    USER_FILE_REPLICATION_MAX = _k("atpu.user.file.replication.max", KeyType.INT,
                                   default=-1, scope=Scope.CLIENT)
    USER_FILE_METADATA_SYNC_INTERVAL = _k(
        "atpu.user.file.metadata.sync.interval", KeyType.DURATION, default="-1s",
        scope=Scope.CLIENT,
        description="-1 = never sync on access, 0 = always, >0 = min interval "
                    "(reference: common options sync interval, InodeSyncStream).")
    USER_STREAMING_READER_CHUNK_SIZE = _k(
        "atpu.user.streaming.reader.chunk.size.bytes", KeyType.BYTES, default="1MB",
        scope=Scope.CLIENT)
    USER_STREAMING_WRITER_CHUNK_SIZE = _k(
        "atpu.user.streaming.writer.chunk.size.bytes", KeyType.BYTES, default="1MB",
        scope=Scope.CLIENT)
    USER_CLIENT_CACHE_DIR = _k("atpu.user.client.cache.dir",
                               default="/tmp/alluxio_tpu/client_cache",
                               scope=Scope.CLIENT)
    USER_CLIENT_CACHE_SIZE = _k("atpu.user.client.cache.size", KeyType.BYTES,
                                default="512MB", scope=Scope.CLIENT)
    USER_CLIENT_CACHE_PAGE_SIZE = _k("atpu.user.client.cache.page.size",
                                     KeyType.BYTES, default="1MB", scope=Scope.CLIENT)
    USER_CLIENT_CACHE_EVICTOR = _k("atpu.user.client.cache.evictor.class",
                                   KeyType.ENUM, default="LRU",
                                   choices=("LRU", "LFU"), scope=Scope.CLIENT)
    USER_CLIENT_CACHE_HBM_SIZE = _k(
        "atpu.user.client.cache.hbm.size", KeyType.BYTES, default="0",
        scope=Scope.CLIENT,
        description="Capacity of the HBM page-cache tier (pages as jax.Array). "
                    "0 disables the device tier. TPU-native addition; no "
                    "reference analogue.")
    USER_CLIENT_CACHE_ENABLED = _k("atpu.user.client.cache.enabled", KeyType.BOOL,
                                   default=False, scope=Scope.CLIENT)
    USER_CONF_CLUSTER_DEFAULT_ENABLED = _k(
        "atpu.user.conf.cluster.default.enabled", KeyType.BOOL, default=True,
        description="Pull cluster-default configuration from the master at "
                    "client start (reference: meta_master.proto:196-211).")
    USER_CONF_SYNC_INTERVAL = _k("atpu.user.conf.sync.interval", KeyType.DURATION,
                                 default="1min", scope=Scope.CLIENT)
    USER_METADATA_CACHE_ENABLED = _k(
        "atpu.user.metadata.cache.enabled", KeyType.BOOL, default=False,
        scope=Scope.CLIENT,
        description="Cache GetStatus/ListStatus results client-side in a "
                    "bounded LRU kept coherent by master-pushed "
                    "invalidations on the metrics heartbeat (plus the "
                    "expiration-time TTL as a fallback bound) — warm "
                    "metadata reads become client-local. See "
                    "docs/metadata.md.")
    USER_METADATA_CACHE_EXPIRATION_TIME = _k(
        "atpu.user.metadata.cache.expiration.time", KeyType.DURATION, default="10min",
        scope=Scope.CLIENT)
    USER_METADATA_CACHE_MAX_SIZE = _k("atpu.user.metadata.cache.max.size",
                                      KeyType.INT, default=10_000,
                                      scope=Scope.CLIENT,
                                      description="Entry cap of the client "
                                                  "metadata cache (LRU).")
    USER_METRICS_COLLECTION_ENABLED = _k(
        "atpu.user.metrics.collection.enabled", KeyType.BOOL, default=False,
        scope=Scope.CLIENT,
        description="Ship client metric snapshots to the master for "
                    "cluster aggregation (reference: ClientMasterSync).")
    USER_METRICS_HEARTBEAT_INTERVAL = _k(
        "atpu.user.metrics.heartbeat.interval", KeyType.DURATION,
        default="10s", scope=Scope.CLIENT)

    # --- job service ---
    JOB_MASTER_HOSTNAME = _k("atpu.job.master.hostname", default="localhost")
    JOB_MASTER_RPC_PORT = _k("atpu.job.master.rpc.port", KeyType.INT, default=20001)
    JOB_MASTER_JOB_CAPACITY = _k("atpu.job.master.job.capacity", KeyType.INT,
                                 default=100_000, scope=Scope.JOB_MASTER)
    JOB_MASTER_WORKER_TIMEOUT = _k("atpu.job.master.worker.timeout",
                                   KeyType.DURATION, default="1min",
                                   scope=Scope.JOB_MASTER)
    JOB_MASTER_LOST_WORKER_INTERVAL = _k(
        "atpu.job.master.lost.worker.interval", KeyType.DURATION,
        default="10s", scope=Scope.JOB_MASTER)
    JOB_WORKER_THREADPOOL_SIZE = _k("atpu.job.worker.threadpool.size", KeyType.INT,
                                    default=8, scope=Scope.JOB_WORKER)
    JOB_WORKER_HEARTBEAT_INTERVAL = _k("atpu.job.worker.heartbeat.interval",
                                       KeyType.DURATION, default="1s",
                                       scope=Scope.JOB_WORKER)

    # --- the device loader (client/torch_io.py) ---
    TPU_PREFETCH_BUFFER_BATCHES = _k("atpu.tpu.prefetch.buffer.batches", KeyType.INT,
                                     default=2,
                                     description="Device-side double-buffering depth "
                                                 "for the zero-copy iterator.")

    # --- clairvoyant prefetch service (prefetch/; NoPFS arxiv 2101.08734,
    #     Hoard arxiv 1812.00669 — no reference analogue) ---
    PREFETCH_ENABLED = _k(
        "atpu.prefetch.enabled", KeyType.BOOL, default=False,
        scope=Scope.CLIENT, aliases=("prefetch.enabled",),
        description="Run the clairvoyant prefetch control loop (oracle "
                    "-> scheduler -> agent) for seeded-shuffle reads. "
                    "Off: the loader's behavior is byte-identical to a "
                    "build without the subsystem.")
    PREFETCH_LOOKAHEAD_BLOCKS = _k(
        "atpu.prefetch.lookahead.blocks", KeyType.INT, default=16,
        scope=Scope.CLIENT, aliases=("prefetch.lookahead.blocks",),
        description="How many future accesses (per the oracle's exact "
                    "order, across epoch boundaries) the scheduler "
                    "plans placements for each tick.")
    PREFETCH_BUDGET_BYTES = _k(
        "atpu.prefetch.budget.bytes", KeyType.BYTES, default="256MB",
        scope=Scope.CLIENT, aliases=("prefetch.budget.bytes",),
        description="Ceiling on prefetched-ahead bytes (issued + ready, "
                    "not yet consumed) across all tiers; the planner "
                    "stops at the nearest-deadline block that no longer "
                    "fits (backpressure).")
    PREFETCH_HBM_FRACTION = _k(
        "atpu.prefetch.hbm.fraction", KeyType.FLOAT, default=0.25,
        scope=Scope.CLIENT, aliases=("prefetch.hbm.fraction",),
        description="Slice of the budget placed directly into the HBM "
                    "tier (a device-resident tensor); the rest goes to "
                    "worker DRAM. Effective only when a loader with an "
                    "HBM store is bound.")
    PREFETCH_HEARTBEAT_INTERVAL = _k(
        "atpu.prefetch.heartbeat.interval.ms", KeyType.DURATION,
        default="100ms", scope=Scope.CLIENT,
        aliases=("prefetch.heartbeat.interval.ms",),
        description="Agent tick cadence: completions are observed and "
                    "the next placement plan issued once per tick.")


# Parameterized families (reference: PropertyKey.Template, PropertyKey.java:5668)
class Templates:
    WORKER_TIER_ALIAS = _template(
        "atpu.worker.tieredstore.level{}.alias",
        r"atpu\.worker\.tieredstore\.level(\d+)\.alias",
        KeyType.STRING, lambda lvl: {0: "MEM", 1: "SSD", 2: "HDD"}.get(int(lvl)),
        Scope.WORKER)
    WORKER_TIER_DIRS_PATH = _template(
        "atpu.worker.tieredstore.level{}.dirs.path",
        r"atpu\.worker\.tieredstore\.level(\d+)\.dirs\.path",
        KeyType.LIST, lambda lvl: None, Scope.WORKER)
    WORKER_TIER_DIRS_QUOTA = _template(
        "atpu.worker.tieredstore.level{}.dirs.quota",
        r"atpu\.worker\.tieredstore\.level(\d+)\.dirs\.quota",
        KeyType.LIST, lambda lvl: None, Scope.WORKER)
    WORKER_TIER_HIGH_WATERMARK = _template(
        "atpu.worker.tieredstore.level{}.watermark.high.ratio",
        r"atpu\.worker\.tieredstore\.level(\d+)\.watermark\.high\.ratio",
        KeyType.FLOAT, lambda lvl: 0.95, Scope.WORKER)
    WORKER_TIER_LOW_WATERMARK = _template(
        "atpu.worker.tieredstore.level{}.watermark.low.ratio",
        r"atpu\.worker\.tieredstore\.level(\d+)\.watermark\.low\.ratio",
        KeyType.FLOAT, lambda lvl: 0.7, Scope.WORKER)
    MASTER_MOUNT_TABLE_OPTION = _template(
        "atpu.master.mount.table.{}.option.{}",
        r"atpu\.master\.mount\.table\.(\w+)\.option\.(.+)",
        KeyType.STRING, lambda *_: None, Scope.MASTER)
    MASTER_IMPERSONATION_USERS = _template(
        "atpu.master.security.impersonation.{}.users",
        r"atpu\.master\.security\.impersonation\.([^.]+)\.users",
        KeyType.LIST, lambda *_: None, Scope.MASTER)
    MASTER_IMPERSONATION_GROUPS = _template(
        "atpu.master.security.impersonation.{}.groups",
        r"atpu\.master\.security\.impersonation\.([^.]+)\.groups",
        KeyType.LIST, lambda *_: None, Scope.MASTER)
