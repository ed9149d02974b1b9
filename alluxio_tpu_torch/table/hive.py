"""Hive metastore under-database (a copy of ``alluxio_tpu/table/hive.py``).

Re-design of ``table/server/underdb/hive/src/main/java/alluxio/table/
under/hive/HiveDatabase.java:59`` (+ ``HiveUtils``): snapshot a Hive
database's tables/partitions from a metastore into the journaled
catalog. Differences from the reference, on purpose:

* The HMS client is the ~150-line hand-rolled binary-protocol subset in
  ``table/thrift_proto.py`` (read path only: databases, tables,
  partitions) instead of the hive-exec jar.
* Path translation (reference ``PathTranslator``): HMS locations are UFS
  URIs (``hdfs://nn/warehouse/t`` / ``s3://bucket/t``); they map into
  the namespace through the caller-supplied mount mapping
  (``path_translations`` attach option, or automatic longest-prefix
  match against the cluster's mount table), so table reads ride the
  caching data plane.

HMS Thrift field ids used (hive_metastore.thrift, stable since 1.x):
  Table:   1 tableName, 7 sd, 8 partitionKeys
  StorageDescriptor: 1 cols, 2 location
  FieldSchema: 1 name, 2 type
  Partition: 1 values, 6 sd
"""

from __future__ import annotations

from typing import Dict, List, Optional

from alluxio_tpu_torch.table.thrift_proto import (
    I16, STRING, ThriftClient, ThriftError,
)
from alluxio_tpu_torch.table.udb import UdbTable, UnderDatabase
from alluxio_tpu_torch.utils.exceptions import NotFoundError


def parse_thrift_uri(connection: str) -> "tuple[str, int]":
    """``thrift://host:port`` -> (host, port)."""
    rest = connection
    if "://" in rest:
        scheme, _, rest = rest.partition("://")
        if scheme != "thrift":
            raise ValueError(
                f"hive udb needs a thrift:// uri, got {connection!r}")
    host, _, port = rest.partition("/")[0].rpartition(":")
    if not host:
        raise ValueError(f"no port in metastore uri {connection!r}")
    return host, int(port)


class HiveMetastoreClient:
    """Read-side HMS client: the four calls the catalog snapshot needs."""

    def __init__(self, host: str, port: int, *, framed: bool = False,
                 timeout_s: float = 30.0) -> None:
        self._c = ThriftClient(host, port, framed=framed,
                               timeout_s=timeout_s)

    def close(self) -> None:
        self._c.close()

    def __enter__(self) -> "HiveMetastoreClient":
        self._c.connect()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _call(self, method: str, args) -> dict:
        result = self._c.call(method, args)
        for fid, v in result.items():
            if fid != 0 and isinstance(v, dict) and v:
                # declared exception struct (NoSuchObjectException etc.
                # carry their message in field 1)
                raise NotFoundError(f"{method}: {v.get(1, v)}")
        return result

    def get_all_databases(self) -> List[str]:
        return self._call("get_all_databases", [])[0] or []

    def get_database(self, name: str) -> dict:
        return self._call("get_database", [(1, STRING, name)])[0] or {}

    def get_all_tables(self, db: str) -> List[str]:
        return self._call("get_all_tables", [(1, STRING, db)])[0] or []

    def get_table(self, db: str, table: str) -> dict:
        return self._call("get_table", [(1, STRING, db),
                                        (2, STRING, table)])[0] or {}

    def get_partitions(self, db: str, table: str,
                       max_parts: int = -1) -> List[dict]:
        return self._call("get_partitions", [
            (1, STRING, db), (2, STRING, table),
            (3, I16, max_parts)])[0] or []


class PathTranslator:
    """UFS location -> namespace path, longest-prefix first (reference:
    ``table/server/common/.../udb/PathTranslator.java``)."""

    def __init__(self, mapping: Dict[str, str]) -> None:
        #: {ufs_uri_prefix: namespace_path}
        self._map = sorted(((u.rstrip("/"), a.rstrip("/") or "/")
                            for u, a in mapping.items()),
                           key=lambda kv: -len(kv[0]))

    def translate(self, ufs_uri: str) -> Optional[str]:
        ufs_uri = ufs_uri.rstrip("/")
        for prefix, alluxio in self._map:
            if ufs_uri == prefix:
                return alluxio
            if ufs_uri.startswith(prefix + "/"):
                return alluxio + ufs_uri[len(prefix):]
        return None


def mount_translations(fs) -> Dict[str, str]:
    """Auto-derive the translation map from the cluster's mount table."""
    out: Dict[str, str] = {}
    try:
        for m in fs.get_mount_points():
            if m.ufs_uri:
                out[m.ufs_uri] = m.alluxio_path
    except Exception:  # noqa: BLE001 — no mount RPC: explicit map only
        pass
    return out


class HiveUnderDatabase(UnderDatabase):
    """``table attachdb hive thrift://host:port <db>``.

    Options (attach properties):
      hive.metastore.framed    "true" for TFramedTransport metastores
      path_translations        "ufs1=/ns1,ufs2=/ns2" explicit overrides
                               (defaults to the cluster mount table)
    """

    udb_type = "hive"

    def __init__(self, fs, connection: str, db_name: str = "",
                 options: Optional[Dict[str, str]] = None) -> None:
        self._fs = fs
        self._conn = connection
        self._name = db_name
        opts = options or {}
        self._framed = str(opts.get("hive.metastore.framed",
                                    "")).lower() == "true"
        mapping = mount_translations(fs)
        spec = opts.get("path_translations", "")
        for pair in spec.split(","):
            if "=" in pair:
                u, _, a = pair.partition("=")
                mapping[u.strip()] = a.strip()
        self._translator = PathTranslator(mapping)

    def _client(self) -> HiveMetastoreClient:
        host, port = parse_thrift_uri(self._conn)
        return HiveMetastoreClient(host, port, framed=self._framed)

    def database_name(self) -> str:
        if not self._name:
            raise NotFoundError("hive udb needs an explicit database "
                                "name (attachdb <type> <uri> <db>)")
        return self._name

    def _translate(self, location: str) -> str:
        t = self._translator.translate(location)
        if t is not None:
            return t
        # untranslated locations stay as-is: reads bypass the cache but
        # the catalog is still complete (reference logs the same way)
        return location

    def table_names(self) -> List[str]:
        with self._client() as c:
            return sorted(c.get_all_tables(self.database_name()))

    def get_table(self, name: str) -> UdbTable:
        db = self.database_name()
        with self._client() as c:
            t = c.get_table(db, name)
            if not t:
                raise NotFoundError(f"hive table {db}.{name} not found")
            sd = t.get(7, {})
            schema = [{"name": f.get(1, ""), "type": f.get(2, "")}
                      for f in sd.get(1, [])]
            pkeys = [f.get(1, "") for f in t.get(8, [])]
            location = self._translate(sd.get(2, ""))
            rows = []
            if pkeys:
                rows = [(p.get(1, []),
                         self._translate(p.get(6, {}).get(2, "")))
                        for p in c.get_partitions(db, name)]
        return UdbTable.build(name, schema, location, pkeys, rows)
