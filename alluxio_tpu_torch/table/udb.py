"""Under-database SPI: pluggable external catalogs (a copy of
``alluxio_tpu/table/udb.py`` without its Hive and Glue connectors).

Re-design of ``table/server/common/src/main/java/alluxio/table/common/udb/
{UnderDatabase,UdbTable,UdbPartition}.java`` + ``PathTranslator``: a UDB
enumerates tables and partitions with their storage locations; the table
master snapshots that into its journaled catalog, translating UFS paths
into namespace paths so reads go through the caching data plane.

The reference ships ``hive`` and ``glue`` connectors (Thrift/AWS
services). This environment has neither, so the in-tree connector is
**FsUnderDatabase**: a Hive-*layout* database rooted at a directory —
each table a subdirectory of Parquet files, partitions as nested
``key=value`` subdirectories, schema read from Parquet footers. That is
the same metadata a Hive metastore would return for an external table;
the SPI seam is where a Thrift-backed UDB would plug in. The JAX package
has those two connectors (``table/{hive,glue}.py``); the port does not
yet, and its factory refuses both types with ``NotSupportedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from alluxio_tpu_torch.utils.exceptions import NotFoundError, NotSupportedError


@dataclass
class UdbPartition:
    """One partition: spec (k=v values) + storage location."""

    spec: str                      # "" for unpartitioned, else "k1=v1/k2=v2"
    location: str                  # namespace (Alluxio) path
    values: Dict[str, str] = field(default_factory=dict)


@dataclass
class UdbTable:
    name: str
    schema: List[Dict[str, str]]   # [{"name":..., "type":...}]
    location: str                  # namespace path of the table root
    partition_keys: List[str] = field(default_factory=list)
    partitions: List[UdbPartition] = field(default_factory=list)

    def to_wire(self) -> dict:
        return {
            "name": self.name, "schema": self.schema,
            "location": self.location,
            "partition_keys": list(self.partition_keys),
            "partitions": [{"spec": p.spec, "location": p.location,
                            "values": dict(p.values)}
                           for p in self.partitions],
        }

    @staticmethod
    def from_wire(w: dict) -> "UdbTable":
        return UdbTable(
            name=w["name"], schema=list(w.get("schema", [])),
            location=w["location"],
            partition_keys=list(w.get("partition_keys", [])),
            partitions=[UdbPartition(p["spec"], p["location"],
                                     dict(p.get("values", {})))
                        for p in w.get("partitions", [])])

    @staticmethod
    def build(name: str, schema: List[Dict[str, str]], location: str,
              partition_keys: List[str],
              value_rows: "List[tuple]") -> "UdbTable":
        """Assemble a snapshot table the way every UDB does: each
        ``(values, location)`` row becomes a ``k=v/k2=v2`` partition;
        an unpartitioned table gets the single root partition."""
        partitions = [
            UdbPartition("/".join(f"{k}={v}" for k, v in
                                  zip(partition_keys, values)),
                         loc, dict(zip(partition_keys, values)))
            for values, loc in value_rows]
        return UdbTable(name=name, schema=schema, location=location,
                        partition_keys=partition_keys,
                        partitions=partitions or
                        [UdbPartition("", location, {})])


class UnderDatabase:
    """SPI (reference: ``UnderDatabase.java``)."""

    #: registry key (the reference's udb `type`, e.g. "hive")
    udb_type = ""

    def database_name(self) -> str:
        raise NotImplementedError

    def table_names(self) -> List[str]:
        raise NotImplementedError

    def get_table(self, name: str) -> UdbTable:
        raise NotImplementedError


class FsUnderDatabase(UnderDatabase):
    """Hive-directory-layout database over the mounted namespace.

    ``connection`` is a namespace path (usually a mount of an object
    store); tables are its child directories; ``key=value`` subdirs are
    partitions; schemas come from Parquet footers via the caching read
    path (so attaching a db warms the footers).
    """

    udb_type = "fs"

    def __init__(self, fs, connection: str, db_name: str = "") -> None:
        self._fs = fs
        self._root = connection.rstrip("/")
        self._name = db_name or self._root.rsplit("/", 1)[-1]

    def database_name(self) -> str:
        return self._name

    def table_names(self) -> List[str]:
        return sorted(info.name for info in self._fs.list_status(self._root)
                      if info.folder)

    def get_table(self, name: str) -> UdbTable:
        root = f"{self._root}/{name}"
        if not self._fs.exists(root):
            raise NotFoundError(f"table directory {root} does not exist")
        partition_keys: List[str] = []
        partitions: List[UdbPartition] = []
        sample_file: Optional[str] = None

        def walk(path: str, values: Dict[str, str]) -> None:
            nonlocal sample_file
            files, subparts = [], []
            for info in self._fs.list_status(path):
                if info.folder and "=" in info.name:
                    subparts.append(info)
                elif not info.folder and info.name.endswith(".parquet"):
                    files.append(info)
            if subparts:
                for info in subparts:
                    k, _, v = info.name.partition("=")
                    if k not in partition_keys:
                        partition_keys.append(k)
                    walk(f"{path}/{info.name}", {**values, k: v})
            elif files:
                spec = "/".join(f"{k}={v}" for k, v in values.items())
                partitions.append(UdbPartition(spec, path, dict(values)))
                if sample_file is None:
                    sample_file = f"{path}/{files[0].name}"

        walk(root, {})
        schema = self._read_schema(sample_file) if sample_file else []
        return UdbTable(name=name, schema=schema, location=root,
                        partition_keys=partition_keys,
                        partitions=partitions or
                        [UdbPartition("", root, {})])

    def _read_schema(self, path: str) -> List[Dict[str, str]]:
        from alluxio_tpu_torch.table.reader import open_parquet

        pf = open_parquet(self._fs, path)
        return [{"name": f.name, "type": str(f.type)}
                for f in pf.schema_arrow]


def udb_factory(udb_type: str, fs, connection: str, db_name: str = "",
                options: Optional[Dict[str, str]] = None) -> UnderDatabase:
    """Registry keyed by udb type (reference: ServiceLoader discovery)."""
    if udb_type == "fs":
        return FsUnderDatabase(fs, connection, db_name)
    if udb_type in ("hive", "glue"):
        raise NotSupportedError(
            f"under-database type {udb_type!r}: the hive and glue "
            f"connectors are not ported yet (available: fs)")
    raise NotFoundError(
        f"unknown under-database type {udb_type!r} (available: fs)")
