"""Table master RPC surface + client (a copy of
``alluxio_tpu/rpc/table_service.py``: the same service name and method
paths, so either package's client drives the other's table master).

Re-design of ``core/transport/src/main/proto/grpc/table/
table_master.proto`` (AttachDatabase/GetAllDatabases/GetAllTables/
GetTable/SyncDatabase/Transform*) on the msgpack plane.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.rpc.clients import resolve_retry_duration_s
from alluxio_tpu_torch.rpc.core import RpcChannel, ServiceDefinition
from alluxio_tpu_torch.utils.retry import ExponentialTimeBoundedRetry, retry

TABLE_SERVICE = "table_master"


def table_master_service(table_master,
                         permission_checker=None) -> ServiceDefinition:
    """Catalog mutations (attach/detach/sync/transform) are superuser-
    gated, exactly as the meta admin RPCs are (``master_service.py``
    ``check_superuser``): an arbitrary authenticated user must not be able
    to attach UDBs, rewrite data under ``_transformed/``, or detach the
    catalog. Reads stay open."""
    svc = ServiceDefinition(TABLE_SERVICE)

    def _require_admin() -> None:
        if permission_checker is not None:
            from alluxio_tpu_torch.security.user import authenticated_user

            permission_checker.check_superuser(authenticated_user())

    def _attach(r):
        _require_admin()
        return {"db": table_master.attach_database(
            r["udb_type"], r["connection"], r.get("db_name", ""),
            options=r.get("options") or {})}

    def _detach(r):
        _require_admin()
        table_master.detach_database(r["db"])
        return {}

    def _sync(r):
        _require_admin()
        return {"tables": table_master.sync_database(r["db"])}

    def _transform(r):
        _require_admin()
        return {"job_id": table_master.transform_table(
            r["db"], r["table"],
            definition=r.get("definition", "compact"),
            options=r.get("options"))}

    svc.unary("attach_database", _attach)
    svc.unary("detach_database", _detach)
    svc.unary("sync_database", _sync)
    svc.unary("get_all_databases", lambda r: {
        "dbs": table_master.list_databases()})
    svc.unary("get_all_tables", lambda r: {
        "tables": table_master.list_tables(r["db"])})
    svc.unary("get_table", lambda r: {
        "table": table_master.get_table(r["db"], r["table"])})
    svc.unary("transform_table", _transform)
    svc.unary("transform_status", lambda r: {
        "info": table_master.transform_status(r["job_id"])})
    return svc


class TableMasterClient:
    """Typed retrying client (reference: ``table/client/.../
    RetryHandlingTableMasterClient.java``)."""

    service = TABLE_SERVICE

    def __init__(self, address: str, *,
                 retry_duration_s: "Optional[float]" = None,
                 metadata=None, conf=None) -> None:
        """``retry_duration_s`` falls back to ``conf``'s
        ``atpu.user.rpc.retry.duration`` (30s default)."""
        self._channel = RpcChannel(address, metadata=metadata)
        self._retry_duration_s = resolve_retry_duration_s(
            retry_duration_s, conf)

    def _call(self, method: str, request: dict, timeout: float = 60.0):
        return retry(
            lambda: self._channel.call(self.service, method, request,
                                       timeout=timeout),
            ExponentialTimeBoundedRetry(self._retry_duration_s, 0.05, 3.0))

    def attach_database(self, udb_type: str, connection: str,
                        db_name: str = "", options: dict = None) -> str:
        return self._call("attach_database", {
            "udb_type": udb_type, "connection": connection,
            "db_name": db_name, "options": options or {}})["db"]

    def detach_database(self, db: str) -> None:
        self._call("detach_database", {"db": db})

    def sync_database(self, db: str) -> int:
        return self._call("sync_database", {"db": db})["tables"]

    def get_all_databases(self) -> List[str]:
        return self._call("get_all_databases", {})["dbs"]

    def get_all_tables(self, db: str) -> List[str]:
        return self._call("get_all_tables", {"db": db})["tables"]

    def get_table(self, db: str, table: str) -> Dict[str, Any]:
        return self._call("get_table", {"db": db, "table": table})["table"]

    def transform_table(self, db: str, table: str, *,
                        definition: str = "compact",
                        options: Optional[Dict[str, Any]] = None) -> int:
        return self._call("transform_table", {
            "db": db, "table": table, "definition": definition,
            "options": options})["job_id"]

    def transform_status(self, job_id: int) -> Dict[str, Any]:
        return self._call("transform_status", {"job_id": job_id})["info"]
