"""TableMaster: the journaled catalog + transform orchestration (a copy of
``alluxio_tpu/table/master.py``).

Re-design of ``table/server/master/src/main/java/alluxio/master/table/
{DefaultTableMaster,AlluxioCatalog}.java:55`` and
``transform/TransformManager.java:82``: ``attach_database`` snapshots an
under-database's tables/partitions into journaled state (so the catalog
survives failover and serves reads without touching the UDB);
``sync_database`` refreshes the snapshot; transforms run as job-service
plans and, on completion, a journaled layout update repoints partitions
at the transformed data — exactly the reference's commit protocol
(journal entry, not in-place mutation).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from alluxio_tpu_torch.journal.format import EntryType, JournalEntry, Journaled
from alluxio_tpu_torch.table.udb import UdbTable, udb_factory
from alluxio_tpu_torch.utils.exceptions import (
    AlreadyExistsError, NotFoundError,
)


class TableMaster(Journaled):
    journal_name = "TableMaster"

    def __init__(self, journal, fs_factory=None, job_client_factory=None
                 ) -> None:
        """``fs_factory() -> FileSystem`` supplies the data-plane client
        used for UDB enumeration + schema reads; ``job_client_factory()``
        a job master client for transforms. Both lazy: the table master
        journals fine without either (replay/standby)."""
        self._journal = journal
        self._fs_factory = fs_factory
        self._job_factory = job_client_factory
        self._fs = None
        #: db -> {"type","connection","tables":{name: wire}}
        self._dbs: Dict[str, Dict[str, Any]] = {}
        #: job_id -> transform info wire
        self._transforms: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        # held across check+journal on mutations so two concurrent
        # attaches of the same db can't both pass the existence check
        # (same discipline as PathProperties._mutate_lock)
        self._mutate_lock = threading.Lock()
        journal.register(self)

    # -- helpers -------------------------------------------------------------
    def _file_system(self):
        if self._fs is None:
            if self._fs_factory is None:
                raise NotFoundError(
                    "table master has no data-plane client configured")
            self._fs = self._fs_factory()
        return self._fs

    # -- API: databases ------------------------------------------------------
    def attach_database(self, udb_type: str, connection: str,
                        db_name: str = "",
                        options: Optional[Dict[str, str]] = None) -> str:
        udb = udb_factory(udb_type, self._file_system(), connection,
                          db_name, options)
        name = udb.database_name()
        with self._mutate_lock:
            with self._lock:
                if name in self._dbs:
                    raise AlreadyExistsError(f"database {name} is attached")
            tables = [udb.get_table(t) for t in udb.table_names()]
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.ATTACH_DB, {
                    "db": name, "type": udb_type, "connection": connection,
                    "options": dict(options or {})})
                for t in tables:
                    ctx.append(EntryType.ADD_TABLE,
                               {"db": name, "table": t.to_wire()})
        return name

    def detach_database(self, db_name: str) -> None:
        with self._mutate_lock:
            with self._lock:
                if db_name not in self._dbs:
                    raise NotFoundError(
                        f"database {db_name} is not attached")
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.DETACH_DB, {"db": db_name})

    def sync_database(self, db_name: str) -> int:
        """Re-snapshot the UDB; returns the table count. Tables dropped
        from the UDB are journaled as removals so the catalog converges
        (reference: AlluxioCatalog sync removes stale tables too)."""
        with self._mutate_lock:
            with self._lock:
                db = self._dbs.get(db_name)
                if db is None:
                    raise NotFoundError(
                        f"database {db_name} is not attached")
                udb_type, connection = db["type"], db["connection"]
                options = db.get("options") or {}
                known = set(db["tables"])
            udb = udb_factory(udb_type, self._file_system(), connection,
                              db_name, options)
            tables = [udb.get_table(t) for t in udb.table_names()]
            dropped = known - {t.name for t in tables}
            with self._journal.create_context() as ctx:
                for t in tables:
                    ctx.append(EntryType.ADD_TABLE,
                               {"db": db_name, "table": t.to_wire()})
                for name in sorted(dropped):
                    ctx.append(EntryType.REMOVE_TABLE,
                               {"db": db_name, "table_name": name})
        return len(tables)

    def list_databases(self) -> List[str]:
        with self._lock:
            return sorted(self._dbs)

    def list_tables(self, db_name: str) -> List[str]:
        with self._lock:
            db = self._dbs.get(db_name)
            if db is None:
                raise NotFoundError(f"database {db_name} is not attached")
            return sorted(db["tables"])

    def get_table(self, db_name: str, table_name: str) -> Dict[str, Any]:
        with self._lock:
            db = self._dbs.get(db_name)
            if db is None:
                raise NotFoundError(f"database {db_name} is not attached")
            t = db["tables"].get(table_name)
            if t is None:
                raise NotFoundError(
                    f"table {db_name}.{table_name} does not exist")
            return dict(t)

    # -- API: transforms -----------------------------------------------------
    def transform_table(self, db_name: str, table_name: str, *,
                        definition: str = "compact",
                        options: Optional[Dict[str, Any]] = None) -> int:
        """Kick a transform job; journaled so a failover master keeps
        monitoring it (reference: TransformManager.java:82 'journaled
        before the job starts')."""
        table = self.get_table(db_name, table_name)
        if self._job_factory is None:
            raise NotFoundError("no job service configured for transforms")
        out_root = f"{table['location']}/_transformed"
        config = {"type": "transform", "db": db_name, "table": table_name,
                  "table_wire": table, "definition": definition,
                  "output_root": out_root, **(options or {})}
        job_id = self._job_factory().run(config)
        with self._journal.create_context() as ctx:
            ctx.append(EntryType.ADD_TRANSFORM_JOB_INFO, {
                "job_id": job_id, "db": db_name, "table": table_name,
                "definition": definition, "output_root": out_root})
        return job_id

    def transform_status(self, job_id: int) -> Dict[str, Any]:
        """Read-only status report. Layout commit happens on the master's
        transform-monitor heartbeat (``heartbeat()``), matching the
        reference's TransformManager.java:82 — a client polling status
        must not be the thing that commits."""
        with self._lock:
            info = self._transforms.get(job_id)
            if info is not None:
                info = dict(info)
        if info is None:
            raise NotFoundError(f"no transform with job id {job_id}")
        if info.get("applied"):
            return {**info, "status": "COMPLETED", "error": ""}
        if self._job_factory is None:
            return {**info, "status": "UNKNOWN",
                    "error": "no job service configured"}
        status = self._job_factory().get_status(job_id)
        return {**info, "status": status.status,
                "error": status.error_message}

    def heartbeat(self) -> None:
        """Transform-monitor tick: poll running transform jobs; commit the
        layout of completed ones (reference: TransformManager.java:82 —
        the manager monitors via heartbeat, journaling the commit)."""
        if self._job_factory is None:
            return
        with self._lock:
            pending = [dict(v) for v in self._transforms.values()
                       if not v.get("applied")]
        for info in pending:
            try:
                status = self._job_factory().get_status(info["job_id"])
            except Exception:  # noqa: BLE001 job master unreachable: retry
                continue
            if status.status == "COMPLETED":
                self._apply_transform(info, status)

    def _apply_transform(self, info: Dict[str, Any], status: dict) -> None:
        """Commit the transformed layout: journaled partition re-point.
        Idempotent — _mutate_lock + an applied re-check make concurrent
        heartbeat ticks / failover replays commit exactly once."""
        with self._mutate_lock:
            with self._lock:
                live = self._transforms.get(info["job_id"])
                if live is None or live.get("applied"):
                    return
            table = self.get_table(info["db"], info["table"])
            new_parts = []
            for part in table["partitions"]:
                spec = part["spec"]
                new_loc = f"{info['output_root']}/{spec}" if spec \
                    else info["output_root"]
                fs = self._file_system()
                if fs.exists(new_loc):
                    new_parts.append({**part, "location": new_loc})
                else:  # transform produced nothing for this partition
                    new_parts.append(part)
            table["partitions"] = new_parts
            with self._journal.create_context() as ctx:
                ctx.append(EntryType.ADD_TABLE,
                           {"db": info["db"], "table": table})
                ctx.append(EntryType.REMOVE_TRANSFORM_JOB_INFO,
                           {"job_id": info["job_id"], "applied": True})

    # -- journal contract ----------------------------------------------------
    def process_entry(self, entry: JournalEntry) -> bool:
        t, p = entry.type, entry.payload
        if t == EntryType.ATTACH_DB:
            with self._lock:
                self._dbs[p["db"]] = {"type": p["type"],
                                      "connection": p["connection"],
                                      "options": dict(p.get("options", {})),
                                      "tables": {}}
            return True
        if t == EntryType.DETACH_DB:
            with self._lock:
                self._dbs.pop(p["db"], None)
            return True
        if t == EntryType.ADD_TABLE:
            with self._lock:
                db = self._dbs.get(p["db"])
                if db is not None:
                    db["tables"][p["table"]["name"]] = p["table"]
            return True
        if t == EntryType.REMOVE_TABLE:
            with self._lock:
                db = self._dbs.get(p["db"])
                if db is not None:
                    db["tables"].pop(p["table_name"], None)
            return True
        if t == EntryType.ADD_TRANSFORM_JOB_INFO:
            with self._lock:
                self._transforms[p["job_id"]] = dict(p)
            return True
        if t == EntryType.REMOVE_TRANSFORM_JOB_INFO:
            with self._lock:
                info = self._transforms.get(p["job_id"])
                if info is not None:
                    info["applied"] = bool(p.get("applied"))
            return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"dbs": {n: {"type": d["type"],
                                "connection": d["connection"],
                                "tables": dict(d["tables"])}
                            for n, d in self._dbs.items()},
                    "transforms": {str(k): dict(v)
                                   for k, v in self._transforms.items()}}

    def restore(self, snap: dict) -> None:
        with self._lock:
            self._dbs = {n: {"type": d["type"],
                             "connection": d["connection"],
                             "tables": dict(d["tables"])}
                         for n, d in snap.get("dbs", {}).items()}
            self._transforms = {int(k): dict(v) for k, v in
                                snap.get("transforms", {}).items()}

    def reset_state(self) -> None:
        with self._lock:
            self._dbs.clear()
            self._transforms.clear()
