"""Disk-backed store on stdlib ``sqlite3`` in the RocksDB role
(metadata larger than RAM, cheap restart), WAL mode: a copy of
``alluxio_tpu/master/metastore/sqlite.py``."""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import msgpack

from alluxio_tpu_torch.master.inode import Inode
from alluxio_tpu_torch.master.metastore.base import InodeStore


class SqliteInodeStore(InodeStore):
    """Disk-backed store in the RocksDB role (metadata > RAM, fast
    restart)."""

    def __init__(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "inodes.db")
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS inodes "
                "(id INTEGER PRIMARY KEY, data BLOB NOT NULL)")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS edges "
                "(parent_id INTEGER NOT NULL, name TEXT NOT NULL, "
                "child_id INTEGER NOT NULL, PRIMARY KEY (parent_id, name))")
            self._conn.commit()

    def get(self, inode_id: int) -> Optional[Inode]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM inodes WHERE id=?", (inode_id,)).fetchone()
        if row is None:
            return None
        return Inode.from_wire_dict(msgpack.unpackb(row[0], raw=False))

    def put(self, inode: Inode) -> None:
        blob = msgpack.packb(inode.to_wire_dict(), use_bin_type=True)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO inodes (id, data) VALUES (?, ?)",
                (inode.id, blob))
            self._conn.commit()

    def remove(self, inode_id: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM inodes WHERE id=?", (inode_id,))
            self._conn.commit()

    def add_child(self, parent_id: int, name: str, child_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO edges (parent_id, name, child_id) "
                "VALUES (?, ?, ?)", (parent_id, name, child_id))
            self._conn.commit()

    def remove_child(self, parent_id: int, name: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM edges WHERE parent_id=? AND name=?",
                (parent_id, name))
            self._conn.commit()

    def get_child_id(self, parent_id: int, name: str) -> Optional[int]:
        with self._lock:
            row = self._conn.execute(
                "SELECT child_id FROM edges WHERE parent_id=? AND name=?",
                (parent_id, name)).fetchone()
        return row[0] if row else None

    def child_names(self, parent_id: int) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT name FROM edges WHERE parent_id=? ORDER BY name",
                (parent_id,)).fetchall()
        return [r[0] for r in rows]

    def iter_edges(self, parent_id: int,
                   start_after: Optional[str] = None) \
            -> Iterator[Tuple[str, int]]:
        # paged SELECTs (resumed by name cursor) instead of one giant
        # fetchall: the connection lock is only held per page
        cursor = start_after
        while True:
            with self._lock:
                if cursor is None:
                    rows = self._conn.execute(
                        "SELECT name, child_id FROM edges WHERE parent_id=? "
                        "ORDER BY name LIMIT 1024", (parent_id,)).fetchall()
                else:
                    rows = self._conn.execute(
                        "SELECT name, child_id FROM edges WHERE parent_id=? "
                        "AND name>? ORDER BY name LIMIT 1024",
                        (parent_id, cursor)).fetchall()
            if not rows:
                return
            for name, child_id in rows:
                yield name, child_id
            cursor = rows[-1][0]

    def has_children(self, parent_id: int) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM edges WHERE parent_id=? LIMIT 1",
                (parent_id,)).fetchone()
        return row is not None

    def child_count(self, parent_id: int) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM edges WHERE parent_id=?",
                (parent_id,)).fetchone()[0]

    def all_ids(self) -> Iterator[int]:
        with self._lock:
            rows = self._conn.execute("SELECT id FROM inodes").fetchall()
        return iter([r[0] for r in rows])

    def clear(self) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM inodes")
            self._conn.execute("DELETE FROM edges")
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def estimated_size(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM inodes").fetchone()[0]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            inodes = self._conn.execute(
                "SELECT COUNT(*) FROM inodes").fetchone()[0]
            edges = self._conn.execute(
                "SELECT COUNT(*) FROM edges").fetchone()[0]
        return {"kind": "SQLITE", "inodes": inodes, "edges": edges}
