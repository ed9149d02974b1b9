"""The port's catalog (``TableMaster``, the table service, the ``transform``
plan) on its LocalCluster with the job service, against the JAX package.

- JAX's ``tests/test_table.py`` scenarios on the port's cluster:
  ``TestCatalog`` (attach snapshots schema and partitions, a duplicate
  attach raises, detach, sync converges both ways, the catalog replays
  after a master restart), ``TestTransform`` (compaction and the
  journaled re-point on the monitor heartbeat, a transform that survives
  a restart and still commits, also through ``LocalCluster.restart_master``
  after the job service published its port) and ``TestAuth`` (mutations
  need the superuser, reads stay open). JAX's ``TestShell`` waits for the
  port's ``shell/``.
- Either package's ``TableMasterClient`` drives the other's table service
  to the same answers and errors.
- A journal holding every table entry type (attach, add and remove table,
  detach, add and remove transform info), written by either package's
  ``TableMaster`` (with and without a checkpoint), replays in the other to
  the writer's ``snapshot()``.
- The port's under-database factory refuses ``hive`` and ``glue`` with
  ``NotSupportedError``.
"""

import importlib
import io
import os
import time

import msgpack
import numpy as np
import pytest

pytest.importorskip("pyarrow")
pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu_torch.conf import Keys  # noqa: E402
from alluxio_tpu_torch.minicluster import LocalCluster  # noqa: E402
from alluxio_tpu_torch.rpc.table_service import TableMasterClient  # noqa: E402
from alluxio_tpu_torch.utils.exceptions import (  # noqa: E402
    AlreadyExistsError, NotFoundError, NotSupportedError,
    PermissionDeniedError,
)

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
USER_KEY = "atpu-user"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster_conf():
    return {Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms",
            Keys.TABLE_TRANSFORM_MONITOR_INTERVAL: "100ms"}


@pytest.fixture()
def cluster(tmp_path):
    with LocalCluster(str(tmp_path), num_workers=1,
                      start_job_service=True,
                      start_worker_heartbeats=True,
                      conf_overrides=_cluster_conf()) as c:
        yield c


def _parquet_bytes(rows: int, seed: int = 0) -> bytes:
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    t = pa.table({
        "id": rng.integers(0, 1 << 30, size=rows, dtype=np.int64),
        "qty": rng.integers(0, 100, size=rows, dtype=np.int32),
        "name": [f"n{i}" for i in range(rows)],
    })
    sink = io.BytesIO()
    pq.write_table(t, sink)
    return sink.getvalue()


def _write_warehouse(fs, root="/warehouse", tables=("sales",),
                     parts=(2019, 2020), files_per_part=3,
                     rows=50) -> None:
    for tbl in tables:
        for year in parts:
            for f in range(files_per_part):
                fs.write_all(
                    f"{root}/{tbl}/year={year}/part-{f:03d}.parquet",
                    _parquet_bytes(rows, seed=year * 10 + f))


def _wait_persisted(fs, root="/warehouse", timeout_s=30.0) -> None:
    deadline = time.monotonic() + timeout_s
    pending = [i.path for i in fs.list_status(root, recursive=True)
               if not i.folder]
    while pending:
        pending = [p for p in pending if not fs.get_status(p).persisted]
        if pending:
            assert time.monotonic() < deadline, f"never persisted: {pending}"
            time.sleep(0.05)


def _restart(cluster, tmp_path):
    """JAX's restart: stop the master, start a new MasterProcess on the
    cluster's conf and journal (here on the same RPC port, so the workers
    and job service the teardown stops still reach it)."""
    from alluxio_tpu_torch.master.process import MasterProcess

    port = cluster.master.rpc_port
    cluster.master.stop()
    conf = cluster.conf.copy()
    conf.set(Keys.MASTER_RPC_PORT, port)
    m2 = MasterProcess(conf, root_ufs_uri=str(tmp_path / "underFSStorage"))
    m2.start()
    cluster.master = m2  # teardown stops the replacement
    return m2


def _wait_applied(tc, job_id, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        st = tc.transform_status(job_id)
        if st.get("applied"):
            return st
        assert st["status"] not in ("FAILED", "CANCELED"), st
        assert time.monotonic() < deadline, f"transform stuck: {st}"
        time.sleep(0.05)


class TestCatalog:
    def test_attach_snapshots_schema_and_partitions(self, cluster):
        fs = cluster.file_system()
        _write_warehouse(fs, tables=("sales", "returns"))
        tc = TableMasterClient(cluster.master.address)
        db = tc.attach_database("fs", "/warehouse")
        assert db == "warehouse"
        assert tc.get_all_databases() == ["warehouse"]
        assert tc.get_all_tables("warehouse") == ["returns", "sales"]
        t = tc.get_table("warehouse", "sales")
        assert {c["name"] for c in t["schema"]} == {"id", "qty", "name"}
        assert t["partition_keys"] == ["year"]
        assert {p["spec"] for p in t["partitions"]} == \
            {"year=2019", "year=2020"}

    def test_attach_duplicate_raises(self, cluster):
        _write_warehouse(cluster.file_system())
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        with pytest.raises(AlreadyExistsError):
            tc.attach_database("fs", "/warehouse")

    def test_detach(self, cluster):
        _write_warehouse(cluster.file_system())
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        tc.detach_database("warehouse")
        assert tc.get_all_databases() == []
        with pytest.raises(NotFoundError):
            tc.get_all_tables("warehouse")

    def test_sync_adds_and_removes_tables(self, cluster):
        fs = cluster.file_system()
        _write_warehouse(fs, tables=("sales",))
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        assert tc.get_all_tables("warehouse") == ["sales"]
        _write_warehouse(fs, tables=("inventory",))
        _wait_persisted(fs)
        fs.delete("/warehouse/sales", recursive=True)
        assert tc.sync_database("warehouse") == 1
        assert tc.get_all_tables("warehouse") == ["inventory"]

    def test_catalog_replays_after_master_restart(self, cluster, tmp_path):
        _write_warehouse(cluster.file_system())
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        before = tc.get_table("warehouse", "sales")
        m2 = _restart(cluster, tmp_path)
        tc2 = TableMasterClient(m2.address)
        assert tc2.get_all_databases() == ["warehouse"]
        after = tc2.get_table("warehouse", "sales")
        assert after["schema"] == before["schema"]
        assert {p["spec"] for p in after["partitions"]} == \
            {p["spec"] for p in before["partitions"]}

    def test_unported_under_database_types_are_refused(self, cluster):
        tc = TableMasterClient(cluster.master.address)
        for udb_type in ("hive", "glue"):
            with pytest.raises(NotSupportedError, match="not ported"):
                tc.attach_database(udb_type, "thrift://localhost:9083")
        with pytest.raises(NotFoundError, match="unknown under-database"):
            tc.attach_database("nope", "/warehouse")
        assert tc.get_all_databases() == []


class TestTransform:
    def test_transform_compacts_and_repoints(self, cluster):
        from alluxio_tpu_torch.table.reader import read_partition_columns

        fs = cluster.file_system()
        _write_warehouse(fs, files_per_part=3, rows=40)
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        before = read_partition_columns(
            fs, tc.get_table("warehouse", "sales"))
        job_id = tc.transform_table("warehouse", "sales")
        _wait_applied(tc, job_id)
        t = tc.get_table("warehouse", "sales")
        for p in t["partitions"]:
            assert "_transformed" in p["location"], p
            files = [i for i in fs.list_status(p["location"])
                     if i.name.endswith(".parquet")]
            assert len(files) == 1
        after = read_partition_columns(fs, t)
        assert after.num_rows == before.num_rows
        assert after.sort_by("id").equals(before.sort_by("id"))

    def test_transform_survives_restart_and_still_commits(self, cluster,
                                                          tmp_path):
        _write_warehouse(cluster.file_system(), files_per_part=2, rows=20)
        tc = TableMasterClient(cluster.master.address)
        tc.attach_database("fs", "/warehouse")
        job_id = tc.transform_table("warehouse", "sales")
        cluster.job_client().wait_for_job(job_id, timeout_s=180.0)
        m2 = _restart(cluster, tmp_path)
        _wait_applied(TableMasterClient(m2.address), job_id, 180.0)

    def test_transform_after_restart_master_reaches_the_job_master(
            self, cluster):
        """``LocalCluster.restart_master`` copies the conf the job service
        published its bound port into, so the new master's table service
        starts transforms on that job master."""
        _write_warehouse(cluster.file_system(), files_per_part=2, rows=20)
        assert cluster.conf.get_int(Keys.JOB_MASTER_RPC_PORT) == \
            cluster.job_master.rpc_port
        m2 = cluster.restart_master()
        tc = TableMasterClient(m2.address)
        tc.attach_database("fs", "/warehouse")
        job_id = tc.transform_table("warehouse", "sales")
        assert cluster.job_client().get_status(job_id).job_id == job_id
        _wait_applied(tc, job_id)


class TestAuth:
    def test_mutations_require_superuser(self, cluster):
        _write_warehouse(cluster.file_system())
        nobody = TableMasterClient(cluster.master.address,
                                   metadata=((USER_KEY, "mallory"),))
        with pytest.raises(PermissionDeniedError):
            nobody.attach_database("fs", "/warehouse")
        admin = TableMasterClient(cluster.master.address)
        admin.attach_database("fs", "/warehouse")
        assert nobody.get_all_databases() == ["warehouse"]
        with pytest.raises(PermissionDeniedError):
            nobody.detach_database("warehouse")
        with pytest.raises(PermissionDeniedError):
            nobody.sync_database("warehouse")
        with pytest.raises(PermissionDeniedError):
            nobody.transform_table("warehouse", "sales")


# -- either package's client against the other's table service ---------------
def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("error", type(e).__name__)


def _drive(client) -> list:
    """A fixed script of catalog calls; each answer or error type."""
    return [
        _outcome(lambda: client.attach_database("fs", "/warehouse")),
        _outcome(lambda: client.attach_database("fs", "/warehouse")),
        _outcome(client.get_all_databases),
        _outcome(lambda: client.get_all_tables("warehouse")),
        _outcome(lambda: client.get_table("warehouse", "sales")),
        _outcome(lambda: client.get_table("warehouse", "nope")),
        _outcome(lambda: client.sync_database("warehouse")),
        _outcome(lambda: client.transform_status(12345)),
        _outcome(lambda: client.detach_database("warehouse")),
        _outcome(lambda: client.get_all_tables("warehouse")),
    ]


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("alluxio_tpu", "alluxio_tpu_torch"), ("alluxio_tpu_torch", "alluxio_tpu")])
def test_table_client_drives_the_other_packages_service(tmp_path, client_pkg,
                                                        server_pkg):
    results = {}
    for pkg in (server_pkg, client_pkg):
        cluster = _mod(pkg, "minicluster").LocalCluster(
            str(tmp_path / pkg), num_workers=1).start()
        try:
            fs = cluster.file_system()
            _write_warehouse(fs, tables=("sales", "returns"),
                             files_per_part=1, rows=10)
            client = _mod(client_pkg, "rpc.table_service").TableMasterClient(
                cluster.master.address)
            results[pkg] = _drive(client)
            fs.close()
        finally:
            cluster.stop()
    assert results[server_pkg] == results[client_pkg]
    assert results[server_pkg][0] == ("ok", "warehouse")
    assert results[server_pkg][1] == ("error", "AlreadyExistsError")
    assert results[server_pkg][5] == ("error", "NotFoundError")


# -- the journal replays across packages -------------------------------------
class _Info:
    def __init__(self, name: str, folder: bool, length: int = 0) -> None:
        self.name = name
        self.folder = folder
        self.length = length
        self.file_id = hash(name) & 0xFFFF
        self.last_modification_time_ms = 1000


class _Stream:
    def __init__(self, data: bytes) -> None:
        self._d, self._pos = data, 0

    def read(self, n=-1):
        n = len(self._d) - self._pos if n < 0 else n
        out = self._d[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def pread(self, off, n):
        return self._d[off:off + n]

    def seek(self, pos):
        self._pos = pos

    def tell(self):
        return self._pos

    def close(self):
        pass


class _DictFs:
    """A namespace of Parquet files in a dict (directories implied): what
    the ``fs`` under-database and the transform commit read."""

    def __init__(self) -> None:
        self.files = {}

    def _children(self, path: str):
        pre = path.rstrip("/") + "/"
        out = {}
        for p in self.files:
            if p.startswith(pre):
                head, _, rest = p[len(pre):].partition("/")
                out[head] = out.get(head, False) or bool(rest)
        return out

    def list_status(self, path: str):
        return [_Info(n, d, 0 if d else len(self.files[f"{path}/{n}"]))
                for n, d in sorted(self._children(path).items())]

    def exists(self, path: str) -> bool:
        return path in self.files or bool(self._children(path))

    def get_status(self, path: str):
        return _Info(path.rsplit("/", 1)[-1], False, len(self.files[path]))

    def open_file(self, path: str, **kw):
        return _Stream(self.files[path])


class _JobStatus:
    status = "COMPLETED"
    error_message = ""


class _JobClient:
    def __init__(self) -> None:
        self.runs = []

    def run(self, config) -> int:
        self.runs.append(config)
        return 100 + len(self.runs)

    def get_status(self, job_id):
        return _JobStatus()


def _norm(obj):
    return msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False,
                           strict_map_key=False)


def _write_catalog(pkg: str, folder: str, checkpoint: bool) -> dict:
    """Drive one package's TableMaster through every entry type on a
    local journal; returns its snapshot."""
    journal = _mod(pkg, "journal").LocalJournalSystem(folder,
                                                      max_log_size=512)
    fs, jobs = _DictFs(), _JobClient()
    tm = _mod(pkg, "table.master").TableMaster(
        journal, fs_factory=lambda: fs, job_client_factory=lambda: jobs)
    journal.start()
    journal.gain_primacy()
    for tbl, years in (("sales", (2019, 2020)), ("returns", (2020,))):
        for y in years:
            fs.files[f"/wh/{tbl}/year={y}/part-0.parquet"] = \
                _parquet_bytes(5, seed=y)
    fs.files["/other/t1/part-0.parquet"] = _parquet_bytes(3, seed=1)
    tm.attach_database("fs", "/wh")
    tm.attach_database("fs", "/other", db_name="scratch")
    tm.detach_database("scratch")
    del fs.files["/wh/returns/year=2020/part-0.parquet"]
    fs.files["/wh/inventory/part-0.parquet"] = _parquet_bytes(4, seed=9)
    tm.sync_database("wh")
    if checkpoint:
        journal.checkpoint()
    applied = tm.transform_table("wh", "sales")
    fs.files["/wh/sales/_transformed/year=2019/part-00000.parquet"] = \
        _parquet_bytes(10, seed=3)
    tm.heartbeat()  # commits the first transform's layout
    pending = tm.transform_table("wh", "inventory",
                                 options={"num_files": 2})
    assert tm.transform_status(applied)["applied"] is True
    assert "applied" not in tm.transform_status(pending)
    snap = _norm(tm.snapshot())
    journal.stop()
    return snap


def _replay_catalog(pkg: str, folder: str) -> dict:
    journal = _mod(pkg, "journal").LocalJournalSystem(folder)
    tm = _mod(pkg, "table.master").TableMaster(journal)
    journal.start()
    journal.gain_primacy()
    try:
        return _norm(tm.snapshot())
    finally:
        journal.stop()


@pytest.mark.parametrize("checkpoint", (False, True),
                         ids=("segments", "checkpoint"))
@pytest.mark.parametrize("writer,reader", [
    ("alluxio_tpu", "alluxio_tpu_torch"), ("alluxio_tpu_torch", "alluxio_tpu")])
def test_catalog_journal_replays_in_the_other_package(tmp_path, writer,
                                                      reader, checkpoint):
    folder = str(tmp_path / "journal")
    written = _write_catalog(writer, folder, checkpoint)
    if checkpoint:  # the checkpoint took the segments before it
        assert os.listdir(os.path.join(folder, "checkpoints"))
    else:
        assert len(os.listdir(os.path.join(folder, "logs"))) > 1  # rotated
    assert sorted(written["dbs"]) == ["wh"]
    assert sorted(written["dbs"]["wh"]["tables"]) == ["inventory", "sales"]
    sales = written["dbs"]["wh"]["tables"]["sales"]
    assert [p["location"] for p in sales["partitions"]] == [
        "/wh/sales/_transformed/year=2019", "/wh/sales/year=2020"]
    assert len(written["transforms"]) == 2
    assert _replay_catalog(reader, folder) == written
    assert _replay_catalog(writer, folder) == written
