"""The port's cluster end to end, against the JAX package's, on the CPU
(modelled on ``tests/test_local_cluster.py``).

- ``write_all`` and ``read_all`` round trips over each ``WriteType`` on
  the port's ``LocalCluster`` (master and one worker over gRPC and the
  fast path), with the ``FileInfo``s equal to the JAX cluster's for the
  same script (times, ids of the worker and its port set aside);
- the worker's commits reach the block master; a master restart on the
  same journal serves the same files, block ids and bytes once the worker
  re-registers;
- ``DeviceBlockLoader(fs, ..., device="cpu")`` over the cluster gives the
  bytes that were written;
- cross-wire: the JAX ``FileSystem`` against the port's master and worker,
  and the port's ``FileSystem`` against the JAX ``LocalCluster``; in both
  the bytes read back and the ``FileInfo``s equal what the cluster's own
  client sees.
- no job-service thread outlives ``stop()`` of a cluster that ran the
  job service;
- at their defaults both masters answer the metrics history and health
  RPCs alike.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu_torch.client.streams import WriteType  # noqa: E402
from alluxio_tpu_torch.conf import Keys  # noqa: E402
from alluxio_tpu_torch.minicluster import LocalCluster  # noqa: E402

KB = 1024
BLOCK = 64 * KB
WRITE_TYPES = (WriteType.MUST_CACHE, WriteType.CACHE_THROUGH,
               WriteType.THROUGH, WriteType.ASYNC_THROUGH)


def _jax_cluster(base: str):
    from alluxio_tpu.minicluster import LocalCluster as JaxCluster

    return JaxCluster(base, num_workers=1, block_size=BLOCK,
                      worker_mem_bytes=4 * 1024 * KB)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    port = LocalCluster(str(tmp_path_factory.mktemp("port")), num_workers=1,
                        block_size=BLOCK, worker_mem_bytes=4 * 1024 * KB)
    jax = _jax_cluster(str(tmp_path_factory.mktemp("jax")))
    with port, jax:
        fss = {"port": port.file_system(), "jax": jax.file_system()}
        yield {"port": (port, fss["port"]), "jax": (jax, fss["jax"])}
        for fs in fss.values():
            fs.close()


def _norm(info, base: str) -> dict:
    """A FileInfo wire dict with what differs between two clusters by
    construction set aside: wall-clock times, the cluster directory, and
    the serving worker's id and address."""
    d = info.to_wire() if hasattr(info, "to_wire") else dict(info)
    for k in ("creation_time_ms", "last_modification_time_ms",
              "last_access_time_ms"):
        d[k] = 0
    d["ufs_path"] = d["ufs_path"].replace(base, "<BASE>")
    for fbi in d["file_block_infos"]:
        fbi["block_info"]["locations"] = [
            loc["tier_alias"] for loc in fbi["block_info"]["locations"]]
        fbi["ufs_locations"] = [u.replace(base, "<BASE>")
                                for u in fbi["ufs_locations"]]
    return d


def _payload(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("wt", WRITE_TYPES)
def test_write_read_roundtrip_matches_jax(clusters, wt):
    """The same write through each package's own cluster: the bytes come
    back, and both masters report the same file."""
    arr = _payload(WRITE_TYPES.index(wt), 50_000)  # 200000 B: 4 blocks
    infos = {}
    for name, (cluster, fs) in clusters.items():
        path = f"/rt/{wt}"
        fs.write_all(path, arr if name == "port" else arr.tobytes(),
                     write_type=wt)
        assert fs.read_all(path) == arr.tobytes()
        cluster.workers[0].worker._master_sync.heartbeat()  # THROUGH: FREE
        cluster.workers[0].worker._master_sync.heartbeat()  # its report
        infos[name] = _norm(fs.get_status(path), cluster.conf.get(Keys.HOME))
        infos[name].pop("file_id")  # container ids follow the test order
        infos[name]["block_ids"] = len(infos[name]["block_ids"])
        for fbi in infos[name]["file_block_infos"]:
            fbi["block_info"]["block_id"] = 0
    port = infos["port"]
    assert port == infos["jax"]
    assert port["length"] == arr.nbytes and port["completed"]
    assert port["persisted"] == (wt in (WriteType.CACHE_THROUGH,
                                        WriteType.THROUGH))
    assert port["in_memory_percentage"] == (0 if wt == WriteType.THROUGH
                                            else 100)


def test_listing_and_typed_errors_match_jax(clusters):
    out = {}
    for name, (cluster, fs) in clusters.items():
        fs.create_directory("/ls/a/b", recursive=True)
        for i in range(7):
            fs.write_all(f"/ls/a/f{i}", bytes([i]) * (i * 1000 + 1),
                         write_type=WriteType.MUST_CACHE)
        fs.rename("/ls/a/f6", "/ls/a/b/g")
        fs.delete("/ls/a/f5")
        errors = []
        for call in (lambda: fs.get_status("/ls/none"),
                     lambda: fs.create_file("/ls/a/f0"),
                     lambda: fs.delete("/ls/a"),
                     lambda: fs.create_directory("/ls/a/f0/x")):
            with pytest.raises(Exception) as e:
                call()
            errors.append(type(e.value).__name__)
        base = cluster.conf.get(Keys.HOME)
        out[name] = ([i.path for i in fs.list_status("/ls", recursive=True)],
                     [(_norm(i, base)["length"], i.name)
                      for i in fs.list_status("/ls/a")], errors)
    assert out["port"] == out["jax"]


def test_worker_commits_reach_the_block_master(clusters):
    cluster, fs = clusters["port"]
    fs.write_all("/commit", _payload(9, 40_000),
                 write_type=WriteType.MUST_CACHE)
    st = fs.get_status("/commit")
    infos = fs.block_master.get_block_infos(st.block_ids)
    worker = cluster.workers[0]
    assert [len(b.locations) for b in infos] == [1] * len(st.block_ids)
    assert {b.locations[0].worker_id for b in infos} == \
        {worker.worker.worker_id}
    assert sum(b.length for b in infos) == 160_000
    assert all(worker.worker.store.has_block(b) for b in st.block_ids)


def test_device_loader_reads_the_written_bytes(clusters):
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    cluster, fs = clusters["port"]
    arrays = {f"/dl/shard-{i}": _payload(20 + i, 3 * BLOCK // 4)
              for i in range(3)}
    for path, arr in arrays.items():
        fs.write_all(path, arr, write_type=WriteType.MUST_CACHE)
    loader = DeviceBlockLoader(fs, list(arrays), device="cpu", prefetch=2,
                               dtype=np.int32)
    try:
        got = {}
        for (path, index), block in zip(loader.plan, loader.epoch()):
            got.setdefault(path, []).append(block.cpu().numpy())
        for path, arr in arrays.items():
            assert np.array_equal(np.concatenate(got[path]), arr)
    finally:
        loader.close()


def test_master_restart_on_the_same_journal(tmp_path):
    with LocalCluster(str(tmp_path), num_workers=1, block_size=BLOCK,
                      worker_mem_bytes=4 * 1024 * KB) as c:
        fs = c.file_system()
        files = {f"/r/f{i}": _payload(40 + i, 30_000) for i in range(4)}
        for path, arr in files.items():
            fs.write_all(path, arr, write_type=WriteType.MUST_CACHE)
        fs.create_directory("/r/empty")
        before = {p: fs.get_status(p) for p in files}
        fs.close()
        c.restart_master()
        c.workers[0].worker.heartbeat()  # the new master asks: REGISTER
        fs = c.file_system()
        try:
            for path, arr in files.items():
                st = fs.get_status(path)
                assert (st.block_ids, st.length, st.file_id) == (
                    before[path].block_ids, before[path].length,
                    before[path].file_id)
                assert st.in_memory_percentage == 100
                assert fs.read_all(path) == arr.tobytes()
            assert fs.get_status("/r/empty").folder
        finally:
            fs.close()


# -- cross-wire ---------------------------------------------------------------
def _jax_fs(address: str, fastpath_dir: str):
    from alluxio_tpu.client.file_system import FileSystem as JaxFileSystem
    from alluxio_tpu.conf import Configuration as JaxConfiguration
    from alluxio_tpu.conf import Keys as JaxKeys

    conf = JaxConfiguration(load_env=False)
    conf.set(JaxKeys.MASTER_FASTPATH_DIR, fastpath_dir)
    return JaxFileSystem(address, conf=conf)


def _port_fs(address: str, fastpath_dir: str):
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Configuration

    conf = Configuration(load_env=False)
    conf.set(Keys.MASTER_FASTPATH_DIR, fastpath_dir)
    return FileSystem(address, conf=conf)


@pytest.mark.parametrize("wt", (WriteType.MUST_CACHE,
                                WriteType.CACHE_THROUGH))
@pytest.mark.parametrize("side", ("jax-client-port-cluster",
                                  "port-client-jax-cluster"))
def test_cross_wire(clusters, side, wt):
    """A client of one package against the other package's master and
    worker: what it writes, the cluster's own client reads, and the
    other way round; both clients see the same ``FileInfo``s."""
    name = "port" if side.startswith("jax-client") else "jax"
    cluster, own = clusters[name]
    fastpath_dir = cluster.conf.get(Keys.MASTER_FASTPATH_DIR)
    foreign = (_jax_fs if name == "port" else _port_fs)(
        cluster.master.address, fastpath_dir)
    try:
        a, b = _payload(60, 70_000), _payload(61, 5_000)
        foreign.write_all(f"/xw/{side}/{wt}/a", a.tobytes(), write_type=wt)
        own.write_all(f"/xw/{side}/{wt}/b", b.tobytes(), write_type=wt)
        for path, arr in ((f"/xw/{side}/{wt}/a", a),
                          (f"/xw/{side}/{wt}/b", b)):
            assert foreign.read_all(path) == arr.tobytes()
            assert own.read_all(path) == arr.tobytes()
            with foreign.open_file(path) as f:
                assert f.pread(1000, 64) == arr.tobytes()[1000:1064]
            assert foreign.get_status(path).to_wire() == \
                own.get_status(path).to_wire()
        assert [i.to_wire() for i in foreign.list_status(f"/xw/{side}/{wt}")] \
            == [i.to_wire() for i in own.list_status(f"/xw/{side}/{wt}")]
        # both clients reached the master over its same-host fast path
        assert foreign.fs_master._channels[0]._fast is not None
    finally:
        foreign.close()


def test_meta_rpcs_answer_like_jax_at_the_defaults(clusters):
    """At their defaults both masters keep the metrics history and run
    the health rules: ``get_health`` names the same rules with the same
    status, ``get_metrics_history`` and a metrics heartbeat answer alike.
    The meta RPCs whose component the port has not ported (the quorum
    view, backups) answer as the JAX ones do without that component."""
    from alluxio_tpu_torch.utils.exceptions import FailedPreconditionError

    answers = {}
    for name, (cluster, _) in clusters.items():
        meta = cluster.meta_client()
        beat = meta.metrics_heartbeat("client-x", {"Client.X": 1.0})
        health = meta.get_health()
        history = meta.get_metrics_history("Client.X")
        answers[name] = {
            "heartbeat": beat,
            "qos": meta.get_qos()["admission"],
            "health": (sorted(health), health["status"],
                       [r["name"] for r in health["rules"]]),
            "history": (sorted(history), [
                (e["source"], e["name"], len(e["points"]))
                for e in history["series"]]),
        }
    assert answers["port"] == answers["jax"]
    assert answers["port"]["history"][1] == [("client-x", "Client.X", 1)]
    cluster, fs = clusters["port"]
    meta = cluster.meta_client()
    for call in (meta.get_quorum_info, meta.get_masters, meta.backup):
        with pytest.raises(FailedPreconditionError):
            call()
    info = meta.get_master_info()
    assert info["role"] == "PRIMARY" and not info["safe_mode"]
    assert meta.get_config_hash() == meta.get_configuration()["hash"]
    assert meta.get_config_report()["status"] == "PASSED"
    meta.checkpoint()
    assert os.listdir(os.path.join(cluster.conf.get(Keys.HOME), "journal",
                                   "checkpoints"))


# -- the job service's threads ------------------------------------------------
JOB_THREADS = ("job-task", "job-master-rpc", "JobWorker.CommandHandling",
               "JobMaster.LostWorkerDetection", "Master.ReplicationCheck",
               "Master.PersistenceScheduler")


def test_no_job_service_thread_outlives_stop(tmp_path):
    """``LocalCluster(start_job_service=True).stop()`` joins the job
    workers' pools and heartbeats, the job master's heartbeat and RPC
    handlers, and the master's two checkers. (This module's other
    clusters run no job service; threads alive before are set aside.)"""
    import threading
    import time

    before = set(threading.enumerate())
    cluster = LocalCluster(str(tmp_path), num_workers=2,
                           start_job_service=True,
                           start_worker_heartbeats=True).start()
    fs = cluster.file_system()
    fs.write_all("/t", b"t" * 4096, write_type=WriteType.ASYNC_THROUGH)
    deadline = time.monotonic() + 30.0
    while not fs.get_status("/t").persisted:
        assert time.monotonic() < deadline, "/t never persisted"
        time.sleep(0.05)
    running = {t.name for t in threading.enumerate()}
    assert {"JobWorker.CommandHandling", "JobMaster.LostWorkerDetection",
            "Master.ReplicationCheck",
            "Master.PersistenceScheduler"} <= running
    assert any(n.startswith("job-task") for n in running)
    fs.close()
    cluster.stop()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name.startswith(JOB_THREADS)]
    assert left == []
