"""The worker, job and UFS surface of the port against the JAX package's.

- ``BlockWorker.read_ufs_block`` over ``InProcessBlockMasterClient`` (a
  master and one worker wired in process, as ``tests/test_worker.py``
  wires JAX's): the cold read returns the UFS bytes, leaves the block in
  the tiered store, and the next heartbeat gives the master its one
  location; the same in both packages.
- ``TaskExecutorManager.pause``/``resume``, directly and through the job
  worker's ``set_throttle`` command: a paused pool starts no task until
  it is resumed, in both packages.
- ``UfsManager.set_ufs_mode``/``get_ufs_mode``: READ_WRITE by default,
  and every mode round-trips, in both packages.
"""

import importlib
import threading
import time

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

KB = 1024
PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _FsMasterClient:
    def __init__(self, fsm):
        self._fsm = fsm

    def get_pinned_file_ids(self):
        return self._fsm.get_pinned_file_ids()


def _worker_cluster(pkg: str, base):
    conf_mod = _mod(pkg, "conf")
    conf = conf_mod.Configuration(load_env=False)
    keys = conf_mod.Keys
    conf.set(keys.HOME, str(base))
    conf.set(keys.WORKER_DATA_FOLDER, str(base / "worker"))
    conf.set(keys.WORKER_SHM_DIR, str(base / "shm"))
    conf.set(keys.WORKER_RAMDISK_SIZE, 16 * KB)
    journal = _mod(pkg, "journal").NoopJournalSystem()
    master = _mod(pkg, "master")
    bm = master.BlockMaster(journal)
    fsm = master.FileSystemMaster(bm, journal, default_block_size=KB)
    fsm.start(str(base / "root_ufs"))
    sync = _mod(pkg, "worker.master_sync")
    worker = _mod(pkg, "worker").BlockWorker(
        conf, sync.InProcessBlockMasterClient(bm), _FsMasterClient(fsm),
        ufs_manager=fsm.ufs_manager)
    worker._master_sync.register_with_master()
    return bm, fsm, worker


def test_read_ufs_block_caches_like_jax(tmp_path):
    """``tests/test_worker.py::test_ufs_read_through_caches`` on both
    packages."""
    seen = []
    for pkg in PACKAGES:
        base = tmp_path / pkg
        base.mkdir()
        bm, fsm, worker = _worker_cluster(pkg, base)
        try:
            ufs_dir = base / "ext"
            ufs_dir.mkdir()
            payload = bytes(range(256)) * 4
            (ufs_dir / "obj").write_bytes(payload)
            fsm.mount("/ext", str(ufs_dir))
            st = fsm.get_status("/ext/obj")
            bid = st.block_ids[0]
            uri = _mod(pkg, "utils.uri").AlluxioURI("/ext/obj")
            mount_id = fsm.mount_table.resolve(uri).mount_id
            desc = _mod(pkg, "worker").UfsBlockDescriptor(
                block_id=bid, ufs_path=str(ufs_dir / "obj"), offset=0,
                length=len(payload), mount_id=mount_id)
            data = worker.read_ufs_block(desc, cache=True)
            with worker.open_reader(bid) as r:
                warm = r.read(0, len(payload))
            before = len(bm.get_block_info(bid).locations)
            worker._master_sync.heartbeat()
            after = len(bm.get_block_info(bid).locations)
            seen.append((bytes(data) == payload, bytes(warm) == payload,
                         worker.store.has_block(bid), before, after))
        finally:
            worker.async_cache.close()
    assert seen[1] == seen[0] == (True, True, True, 0, 1)


def _gate_check(ex) -> tuple:
    """(started while paused, started after resume)."""
    ran = threading.Event()
    fut = ex.submit(ran.set)
    time.sleep(0.3)
    paused = (ran.is_set(), ex.num_active)
    ex.resume()
    fut.result(timeout=10)
    return paused, ran.is_set()


def test_paused_executor_runs_nothing_until_resumed():
    got = []
    for pkg in PACKAGES:
        ex = _mod(pkg, "job.worker").TaskExecutorManager(2)
        try:
            ex.pause()
            got.append(_gate_check(ex))
        finally:
            ex.shutdown()
    assert got[1] == got[0] == ((False, 0), True)


class _JobMaster:
    def register_worker(self, hostname):
        return 7

    def heartbeat(self, worker_id, health, updates):
        return []


def test_set_throttle_command_pauses_and_resumes_the_pool():
    got = []
    for pkg in PACKAGES:
        jw = _mod(pkg, "job.worker")
        wire = _mod(pkg, "job.wire")
        worker = jw.JobWorker(_JobMaster(), None, "host")
        try:
            worker._handle(wire.JobCommand(kind="set_throttle",
                                           task_args="pause"))
            ran = threading.Event()
            fut = worker._executor.submit(ran.set)
            time.sleep(0.3)
            paused = ran.is_set()
            worker._handle(wire.JobCommand(kind="set_throttle",
                                           task_args="resume"))
            fut.result(timeout=10)
            got.append((paused, ran.is_set()))
        finally:
            worker.stop()
    assert got[1] == got[0] == (False, True)


def test_ufs_modes_round_trip_with_read_write_default():
    got = []
    for pkg in PACKAGES:
        base = _mod(pkg, "underfs.base")
        mgr = _mod(pkg, "underfs.registry").UfsManager()
        try:
            seq = [mgr.get_ufs_mode("/ufs/a").name]
            for mode in base.UfsMode:
                mgr.set_ufs_mode("/ufs/a", mode)
                seq.append((mode.name, mgr.get_ufs_mode("/ufs/a").name,
                            mgr.get_ufs_mode("/ufs/b").name))
            got.append(seq)
        finally:
            mgr.close()
    assert got[1] == got[0]
    assert got[0][0] == "READ_WRITE"
    assert all(mode == back and other == "READ_WRITE"
               for mode, back, other in got[0][1:])
