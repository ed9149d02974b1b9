"""The port's integrity daemons against the JAX package's, on the CPU.

Each case is one of ``tests/test_integrity.py``'s scenarios, run on both
packages' ``LocalCluster`` with the same script: inject the anomaly, tick
the daemon, observe the repair. The observations (persistence states,
counts, which files and blocks remain) must be equal:

- ``LostFileDetector``: a MUST_CACHE file whose only worker is forgotten
  goes LOST and recovers once the worker re-registers; a persisted file
  is never marked; the LOST mark survives a journal replay (and a tick
  without a worker does not recover it); a file LOST while its persist
  was pending recovers to TO_BE_PERSISTED and is queued again.
- ``BlockIntegrityChecker``: an orphan block (no owning inode) is freed,
  and the blocks of a live file are kept.
- ``UfsCleaner``: a stale persist temp goes, a fresh one and a normal
  file stay, and the sweep recurses into directories.

The port's master builds all three and ticks them on their heartbeats
(``test_master_ticks_the_daemons``).
"""

import importlib
import os
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster(pkg: str, base: str, **kw):
    return _mod(pkg, "minicluster.local_cluster").LocalCluster(
        base, num_workers=1, **kw)


def _state(c, path: str) -> str:
    return str(c.master.fs_master.get_status(path).persistence_state)


def _both(tmp_path, scenario, **kw) -> dict:
    """``scenario(pkg, cluster, base)`` on each package's cluster; its
    observations by package, after checking the port's daemons are the
    port's own."""
    got = {}
    for pkg in PACKAGES:
        base = str(tmp_path / pkg)
        with _cluster(pkg, base, **kw) as c:
            for attr in ("lost_file_detector", "block_integrity_checker",
                         "ufs_cleaner"):
                assert type(getattr(c.master, attr)).__module__ == \
                    f"{pkg}.master.integrity"
            got[pkg] = scenario(pkg, c, base)
    assert got[PORT] == got[JAX]
    return got[PORT]


def _forget_worker(c) -> None:
    c.master.block_master.forget_worker(c.workers[0].worker.worker_id)


def _reregister(c) -> None:
    c.workers[0].worker._master_sync.register_with_master()


# -- LostFileDetector ------------------------------------------------------------
def test_mark_lost_and_recover(tmp_path):
    def scenario(pkg, c, base):
        fs = c.file_system()
        fs.write_all("/precious", b"x" * 1000, write_type="MUST_CACHE")
        bm = c.master.block_master
        obs = [_state(c, "/precious")]
        _forget_worker(c)
        obs.append(len(bm.lost_blocks()))
        c.master.lost_file_detector.heartbeat()
        obs.append(_state(c, "/precious"))
        obs.append(sorted(c.master.fs_master.inode_tree.lost_file_ids) ==
                   [fs.get_status("/precious").file_id])
        _reregister(c)
        obs.append(len(bm.lost_blocks()))
        c.master.lost_file_detector.heartbeat()
        obs.append(_state(c, "/precious"))
        obs.append(len(c.master.fs_master.inode_tree.lost_file_ids))
        obs.append(fs.read_all("/precious") == b"x" * 1000)
        return obs

    assert _both(tmp_path, scenario) == [
        "NOT_PERSISTED", 1, "LOST", True, 0, "NOT_PERSISTED", 0, True]


def test_persisted_file_is_never_marked_lost(tmp_path):
    def scenario(pkg, c, base):
        fs = c.file_system()
        fs.write_all("/durable", b"y" * 1000, write_type="CACHE_THROUGH")
        fs.write_all("/cached", b"z" * 1000, write_type="MUST_CACHE")
        _forget_worker(c)
        c.master.lost_file_detector.heartbeat()
        return [_state(c, "/durable"), _state(c, "/cached")]

    assert _both(tmp_path, scenario) == ["PERSISTED", "LOST"]


def test_lost_file_survives_journal_replay(tmp_path):
    def scenario(pkg, c, base):
        fs = c.file_system()
        fs.write_all("/gone", b"z" * 100, write_type="MUST_CACHE")
        _forget_worker(c)
        c.master.lost_file_detector.heartbeat()
        c.master.stop()
        m2 = _mod(pkg, "master.process").MasterProcess(
            c.conf, root_ufs_uri=os.path.join(base, "underFSStorage"))
        m2.start()
        c.master = m2
        obs = [_state(c, "/gone"), len(m2.fs_master.inode_tree.lost_file_ids)]
        # no worker holds the blocks yet: a tick must not recover it
        m2.lost_file_detector.heartbeat()
        obs.append(_state(c, "/gone"))
        return obs

    assert _both(tmp_path, scenario) == ["LOST", 1, "LOST"]


def test_lost_recovery_restores_pending_persist(tmp_path):
    def scenario(pkg, c, base):
        fs = c.file_system()
        fs.write_all("/pending", b"p" * 200, write_type="ASYNC_THROUGH")
        fsm = c.master.fs_master
        obs = [_state(c, "/pending")]
        _forget_worker(c)
        c.master.lost_file_detector.heartbeat()
        obs.append(_state(c, "/pending"))
        fsm.pop_persist_requests()  # drop what was queued before the loss
        _reregister(c)
        c.master.lost_file_detector.heartbeat()
        obs.append(_state(c, "/pending"))
        obs.append([fsm.current_path_of(i)
                    for i in sorted(fsm.pop_persist_requests())])
        return obs

    assert _both(tmp_path, scenario) == [
        "TO_BE_PERSISTED", "LOST", "TO_BE_PERSISTED", ["/pending"]]


# -- BlockIntegrityChecker -------------------------------------------------------
def test_orphan_block_is_freed_and_live_blocks_kept(tmp_path):
    def scenario(pkg, c, base):
        fs = c.file_system()
        fs.write_all("/alive", b"a" * 1000, write_type="MUST_CACHE")
        bm = c.master.block_master
        live = set(bm.all_block_ids())
        orphan = _mod(pkg, "utils.ids").block_id(123456, 0)
        bm.commit_block_in_ufs(orphan, 4096)
        obs = [orphan in bm.all_block_ids(), len(live)]
        c.master.block_integrity_checker.heartbeat()
        obs += [orphan in bm.all_block_ids(),
                set(bm.all_block_ids()) == live,
                fs.read_all("/alive") == b"a" * 1000]
        return obs

    assert _both(tmp_path, scenario) == [True, 1, False, True, True]


# -- UfsCleaner --------------------------------------------------------------------
def test_ufs_cleaner_sweeps_stale_temps_and_keeps_fresh(tmp_path):
    def scenario(pkg, c, base):
        root = os.path.join(base, "underFSStorage")
        nested = os.path.join(root, "a", "b")
        os.makedirs(nested)
        names = {"stale": os.path.join(root, ".atpu_persist.f.deadbeef"),
                 "fresh": os.path.join(root, ".atpu_persist.g.cafecafe"),
                 "tmp": os.path.join(root, ".atpu_tmp_x"),
                 "normal": os.path.join(root, "normal.bin"),
                 "nested": os.path.join(nested, ".atpu_persist.x.00000000")}
        for path in names.values():
            with open(path, "wb") as f:
                f.write(b"tmp")
        old = time.time() - 7200
        for key in ("stale", "tmp", "nested"):
            os.utime(names[key], (old, old))
        removed = [c.master.ufs_cleaner.heartbeat(),
                   c.master.ufs_cleaner.heartbeat()]
        return [removed, {k: os.path.exists(p) for k, p in names.items()}]

    assert _both(tmp_path, scenario) == [[3, 0], {
        "stale": False, "fresh": True, "tmp": False, "normal": True,
        "nested": False}]


# -- the master's heartbeats -------------------------------------------------------
def test_master_ticks_the_daemons(tmp_path):
    """With the detection, integrity and cleanup intervals cut, the
    port's master marks a lost file, frees an orphan block and sweeps a
    stale temp on its own heartbeat threads, as the JAX master does."""
    def scenario(pkg, c, base):
        keys = _mod(pkg, "conf").Keys
        assert c.conf.get_duration_s(
            keys.MASTER_LOST_FILES_DETECTION_INTERVAL) == 0.05
        fs = c.file_system()
        fs.write_all("/f", b"f" * 100, write_type="MUST_CACHE")
        orphan = _mod(pkg, "utils.ids").block_id(654321, 0)
        c.master.block_master.commit_block_in_ufs(orphan, 4096)
        temp = os.path.join(base, "underFSStorage", ".atpu_persist.t.1")
        with open(temp, "wb") as f:
            f.write(b"t")
        old = time.time() - 7200
        os.utime(temp, (old, old))
        _forget_worker(c)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (
                _state(c, "/f") == "LOST" and not os.path.exists(temp) and
                orphan not in c.master.block_master.all_block_ids()):
            time.sleep(0.02)
        return [_state(c, "/f"), os.path.exists(temp),
                orphan in c.master.block_master.all_block_ids()]

    overrides = {"atpu.master.lost.files.detection.interval": "50ms",
                 "atpu.master.block.integrity.check.interval": "50ms",
                 "atpu.master.ufs.cleanup.interval": "50ms"}
    assert _both(tmp_path, scenario, conf_overrides=overrides) == [
        "LOST", False, False]
