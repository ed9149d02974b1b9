"""The port's lock-order auditor and watchdog (``utils/race.py``) against
the JAX package's: each case of ``tests/test_race_detection.py`` runs on
both packages' auditors, which must record the same edges and the same
inversions; then concurrent namespace operations on the port's
``InodeTree`` must leave the audited master locks inversion-free."""

import importlib
import io
import threading
import time

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _race(pkg):
    return importlib.import_module(f"{pkg}.utils.race")


def _observed(aud):
    return sorted(aud.edges), aud.inversions()


# -- the cases of tests/test_race_detection.py, one function a case -----------
def _ab_ba_inversion(race):
    aud = race.LockOrderAuditor()
    a = aud.wrap(threading.Lock(), "A")
    b = aud.wrap(threading.Lock(), "B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert aud.inversions() == [("A", "B")]
    with pytest.raises(AssertionError, match="inversion"):
        aud.assert_clean()
    assert "A held while acquiring B" in aud.report()
    return _observed(aud)


def _consistent_order(race):
    aud = race.LockOrderAuditor()
    a = aud.wrap(threading.Lock(), "A")
    b = aud.wrap(threading.Lock(), "B")
    for _ in range(3):
        with a:
            with b:
                pass
    aud.assert_clean()
    return _observed(aud)


def _blocking_edge_while_stuck(race):
    aud = race.LockOrderAuditor()
    a = aud.wrap(threading.Lock(), "A")
    b_inner = threading.Lock()
    b = aud.wrap(b_inner, "B")
    b_inner.acquire()  # B held elsewhere
    released = threading.Event()
    seen_stuck = []

    def t():
        with a:
            b.acquire()  # blocks until the release below
            b.release()
        released.set()

    th = threading.Thread(target=t, daemon=True)
    th.start()
    deadline = time.monotonic() + 5
    while ("A", "B") not in aud.edges:
        assert time.monotonic() < deadline, "edge never recorded"
        time.sleep(0.02)
    seen_stuck.append(not released.is_set())
    b_inner.release()
    assert released.wait(5)
    th.join(5)
    assert seen_stuck == [True]
    return _observed(aud)


def _failed_trylock(race):
    aud = race.LockOrderAuditor()
    inner_b = threading.Lock()
    a = aud.wrap(threading.Lock(), "A")
    b = aud.wrap(inner_b, "B")
    inner_b.acquire()
    with a:
        assert b.acquire(blocking=False) is False
    inner_b.release()
    with b:
        with a:
            pass
    aud.assert_clean()
    return _observed(aud)


def _timed_backoff(race):
    aud = race.LockOrderAuditor()
    b_inner = threading.Lock()
    a = aud.wrap(threading.Lock(), "A")
    b = aud.wrap(b_inner, "B")
    b_inner.acquire()
    with a:
        assert b.acquire(timeout=0.05) is False
    b_inner.release()
    with b:
        with a:
            pass
    aud.assert_clean()
    return _observed(aud)


def _reentrant(race):
    aud = race.LockOrderAuditor()
    r = aud.wrap(threading.RLock(), "R")
    with r:
        with r:
            pass
    aud.assert_clean()
    return _observed(aud)


def _instrument_attr(race):
    class Holder:
        def __init__(self):
            self._lock = threading.Lock()

    h = Holder()
    aud = race.LockOrderAuditor()
    aud.instrument_attr(h, "_lock", "holder")
    assert isinstance(h._lock, race._LockProxy)
    other = aud.wrap(threading.Lock(), "other")
    with h._lock:
        with other:
            pass
    assert not aud.inversions()
    return _observed(aud)


def _rw_lock_sides(race):
    """Both sides of the package's own RWLock audit as one node."""
    locks = importlib.import_module(
        race.__name__.rsplit(".", 1)[0] + ".locks")
    aud = race.LockOrderAuditor()
    rw = aud.wrap(locks.RWLock(), "RW")
    m = aud.wrap(threading.Lock(), "M")
    with rw.read_locked():
        with m:
            pass
    with m:
        with rw.write_locked():
            pass
    assert aud.inversions() == [("M", "RW")]
    return _observed(aud)


def _watchdog_fires(race):
    buf = io.StringIO()
    with pytest.raises(TimeoutError, match="watchdog"):
        with race.Watchdog(0.2, stream=buf):
            time.sleep(0.6)
    assert "thread dump" in buf.getvalue()
    return ("fired", "thread dump" in buf.getvalue())


def _watchdog_quiet(race):
    wd = race.Watchdog(5.0)
    with wd:
        pass
    return ("quiet", wd.fired)


CASES = {
    "ab_ba_inversion": _ab_ba_inversion,
    "consistent_order": _consistent_order,
    "blocking_edge_while_stuck": _blocking_edge_while_stuck,
    "failed_trylock": _failed_trylock,
    "timed_backoff": _timed_backoff,
    "reentrant": _reentrant,
    "instrument_attr": _instrument_attr,
    "rw_lock_sides": _rw_lock_sides,
    "watchdog_fires": _watchdog_fires,
    "watchdog_quiet": _watchdog_quiet,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_auditors_record_the_same_edges_and_inversions(case):
    got = {pkg: CASES[case](_race(pkg)) for pkg in PACKAGES}
    assert got["alluxio_tpu_torch"] == got["alluxio_tpu"]


def test_concurrent_namespace_ops_have_no_inversions(tmp_path):
    """The port's real master lock stack under a concurrent
    create/list/rename/delete workload (as JAX's
    ``TestInodeTreeLockOrder``): the inode-tree lock, the block master's
    lock and everything the port's plugin audits are taken in one global
    order."""
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.utils.race import LockOrderAuditor, Watchdog

    with LocalCluster(str(tmp_path), num_workers=1) as cluster:
        aud = LockOrderAuditor()
        fm = cluster.master.fs_master
        aud.instrument_attr(fm.inode_tree, "lock", "inode_tree")
        aud.instrument_attr(cluster.master.block_master, "_lock",
                            "block_master")
        fs = cluster.file_system()
        errors = []

        def worker(n):
            try:
                for i in range(8):
                    fs.write_all(f"/race/{n}/f{i}", b"x" * 64)
                fs.list_status("/race", recursive=True)
                for i in range(4):
                    fs.rename(f"/race/{n}/f{i}", f"/race/{n}/g{i}")
                for i in range(4):
                    fs.delete(f"/race/{n}/g{i}")
                    fs.delete(f"/race/{n}/f{i + 4}")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        with Watchdog(120):
            threads = [threading.Thread(target=worker, args=(n,))
                       for n in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert not errors, errors
        aud.assert_clean()
