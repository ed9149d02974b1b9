"""The port's active sync against the JAX package's, on the CPU.

- A sync point's lifecycle through the file-system client's RPCs
  (``start_sync``, ``get_sync_path_list``, ``stop_sync``; an unknown
  point refused with ``InvalidArgumentError``), and its tick: a file an
  outside writer drops into the UFS under the point appears in the
  namespace after one ``ActiveSyncManager.heartbeat``, and a file deleted
  there leaves it. Both packages' ``LocalCluster`` run the same script
  and observe the same listings.
- Sync points survive a master restart on the same journal.
- A journal that holds ``add_sync_point``/``remove_sync_point`` entries,
  with and without a checkpoint in the middle, written by one package's
  ``LocalJournalSystem``, replays in the other package's into the same
  sync points and component snapshots, in both directions.
- The port's master ticks the manager on its own heartbeat
  (``atpu.master.activesync.interval``).
"""

import importlib
import os
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_master import Masters  # noqa: E402

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster(pkg: str, base: str, **kw):
    return _mod(pkg, "minicluster.local_cluster").LocalCluster(
        base, **kw)


def _ufs_root(c) -> str:
    return c.fs_client().get_mount_points()[0].ufs_uri


def _names(c, path: str) -> list:
    return sorted((i.name, i.length) for i in
                  c.master.fs_master.list_status(path))


def test_sync_point_lifecycle_and_tick(tmp_path):
    got = {}
    for pkg in PACKAGES:
        errors = _mod(pkg, "utils.exceptions")
        with _cluster(pkg, str(tmp_path / pkg), num_workers=1) as c:
            assert type(c.master.active_sync).__module__ == \
                f"{pkg}.master.sync"
            fs = c.file_system()
            fs.create_directory("/watch")
            fsc = c.fs_client()
            obs = [fsc.get_sync_path_list()]
            fsc.start_sync("/watch")
            fsc.start_sync("/watch")  # a second start is a no-op
            obs.append(fsc.get_sync_path_list())
            d = os.path.join(_ufs_root(c), "watch")
            os.makedirs(d, exist_ok=True)
            for name, data in (("new.txt", b"appeared"),
                               ("two.bin", bytes(range(200)))):
                with open(os.path.join(d, name), "wb") as f:
                    f.write(data)
            c.master.active_sync.heartbeat()
            obs.append(_names(c, "/watch"))
            obs.append(fs.read_all("/watch/new.txt"))
            os.remove(os.path.join(d, "two.bin"))
            c.master.active_sync.heartbeat()
            obs.append(_names(c, "/watch"))
            obs.append(sorted(c.master.active_sync.last_runs))
            fsc.stop_sync("/watch")
            obs.append(fsc.get_sync_path_list())
            with pytest.raises(errors.InvalidArgumentError):
                fsc.stop_sync("/not-registered")
            with pytest.raises(errors.FileDoesNotExistError):
                fsc.start_sync("/missing")
            got[pkg] = obs
    assert got[PORT] == got[JAX]
    assert got[PORT] == [
        [], ["/watch"], [("new.txt", 8), ("two.bin", 200)], b"appeared",
        [("new.txt", 8)], ["/watch"], []]


def test_sync_points_survive_a_restart(tmp_path):
    for pkg in PACKAGES:
        base = str(tmp_path / pkg)
        with _cluster(pkg, base, num_workers=0) as c:
            for path in ("/sp", "/sq", "/sr"):
                c.file_system().create_directory(path)
                c.master.active_sync.add_sync_point(path)
            c.master.active_sync.remove_sync_point("/sq")
        # same base directory, same journal folder: replay restores them
        with _cluster(pkg, base, num_workers=0) as c:
            assert c.master.active_sync.sync_points() == ["/sp", "/sr"], pkg


def _write_sync_journal(pkg: str, base: str, checkpoint: bool) -> dict:
    """Sync points added and removed around an optional checkpoint;
    returns the writer's component snapshots."""
    w = Masters(pkg, base, seed=5).start()
    sync = _mod(pkg, "master.sync").ActiveSyncManager(w.fsm, w.journal)
    for i in range(6):
        w.fsm.create_directory(f"/d{i}")
    for i in (0, 1, 2):
        sync.add_sync_point(f"/d{i}")
    sync.remove_sync_point("/d1")
    if checkpoint:
        w.journal.checkpoint()
    for i in (3, 4):
        sync.add_sync_point(f"/d{i}")
    sync.remove_sync_point("/d0")
    written = {"points": sync.sync_points(), "snapshot": sync.snapshot()}
    w.stop()
    return written


def _replay_sync(pkg: str, base: str) -> dict:
    r = Masters(pkg, base, seed=5)
    sync = _mod(pkg, "master.sync").ActiveSyncManager(r.fsm, r.journal)
    r.journal.start()
    r.journal.gain_primacy()
    try:
        return {"points": sync.sync_points(), "snapshot": sync.snapshot()}
    finally:
        r.stop()


@pytest.mark.parametrize("checkpoint", (False, True),
                         ids=("log", "log+checkpoint"))
@pytest.mark.parametrize("writer,reader", ((JAX, PORT), (PORT, JAX)))
def test_sync_point_journal_replays_in_the_other_package(tmp_path, writer,
                                                         reader, checkpoint):
    base = str(tmp_path / "cluster")
    written = _write_sync_journal(writer, base, checkpoint)
    assert written["points"] == ["/d2", "/d3", "/d4"]
    assert bool(os.listdir(os.path.join(base, "journal", "checkpoints"))) \
        == checkpoint
    assert _replay_sync(reader, base) == written == \
        _replay_sync(writer, base)


def test_master_ticks_active_sync(tmp_path):
    got = {}
    for pkg in PACKAGES:
        with _cluster(pkg, str(tmp_path / pkg), num_workers=0,
                      conf_overrides={
                          "atpu.master.activesync.interval": "50ms"}) as c:
            c.file_system().create_directory("/auto")
            c.fs_client().start_sync("/auto")
            d = os.path.join(_ufs_root(c), "auto")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "late.bin"), "wb") as f:
                f.write(b"L" * 77)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and \
                    not _names(c, "/auto"):
                time.sleep(0.02)
            got[pkg] = _names(c, "/auto")
    assert got[PORT] == got[JAX] == [("late.bin", 77)]
