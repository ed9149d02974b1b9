"""The port's scheduled metadata backup against the JAX package's, on the
CPU (the scenarios of ``tests/test_scheduled_backup.py``, each on both
packages, on one injected clock).

- ``ScheduledBackup``: the first tick backs up at once into an empty
  directory, then once an interval; a restarted heartbeat with backups
  on disk waits an interval; retention keeps the newest; a failing
  backup keeps the heartbeat alive; the same ticks give the same
  outcomes in both packages.
- A backup file is the same checkpoint-format document in both packages
  and restores into an empty journal of either package.
- The master wires the heartbeat when ``atpu.master.daily.backup.enabled``
  is set: one tick on each package's ``LocalCluster`` lands one backup.
"""

import os

import msgpack
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_ha import PACKAGES, mod  # noqa: E402


class _KV:
    journal_name = "kv"

    def __init__(self):
        self.data = {}

    def process_entry(self, e):
        if e.type != "kv_put":
            return False
        self.data[e.payload["k"]] = e.payload["v"]
        return True

    def snapshot(self):
        return dict(self.data)

    def restore(self, s):
        self.data = dict(s)

    def reset_state(self):
        self.data = {}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _journal(pkg, folder):
    j = mod(pkg, "journal.system").LocalJournalSystem(folder)
    kv = _KV()
    j.register(kv)
    j.start()
    j.gain_primacy()
    with j.create_context() as ctx:
        ctx.append("kv_put", {"k": "a", "v": 1})
    return j, kv


def _put(j, k, v):
    with j.create_context() as ctx:
        ctx.append("kv_put", {"k": k, "v": v})


def _schedule(pkg, tmp_path):
    """One tick script: (took a backup?, backups taken, files on disk)
    after each step."""
    backup = mod(pkg, "master.backup")
    j, _ = _journal(pkg, str(tmp_path / pkg / "journal"))
    clock = _Clock()
    bdir = str(tmp_path / pkg / "backups")
    out = []
    try:
        sb = backup.ScheduledBackup(j, bdir, interval_s=100.0,
                                    retention=2, clock=clock)
        for step, dt in enumerate((0, 50, 51, 10, 100, 100)):
            clock.t += dt
            took = sb.heartbeat() is not None
            if took:
                _put(j, f"n{step}", step)  # distinct sequences
            out.append((took, sb.backups_taken, len(os.listdir(bdir))))
        restarted = backup.ScheduledBackup(j, bdir, interval_s=100.0,
                                           clock=clock)
        out.append(restarted.heartbeat() is None)
        clock.t += 101
        out.append(restarted.heartbeat() is not None)
    finally:
        j.stop()
    return out


def test_backup_schedule_ticks_alike(tmp_path):
    got = [_schedule(pkg, tmp_path) for pkg in PACKAGES]
    assert got[0] == got[1]
    assert got[0][:3] == [(True, 1, 1), (False, 1, 1), (True, 2, 2)]
    assert got[0][4:6] == [(True, 3, 2), (True, 4, 2)]  # retention 2
    assert got[0][6:] == [True, True]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failure_keeps_the_heartbeat_alive(tmp_path, pkg):
    class Boom:
        def write_backup(self, d):
            raise OSError("disk full")

    clock = _Clock()
    sb = mod(pkg, "master.backup").ScheduledBackup(
        Boom(), str(tmp_path / "b"), interval_s=1.0, clock=clock)
    assert sb.heartbeat() is None
    assert "disk full" in sb.last_error
    clock.t += 2
    assert sb.heartbeat() is None


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["jax-to-port", "port-to-jax"])
def test_backup_file_restores_in_the_other_package(tmp_path, writer,
                                                   reader):
    j, _ = _journal(writer, str(tmp_path / "w"))
    _put(j, "b", [1, 2, 3])
    path = mod(writer, "master.backup").ScheduledBackup(
        j, str(tmp_path / "backups"), clock=_Clock()).heartbeat()
    j.stop()
    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    assert doc == {"sequence": 2, "components": {"kv": {"a": 1,
                                                       "b": [1, 2, 3]}}}
    j2 = mod(reader, "journal.system").LocalJournalSystem(
        str(tmp_path / "r"))
    kv2 = _KV()
    j2.register(kv2)
    assert j2.init_from_backup(path)
    j2.gain_primacy()
    try:
        assert kv2.data == {"a": 1, "b": [1, 2, 3]}
        assert j2.sequence == 2
    finally:
        j2.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_master_heartbeat_lands_a_backup(tmp_path, pkg):
    Keys = mod(pkg, "conf").Keys
    hb = mod(pkg, "heartbeat.core")
    LocalCluster = mod(pkg, "minicluster.local_cluster").LocalCluster
    bdir = str(tmp_path / "scheduled-backups")
    name = hb.HeartbeatContext.MASTER_DAILY_BACKUP
    hb.HeartbeatThread.use_scheduled_timers(name)
    try:
        with LocalCluster(str(tmp_path / "c"), num_workers=0,
                          conf_overrides={
                              Keys.MASTER_DAILY_BACKUP_ENABLED: True,
                              Keys.MASTER_BACKUP_DIR: bdir,
                              Keys.MASTER_DAILY_BACKUP_INTERVAL: "1h",
                          }) as c:
            c.file_system().create_directory("/backed-up")
            hb.HeartbeatScheduler.execute(name)
            files = os.listdir(bdir)
            assert len(files) == 1 and files[0].endswith(".bak")
            assert c.master.scheduled_backup.backups_taken == 1
    finally:
        hb.HeartbeatThread.reset_timer_policy()
