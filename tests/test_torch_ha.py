"""The port's HA building blocks against the JAX package's, on the CPU
(the scenarios of ``tests/test_ha.py``, each on both packages).

- The file-lock primary selector hands primacy over; a standby journal
  tails the primary's segments (``standby_start``, ``catch_up``, the
  ``JournalTailer``) to the same state in both packages, and a standby
  checkpoint covers what it applied.
- ``FaultTolerantMasterProcess``: a lone HA master serves at once; a
  standby promotes when the primary releases the lock, with the
  primary's namespace.
- A backup written by either package's master (the ``backup`` RPC)
  seeds the other package's master through
  ``atpu.master.journal.init.from.backup``; ``init_from_backup`` refuses
  a journal that has state; ``dump_journal`` prints the same text in
  both packages.
- The client rotates off a dead master to a live one.
- The audit writer at ``stop()``: held in its sink with entries queued,
  the JAX writer leaves them unlogged and uncounted; the port's writes
  every one.
"""

import io
import logging
import os
import threading
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_ha import PACKAGES, mod, wait_for  # noqa: E402


def make_conf(pkg, tmp_path, **overrides):
    conf = mod(pkg, "conf")
    Keys = conf.Keys
    c = conf.Configuration(load_env=False)
    c.set(Keys.HOME, str(tmp_path))
    c.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    c.set(Keys.MASTER_RPC_PORT, 0)
    c.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
    c.set(Keys.MASTER_BACKUP_DIR, str(tmp_path / "backups"))
    c.set(Keys.MASTER_STANDBY_TAIL_INTERVAL, "50ms")
    c.set(Keys.MASTER_FASTPATH_ENABLED, False)
    for k, v in overrides.items():
        c.set(k, v)
    return c


class _Recorder:
    """Minimal journaled component for journal-level tests."""

    journal_name = "Recorder"

    def __init__(self) -> None:
        self.values = []

    def process_entry(self, entry) -> bool:
        if entry.type == "inode_file":  # reuse a registered type
            self.values.append(entry.payload.get("v"))
            return True
        return False

    def snapshot(self) -> dict:
        return {"values": list(self.values)}

    def restore(self, snap) -> None:
        self.values = list(snap.get("values", []))

    def reset_state(self) -> None:
        self.values = []


def _local(pkg, folder):
    j = mod(pkg, "journal.system").LocalJournalSystem(folder)
    rec = _Recorder()
    j.register(rec)
    return j, rec


def _append(j, *values):
    with j.create_context() as ctx:
        for v in values:
            ctx.append("inode_file", {"v": v})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_file_lock_selector_hands_primacy_over(tmp_path, pkg):
    ha = mod(pkg, "journal.ha")
    a = ha.FileLockPrimarySelector(str(tmp_path))
    b = ha.FileLockPrimarySelector(str(tmp_path))
    a.start(), b.start()
    assert a.try_acquire() and a.is_primary()
    a.release()
    assert not a.is_primary()
    assert b.try_acquire()
    b.release()
    assert b.wait_for_primacy(timeout_s=1.0)
    b.release()


def _tail_script(pkg, folder):
    primary, _ = _local(pkg, folder)
    primary.start()
    primary.gain_primacy()
    _append(primary, 1)
    standby, rec = _local(pkg, folder)
    standby.standby_start()
    seen = [list(rec.values)]
    _append(primary, 2, 3)
    seen.append(standby.catch_up())
    seen.append(list(rec.values))
    tailer = mod(pkg, "journal.ha").JournalTailer(standby, interval_s=0.05)
    tailer.start()
    _append(primary, 4)
    wait_for(lambda: rec.values[-1] == 4, timeout=10, msg="tailer")
    tailer.stop()
    seen.append(list(rec.values))
    standby.checkpoint_standby()
    seen.append(standby.last_checkpoint_sequence == standby.sequence)
    primary.stop(), standby.stop()
    return seen


def test_standby_tails_the_primary_alike(tmp_path):
    got = [_tail_script(pkg, str(tmp_path / pkg)) for pkg in PACKAGES]
    assert got[0] == got[1] == [[1], 2, [1, 2, 3], [1, 2, 3, 4], True]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_standby_promotes_on_release(tmp_path, pkg):
    process = mod(pkg, "master.process")
    ha = mod(pkg, "journal.ha")
    FsMasterClient = mod(pkg, "rpc.clients").FsMasterClient
    m1 = process.FaultTolerantMasterProcess(make_conf(pkg, tmp_path))
    m1.start()
    assert m1.serving and m1.rpc_port
    FsMasterClient(m1.address).create_directory("/before-failover")

    # in-process flock would succeed (same pid): gate the second master
    # on the first, as the JAX test does
    class _Gate(ha.FileLockPrimarySelector):
        def try_acquire(self_inner) -> bool:  # noqa: N805
            if m1.serving:
                return False
            return super(_Gate, self_inner).try_acquire()

    m2 = process.FaultTolerantMasterProcess(
        make_conf(pkg, tmp_path), selector=_Gate(str(tmp_path / "journal")))
    try:
        m2.start()
        assert not m2.serving and m2.standby_rpc_port
        wait_for(lambda: m2.fs_master.exists("/before-failover"),
                 timeout=15, msg="standby tail")
        m1.stop()  # releases the lock -> m2 promotes
        wait_for(lambda: m2.serving, timeout=15, msg="promotion")
        c2 = FsMasterClient(m2.address)
        assert c2.exists("/before-failover")
        c2.create_directory("/after-failover")
        assert c2.exists("/after-failover")
    finally:
        m2.stop()


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["jax-to-port", "port-to-jax"])
def test_backup_restores_in_the_other_package(tmp_path, writer, reader):
    ufs = tmp_path / "ufs"
    os.makedirs(ufs, exist_ok=True)
    clients = mod(writer, "rpc.clients")
    m = mod(writer, "master.process").MasterProcess(
        make_conf(writer, tmp_path / "a"), root_ufs_uri=str(ufs))
    m.start()
    try:
        fs = clients.FsMasterClient(m.address)
        fs.create_directory("/backed-up/deep", recursive=True)
        fs.create_directory("/backed-up/other")
        resp = clients.MetaMasterClient(m.address).backup()
    finally:
        m.stop()
    assert os.path.exists(resp["backup_uri"])
    Keys = mod(reader, "conf").Keys
    conf = make_conf(reader, tmp_path / "b")
    conf.set(Keys.MASTER_JOURNAL_INIT_FROM_BACKUP, resp["backup_uri"])
    m2 = mod(reader, "master.process").MasterProcess(conf,
                                                     root_ufs_uri=str(ufs))
    m2.start()
    try:
        fs2 = mod(reader, "rpc.clients").FsMasterClient(m2.address)
        assert sorted(i.path for i in fs2.list_status(
            "/backed-up", recursive=True)) == \
            ["/backed-up/deep", "/backed-up/other"]
    finally:
        m2.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_init_from_backup_refuses_a_journal_with_state(tmp_path, pkg):
    j, _ = _local(pkg, str(tmp_path / "j"))
    j.start()
    j.gain_primacy()
    _append(j, 1)
    backup = j.write_backup(str(tmp_path / "bk"))
    j.stop()
    j2, _ = _local(pkg, str(tmp_path / "j"))
    assert j2.init_from_backup(backup) is False


def test_dump_journal_prints_the_same_text(tmp_path):
    texts = []
    for pkg in PACKAGES:
        folder = str(tmp_path / pkg)
        j, _ = _local(pkg, folder)
        j.start()
        j.gain_primacy()
        _append(j, 42)
        j.checkpoint()
        _append(j, 43, "x" * 300)
        j.stop()
        for dumper in PACKAGES:
            out = io.StringIO()
            n = mod(dumper, "journal.tool").dump_journal(folder, out)
            texts.append((n, out.getvalue()))
    assert len(set(texts)) == 1
    n, text = texts[0]
    assert n >= 2 and "checkpoint" in text and "inode_file" in text


@pytest.mark.parametrize("pkg", PACKAGES)
def test_client_rotates_to_a_live_master(tmp_path, pkg):
    os.makedirs(tmp_path / "ufs", exist_ok=True)
    m = mod(pkg, "master.process").MasterProcess(
        make_conf(pkg, tmp_path), root_ufs_uri=str(tmp_path / "ufs"))
    m.start()
    try:
        # nothing listens on port 1: the client must rotate and succeed
        c = mod(pkg, "rpc.clients").FsMasterClient(
            f"localhost:1,{m.address}", retry_duration_s=15.0)
        c.create_directory("/failover-ok")
        assert c.exists("/failover-ok")
    finally:
        m.stop()


class _HeldSink(logging.Handler):
    """Blocks on the first record until released; counts every record."""

    def __init__(self) -> None:
        super().__init__()
        self.held = threading.Event()
        self.gate = threading.Event()
        self.records = 0

    def emit(self, record) -> None:
        if not self.held.is_set():
            self.held.set()
            self.gate.wait(10)
        self.records += 1


@pytest.mark.parametrize("pkg,keeps", [(PACKAGES[0], False),
                                        (PACKAGES[1], True)],
                         ids=["jax", "port"])
def test_audit_writer_stop_keeps_what_it_accepted(pkg, keeps):
    """The sink held on the first entry, N entries queued, ``stop()``
    called, then the sink released: the JAX writer's loop leaves at the
    stop flag with N-1 entries neither logged nor counted; the port's
    writes all N (ROADMAP section 3, open in the reference, fixed in the
    port)."""
    audit = mod(pkg, "security.audit")
    sink = _HeldSink()
    audit.AUDIT_LOG.addHandler(sink)
    old_level, old_prop = audit.AUDIT_LOG.level, audit.AUDIT_LOG.propagate
    audit.AUDIT_LOG.setLevel(logging.INFO)
    audit.AUDIT_LOG.propagate = False
    try:
        w = audit.AsyncAuditLogWriter()
        w.start()
        n = 20
        for i in range(n):
            w.append(audit.AuditContext(f"cmd{i}", src_path=f"/p{i}"))
        assert sink.held.wait(10)
        stopper = threading.Thread(target=w.stop)
        stopper.start()
        wait_for(lambda: w._stopped.is_set(), timeout=10, msg="stop flag")
        sink.gate.set()
        stopper.join(15)
        deadline = time.monotonic() + 10
        while w._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not w._thread.is_alive()
        accounted = sink.records + w.dropped
        if keeps:
            assert sink.records == n and w.dropped == 0
        else:
            assert sink.records == 1 and accounted < n
    finally:
        audit.AUDIT_LOG.removeHandler(sink)
        audit.AUDIT_LOG.setLevel(old_level)
        audit.AUDIT_LOG.propagate = old_prop
