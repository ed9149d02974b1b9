"""The port's embedded (Raft) journal against the JAX package's, on the
CPU.

- On disk: the same records make a byte-equal ``RaftLog`` (``log.bin``
  of ``<II`` length+crc32 frames of msgpack records, ``meta.bin``) in
  both packages, through appends, a conflict truncation and a prefix
  truncation, and each package opens the other's log to the same
  records.
- In process: a three-node group of each package, given the same
  proposals, applies the same state on every member; so it does after a
  snapshot install to a lagging follower, a leadership transfer, a
  partition made with the ``link_blocked`` fault, and a leader kill (no
  acknowledged entry lost). The fsync fault latches a LOCAL journal
  broken in both packages, and replay sees only the acknowledged entry.
- Mixed quorum: two port nodes and one JAX node (the RPC planes are the
  same) elect a leader and replicate to all three.

Timeouts are the JAX Raft tests' (150-300 ms elections, 30 ms
heartbeats); every wait polls under a deadline.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_ha import (  # noqa: E402
    PACKAGES, free_ports, leader_of, make_member, make_quorum, mod, put,
    stop_all, wait_for, with_stable_leader,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    for pkg in PACKAGES:
        mod(pkg, "utils.faults").injector().reset()


def _records(pkg: str, seed: int):
    raft = mod(pkg, "journal.raft")
    fmt = mod(pkg, "journal.format")
    rng = np.random.default_rng(seed)
    out, seq = [], 0
    for index in range(1, 13):
        batch = []
        for _ in range(int(rng.integers(1, 4))):
            seq += 1
            batch.append(fmt.JournalEntry(seq, "kv_put", {
                "k": f"k{int(rng.integers(0, 50))}",
                "v": int(rng.integers(-2**31, 2**31)),
                "blob": bytes(rng.integers(0, 256, 8, dtype=np.uint8))}))
        out.append(raft.RaftRecord(1 + index // 5, index, batch))
    return out


def _write_log(pkg: str, folder: str, seed: int) -> None:
    raft = mod(pkg, "journal.raft")
    log = raft.RaftLog(folder)
    log.open()
    log.term, log.voted_for = 3, "127.0.0.1:1"
    log.save_meta()
    recs = _records(pkg, seed)
    for rec in recs[:10]:
        log.append(rec)
    log.truncate_from(8)          # a follower's conflict truncation
    for rec in recs[7:]:
        log.append(rec)
    log.truncate_prefix(3)        # a snapshot covers 1..3
    log.close()


@pytest.mark.parametrize("seed", (0, 1))
def test_raft_log_is_byte_equal_and_each_opens_the_others(tmp_path, seed):
    for pkg in PACKAGES:
        _write_log(pkg, str(tmp_path / pkg), seed)
    for name in ("log.bin", "meta.bin"):
        assert (tmp_path / PACKAGES[0] / name).read_bytes() == \
            (tmp_path / PACKAGES[1] / name).read_bytes()
    seen = []
    for reader, writer in ((PACKAGES[1], PACKAGES[0]),
                           (PACKAGES[0], PACKAGES[1])):
        log = mod(reader, "journal.raft").RaftLog(str(tmp_path / writer))
        log.open()
        seen.append((log.term, log.voted_for, log.start_index,
                     [r.to_wire() for r in log.records]))
        log.close()
    assert seen[0] == seen[1]
    term, voted, start, wire = seen[0]
    assert (term, voted, start) == (3, "127.0.0.1:1", 4)
    assert [w[1] for w in wire] == list(range(4, 13))


def _group(pkg, tmp_path, **kw):
    systems, kvs = make_quorum(pkg, tmp_path / pkg, free_ports(3), **kw)
    for j in systems:
        j.start()
    wait_for(lambda: leader_of(systems) is not None, msg=f"{pkg} election")
    return systems, kvs


def _leader(systems):
    wait_for(lambda: leader_of(systems) is not None, msg="a leader")
    return leader_of(systems)


def _converged(kvs, want: dict):
    for kv in kvs:
        wait_for(lambda kv=kv: kv.data == want, msg="convergence")
    return [dict(kv.data) for kv in kvs]


def _proposals(n: int, prefix: str = "k"):
    return [(f"{prefix}{i}", i * 7 - 3) for i in range(n)]


def test_group_replicates_the_same_state(tmp_path):
    states = {}
    for pkg in PACKAGES:
        systems, kvs = _group(pkg, tmp_path)
        try:
            for k, v in _proposals(20):
                with_stable_leader(systems,
                                   lambda ld, k=k, v=v: put(ld, k, v))
            states[pkg] = _converged(kvs, dict(_proposals(20)))
        finally:
            stop_all(systems)
    assert states[PACKAGES[0]] == states[PACKAGES[1]]


def _restart(pkg, tmp_path, systems, kvs, i, ports, **kw):
    j, kv = make_member(pkg, str(tmp_path / pkg / f"m{i}"), ports[i],
                        ports, **kw)
    systems[i], kvs[i] = j, kv
    j.start()
    return kv


def test_snapshot_install_applies_the_same_state(tmp_path):
    """A follower down while the leader snapshots and truncates its log
    rejoins through ``install_snapshot`` in both packages."""
    states = {}
    for pkg in PACKAGES:
        ports = free_ports(3)
        systems, kvs = make_quorum(pkg, tmp_path / pkg, ports,
                                   snapshot_period_entries=10)
        try:
            for j in systems:
                j.start()
            wait_for(lambda: leader_of(systems) is not None,
                     msg="election")
            leader = leader_of(systems)
            li = next(i for i, j in enumerate(systems)
                      if not j.node.is_leader())
            systems[li].stop()
            up = [j for i, j in enumerate(systems) if i != li]
            for k, v in _proposals(40, "s"):
                with_stable_leader(up, lambda ld, k=k, v=v: put(ld, k, v))
            leader = leader_of(up) or leader
            leader.checkpoint()
            assert leader.node.log.start_index > 1
            kv2 = _restart(pkg, tmp_path, systems, kvs, li, ports,
                           snapshot_period_entries=10)
            wait_for(lambda: len(kv2.data) >= 40, timeout=45,
                     msg="snapshot install")
            states[pkg] = _converged(kvs, dict(_proposals(40, "s")))
        finally:
            stop_all(systems)
    assert states[PACKAGES[0]] == states[PACKAGES[1]]


def test_leadership_transfer_applies_the_same_state(tmp_path):
    states = {}
    for pkg in PACKAGES:
        systems, kvs = _group(pkg, tmp_path)
        try:
            for k, v in _proposals(5, "pre"):
                with_stable_leader(systems,
                                   lambda ld, k=k, v=v: put(ld, k, v))
            leader = _leader(systems)
            target = next(iter(leader.node.peers))
            assert leader.transfer_leadership(target) is True
            wait_for(lambda: leader_of(systems) is not None
                     and leader_of(systems) is not leader,
                     msg="new leader")
            assert leader_of(systems).node.node_id == target
            assert not leader.node.is_leader()
            with_stable_leader(systems, lambda ld: put(ld, "post", 99))
            want = {**dict(_proposals(5, "pre")), "post": 99}
            states[pkg] = _converged(kvs, want)
        finally:
            stop_all(systems)
    assert states[PACKAGES[0]] == states[PACKAGES[1]]


def test_partition_fences_the_leader_alike(tmp_path):
    """``link_blocked`` cuts the leader off: its write fails typed, a
    survivor is elected and writes, and after the heal the old leader
    follows and catches up, in both packages."""
    states = {}
    for pkg in PACKAGES:
        faults = mod(pkg, "utils.faults")
        closed = mod(pkg, "utils.exceptions").JournalClosedError
        systems, kvs = _group(pkg, tmp_path)
        try:
            leader = leader_of(systems)
            put(leader, "a", 1)
            faults.injector().set(partitioned=[leader.node.node_id])
            # the fenced leader's write waits for a quorum it cannot
            # reach; it must fail typed once the leader learns the new
            # term (never an acknowledgement)
            outcome = []

            def fenced_write():
                try:
                    put(leader, "b", 2)
                    outcome.append("acknowledged")
                except closed:
                    outcome.append("refused")

            t = threading.Thread(target=fenced_write, daemon=True)
            t.start()
            wait_for(lambda: any(j is not leader and j.node.leader_ready()
                                 for j in systems), msg="new leader")
            survivor = next(j for j in systems
                            if j is not leader and j.node.leader_ready())
            put(survivor, "c", 3)
            assert faults.injector().injected["partition_drop"] > 0
            faults.injector().set(partitioned=[])
            wait_for(lambda: not leader.node.is_leader(),
                     msg="old leader steps down")
            t.join(timeout=35)
            assert outcome == ["refused"]
            wait_for(lambda: leader.sequence == survivor.sequence,
                     msg="old leader catches up")
            # "b" was never acknowledged: the new term truncated it away
            states[pkg] = _converged(kvs, {"a": 1, "c": 3})
        finally:
            faults.injector().reset()
            stop_all(systems)
    assert states[PACKAGES[0]] == states[PACKAGES[1]]


def test_leader_kill_keeps_every_acknowledged_entry(tmp_path):
    states = {}
    for pkg in PACKAGES:
        systems, kvs = _group(pkg, tmp_path)
        try:
            for k, v in _proposals(15, "a"):
                with_stable_leader(systems,
                                   lambda ld, k=k, v=v: put(ld, k, v))
            leader = _leader(systems)
            leader.stop()
            rest = [j for j in systems if j is not leader]
            wait_for(lambda: leader_of(rest) is not None, timeout=45,
                     msg="re-election")
            with_stable_leader(rest, lambda ld: put(ld, "after", 1))
            want = {**dict(_proposals(15, "a")), "after": 1}
            states[pkg] = _converged(
                [kvs[systems.index(j)] for j in rest], want)
        finally:
            stop_all(systems)
    assert states[PACKAGES[0]] == states[PACKAGES[1]]


class _Recorder:
    journal_name = "Recorder"

    def __init__(self):
        self.values = []

    def process_entry(self, e):
        if e.type == "inode_file":
            self.values.append(e.payload.get("v"))
            return True
        return False

    def snapshot(self):
        return {"values": list(self.values)}

    def restore(self, snap):
        self.values = list(snap.get("values", []))

    def reset_state(self):
        self.values = []


def _open_local(pkg, folder):
    j = mod(pkg, "journal.system").LocalJournalSystem(folder)
    rec = _Recorder()
    j.register(rec)
    j.start()
    j.gain_primacy()
    return j, rec


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fsync_fault_latches_the_journal_broken(tmp_path, pkg):
    """``take_fsync_error`` at the ``_fsync`` choke point: the write
    fails (never acknowledged, then lost), the journal stays broken, and
    replay after a restart holds only the acknowledged entry."""
    faults = mod(pkg, "utils.faults")
    closed = mod(pkg, "utils.exceptions").JournalClosedError
    folder = str(tmp_path / "j")
    j, _ = _open_local(pkg, folder)
    j.start_group_commit(0.0)
    with j.create_context() as ctx:
        ctx.append("inode_file", {"v": 1})
    try:
        faults.injector().set(fsync_errors=1)
        for v in (2, 3):
            with pytest.raises(closed):
                with j.create_context() as ctx:
                    ctx.append("inode_file", {"v": v})
        assert faults.injector().injected["fsync_error"] == 1
    finally:
        faults.injector().reset()
    j.stop()
    j2, rec2 = _open_local(pkg, folder)
    try:
        assert 1 in rec2.values and 3 not in rec2.values
    finally:
        j2.stop()


def test_mixed_quorum_elects_and_replicates(tmp_path):
    """Two port members and one JAX member: the Raft RPCs are the same
    method paths and msgpack bodies, so the group elects a leader and
    every member applies the same entries."""
    ports = free_ports(3)
    pkgs = (PACKAGES[1], PACKAGES[1], PACKAGES[0])
    systems, kvs = [], []
    for i, (pkg, p) in enumerate(zip(pkgs, ports)):
        j, kv = make_member(pkg, str(tmp_path / f"m{i}"), p, ports)
        systems.append(j)
        kvs.append(kv)
    try:
        for j in systems:
            j.start()
        wait_for(lambda: leader_of(systems) is not None, msg="election")
        for k, v in _proposals(12, "x"):
            with_stable_leader(systems, lambda ld, k=k, v=v: put(ld, k, v))
        states = _converged(kvs, dict(_proposals(12, "x")))
        assert states[0] == states[1] == states[2]
        info = with_stable_leader(systems, lambda ld: ld.quorum_info())
        assert len(info["members"]) == 3
    finally:
        stop_all(systems)


def _lone_member_container_ids(pkg, tmp_path):
    """Container ids from a lone EMBEDDED member's block master, then the
    next id after the member restarts and replays its log as leader."""
    raft = mod(pkg, "journal.raft")
    bm_mod = mod(pkg, "master.block_master")
    port = free_ports(1)[0]
    folder = str(tmp_path / pkg)

    def member():
        j = raft.EmbeddedJournalSystem(
            folder, address=f"127.0.0.1:{port}",
            addresses=f"127.0.0.1:{port}",
            election_timeout_ms=(150, 300), heartbeat_interval_ms=30)
        return j, bm_mod.BlockMaster(j)

    j, bm = member()
    j.start()
    wait_for(j.node.leader_ready, msg="first election")
    issued = [bm.new_container_id() for _ in range(3)]
    seq = j.sequence
    j.stop()
    j, bm = member()
    try:
        j.standby_start()
        wait_for(lambda: j.node.leader_ready() and j.sequence >= seq,
                 msg="replay as leader")
        return issued, bm.container_ids.peek
    finally:
        j.stop()


def test_restarted_lone_member_resumes_container_ids(tmp_path):
    """A lone EMBEDDED member restarts, wins its election and replays its
    log as the leader: the JAX block master takes the replayed
    reservation for its own live apply and restarts its generator at 1,
    so it would reissue container ids its inodes hold (a master's next
    create then loops in the path walk); the port's resumes above the
    reserved mark (ROADMAP section 3, open in the reference, fixed in
    the port)."""
    jax_issued, jax_next = _lone_member_container_ids(PACKAGES[0], tmp_path)
    port_issued, port_next = _lone_member_container_ids(PACKAGES[1],
                                                        tmp_path)
    assert jax_issued == port_issued == [1, 2, 3]
    assert jax_next <= max(jax_issued)       # the reference reissues
    assert port_next > max(port_issued)
