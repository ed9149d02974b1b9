"""Embedded replicated journal: Raft consensus over the msgpack-RPC plane
(a copy of ``alluxio_tpu/journal/raft.py``).

Re-design of the reference's embedded journal
(``core/server/common/src/main/java/alluxio/master/journal/raft/
RaftJournalSystem.java:150``, ``JournalStateMachine.java:83``,
``SnapshotReplicationManager.java``, ``RaftPrimarySelector.java``): there
the journal is an Apache Ratis state machine — every metadata mutation is
a Raft log command, leader election IS primary election, and snapshots
ship leader->standby. Here the same contract is implemented directly on
the framework's own transport (``rpc/core.py``) instead of an external
consensus library:

- **Log replication**: each group-commit batch of ``JournalEntry``s is one
  Raft log record. ``write_and_flush`` blocks until the record is
  committed on a quorum AND applied locally, so an acknowledged mutation
  survives any minority of failures — the same durability the reference
  gets from Ratis' ``appendEntries`` round.
- **Election as primacy**: masters boot as followers; the elected leader
  is the primary. ``RaftPrimarySelector`` adapts the node to the
  ``PrimarySelector`` SPI so ``FaultTolerantMasterProcess`` needs no
  special-casing. Terms fence deposed leaders (a stale primary's appends
  are rejected by quorum, its writes raise, and it steps down).
- **Hot standbys**: followers apply committed entries continuously — the
  standby-tailing behavior of ``UfsJournalCheckpointThread`` falls out of
  the consensus protocol itself; promotion is O(election), not O(replay).
- **Snapshot install**: a follower too far behind the leader's truncated
  log receives a full component snapshot (reference:
  ``SnapshotReplicationManager``); nodes also snapshot locally on an
  entry-count period to bound their own logs.

Deployment note: quorum members are metadata masters on the hosts'
VMs; this traffic rides the host network (it is control plane, never the
accelerator interconnect). The log's frames, records and snapshot files
are the JAX package's byte for byte, so each package opens the other's.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import msgpack

from alluxio_tpu_torch.journal.format import JournalEntry
from alluxio_tpu_torch.journal.ha import PrimarySelector
from alluxio_tpu_torch.journal.system import JournalSystem
from alluxio_tpu_torch.utils.exceptions import JournalClosedError

LOG = logging.getLogger(__name__)

RAFT_SERVICE = "raft_journal"
_FRAME = struct.Struct("<II")  # length, crc32

FOLLOWER = "FOLLOWER"
CANDIDATE = "CANDIDATE"
LEADER = "LEADER"


class RaftRecord:
    """One Raft log record = one group-commit batch of journal entries."""

    __slots__ = ("term", "index", "entries")

    def __init__(self, term: int, index: int,
                 entries: List[JournalEntry]) -> None:
        self.term = term
        self.index = index
        self.entries = entries

    def to_wire(self) -> list:
        return [self.term, self.index,
                [[e.sequence, e.type, e.payload] for e in self.entries]]

    @staticmethod
    def from_wire(w: list) -> "RaftRecord":
        return RaftRecord(w[0], w[1],
                          [JournalEntry(s, t, p) for s, t, p in w[2]])


class RaftLog:
    """Durable append-only Raft log + persistent (term, voted_for) meta.

    Records are framed ``[u32 len][u32 crc][msgpack]`` (same torn-tail
    discipline as ``journal/format.py``); byte offsets are tracked so a
    conflict truncation (Raft §5.3) is an ``ftruncate``. The log lives in
    memory too — metadata batches between snapshots are small, and the
    snapshot period bounds growth.
    """

    def __init__(self, folder: str) -> None:
        self._folder = folder
        self._log_path = os.path.join(folder, "log.bin")
        self._meta_path = os.path.join(folder, "meta.bin")
        self.records: List[RaftRecord] = []
        self._offsets: List[int] = []  # byte offset of each record
        self.start_index = 1  # index of records[0] (moves up on truncation)
        self.term = 0
        self.voted_for: Optional[str] = None
        self._file = None
        # logical end-of-file: tracked explicitly because a buffered
        # 'ab' handle's tell() goes stale after ftruncate — offsets
        # derived from it would point past EOF and corrupt later
        # truncations
        self._end = 0

    # -- persistence ---------------------------------------------------------
    def open(self) -> None:
        os.makedirs(self._folder, exist_ok=True)
        if os.path.exists(self._meta_path):
            with open(self._meta_path, "rb") as f:
                meta = msgpack.unpackb(f.read(), raw=False)
            self.term = meta["term"]
            self.voted_for = meta.get("voted_for")
            self.start_index = meta.get("start_index", 1)
        dirty = False
        if os.path.exists(self._log_path):
            off = 0
            from alluxio_tpu_torch.journal.format import iter_frames, map_or_read

            with open(self._log_path, "rb") as f:
                data = map_or_read(f)
                for body_off, length in iter_frames(data):
                    try:
                        rec = RaftRecord.from_wire(msgpack.unpackb(
                            data[body_off:body_off + length], raw=False))
                    except Exception:  # noqa: BLE001 crc-coincident junk
                        break  # treat as torn tail, same as format.py
                    self.records.append(rec)
                    self._offsets.append(body_off - _FRAME.size)
                    off = body_off + length
                if hasattr(data, "close"):
                    data.close()
            # a torn tail MUST be truncated away before appending: 'ab'
            # positions past the garbage, and records written after it
            # would be unreadable on the next restart (scan stops at the
            # torn frame) — silently losing acknowledged entries
            dirty = off != os.path.getsize(self._log_path)
            # drop any pre-start_index remnants (post-snapshot-truncation
            # crash window)
            while self.records and self.records[0].index < self.start_index:
                self.records.pop(0)
                self._offsets.pop(0)
                dirty = True
        if dirty:
            self._rewrite()
        else:
            self._end = off if os.path.exists(self._log_path) else 0
            self._file = open(self._log_path, "ab")

    def save_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb({"term": self.term,
                                   "voted_for": self.voted_for,
                                   "start_index": self.start_index},
                                  use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def _rewrite(self) -> None:
        """Rewrite the whole log file from memory (truncation paths)."""
        if self._file is not None:
            self._file.close()
        tmp = self._log_path + ".tmp"
        with open(tmp, "wb") as f:
            self._offsets = []
            off = 0
            for rec in self.records:
                body = msgpack.packb(rec.to_wire(), use_bin_type=True)
                f.write(_FRAME.pack(len(body), zlib.crc32(body)) + body)
                self._offsets.append(off)
                off += _FRAME.size + len(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path)
        self._end = off
        self._file = open(self._log_path, "ab")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- accessors -----------------------------------------------------------
    @property
    def last_index(self) -> int:
        return self.start_index + len(self.records) - 1 if self.records \
            else self.start_index - 1

    def term_at(self, index: int, *, snapshot_term: int = 0) -> int:
        """Term of the record at ``index``; snapshot_term covers the
        truncated prefix boundary."""
        if index == 0:
            return 0
        i = index - self.start_index
        if i < 0:
            return snapshot_term
        if i >= len(self.records):
            return -1
        return self.records[i].term

    def get(self, index: int) -> Optional[RaftRecord]:
        i = index - self.start_index
        if 0 <= i < len(self.records):
            return self.records[i]
        return None

    def slice_from(self, index: int, limit: int = 64) -> List[RaftRecord]:
        i = max(0, index - self.start_index)
        return self.records[i:i + limit]

    # -- mutation ------------------------------------------------------------
    def append(self, rec: RaftRecord, *, fsync: bool = True) -> None:
        body = msgpack.packb(rec.to_wire(), use_bin_type=True)
        self._offsets.append(self._end)
        self._file.write(_FRAME.pack(len(body), zlib.crc32(body)) + body)
        self._end += _FRAME.size + len(body)
        if fsync:
            self._file.flush()
            os.fsync(self._file.fileno())
        self.records.append(rec)

    def flush(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())

    def truncate_from(self, index: int) -> None:
        """Drop records >= index (follower conflict resolution)."""
        i = index - self.start_index
        if i < 0 or i >= len(self.records):
            if i < 0:
                self.records = []
                self._offsets = []
                self._rewrite()
            return
        off = self._offsets[i]
        self.records = self.records[:i]
        self._offsets = self._offsets[:i]
        self._file.flush()
        self._file.truncate(off)
        os.fsync(self._file.fileno())
        # reopen so the 'ab' handle's position reflects the new EOF
        # (a buffered append handle does not follow ftruncate)
        self._file.close()
        self._file = open(self._log_path, "ab")
        self._end = off

    def truncate_prefix(self, upto_index: int) -> None:
        """Drop records <= upto_index (after a snapshot covers them)."""
        n = upto_index - self.start_index + 1
        if n <= 0:
            return
        self.records = self.records[n:]
        self.start_index = upto_index + 1
        self.save_meta()
        self._rewrite()


class RaftNode:
    """One quorum member: consensus state + election + replication.

    Single coarse lock guards all Raft state; replication fan-out and the
    apply loop run on their own threads and re-take it per step. Commit
    advancement wakes ``commit_cv`` waiters (the write path) and the apply
    thread.
    """

    def __init__(self, node_id: str, peers: Dict[str, str], folder: str, *,
                 election_timeout_ms: Tuple[int, int] = (300, 600),
                 heartbeat_interval_ms: int = 100,
                 apply_fn=None, snapshot_fn=None, restore_fn=None,
                 snapshot_period_entries: int = 100_000) -> None:
        """``peers``: node_id -> address for ALL members (incl. self).
        ``apply_fn(entry)`` applies one committed JournalEntry;
        ``snapshot_fn() -> dict`` / ``restore_fn(dict)`` capture/install
        component state for snapshot truncation + install."""
        self.node_id = node_id
        self.peers = {nid: addr for nid, addr in peers.items()
                      if nid != node_id}
        self.quorum_size = (len(peers) // 2) + 1
        #: deterministic election-timeout stagger by member rank: after a
        #: leader death every survivor's randomized timeout starts from
        #: the same instant, and a scheduler stall (GIL pause, CI noise)
        #: can land two draws inside one RPC round trip — a split vote
        #: that costs a full extra election round.  Offsetting each
        #: member by rank * 15% of the band makes the lowest-ranked
        #: survivor usually campaign first and win clean, while the
        #: random draw still decorrelates equal-rank restarts.
        self._rank = sorted(peers).index(node_id) if node_id in peers else 0
        self.log = RaftLog(os.path.join(folder, "raft", node_id))
        self._folder = folder
        self._apply_fn = apply_fn or (lambda e: None)
        self._snapshot_fn = snapshot_fn or (lambda: {})
        self._restore_fn = restore_fn or (lambda s: None)
        self._snapshot_period = snapshot_period_entries
        #: optional context-manager factory held around each apply-loop
        #: batch (follower replication; leader barrier/orphan records).
        #: A standby that serves reads installs the inode tree's write
        #: lock: the apply loop holds no inode-path locks, so a served
        #: read could otherwise observe a torn multi-step apply.
        #: Acquired BEFORE _state_lock/lock — the same tree-first order
        #: the propose path uses — so no lock cycle forms.  The
        #: propose-wait apply path stays unwrapped: there the proposing
        #: RPC thread already holds the path's write locks (and holds
        #: the tree READ lock, which this write lock must not wait on
        #: from the same thread).
        self.apply_exclusion = None

        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self._transferring = False  # §3.10: no proposals mid-handover
        self.commit_index = 0
        self.applied_index = 0
        self.applied_seq = 0
        self._entries_since_snapshot = 0
        self.snapshot_term = 0  # term at log.start_index - 1
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}

        self.lock = threading.RLock()
        self.commit_cv = threading.Condition(self.lock)
        self.apply_cv = threading.Condition(self.lock)
        # serializes snapshot FILE IO (periodic + admin checkpoint +
        # install) without stalling consensus under self.lock
        self._snap_io_lock = threading.Lock()
        # serializes component-state mutation (apply/restore) against
        # snapshot capture, so _snapshot_fn() — a full serialization of
        # every component — never runs under the consensus lock where it
        # would stall votes/appends past the election timeout.
        # Lock order: _snap_io_lock -> _state_lock -> lock.
        self._state_lock = threading.Lock()
        #: index -> RaftRecord for batches proposed by THIS node's callers.
        #: The proposing thread applies its own batch once committed and
        #: in-order (it holds the owning component's write lock — the same
        #: thread-applies contract as the local journal; the apply loop
        #: handles only non-local records: follower replication, barriers,
        #: and orphans whose proposer gave up).
        self._local_batches: Dict[int, RaftRecord] = {}
        self._election_timeout_ms = election_timeout_ms
        self._heartbeat_ms = heartbeat_interval_ms
        self._deadline = 0.0
        #: when we last accepted a live leader's append (pre-vote gate)
        self._last_leader_contact = time.monotonic()
        self._reset_election_deadline()
        self._stopped = False
        self._threads: List[threading.Thread] = []
        self._peer_wakeups: Dict[str, threading.Event] = {
            nid: threading.Event() for nid in self.peers}
        #: injectable peer transport (tests install drop/partition
        #: shims here; the MultiProcessCluster exercises real
        #: network failures, this seam covers asymmetric partitions)
        self.transport = _peer_call
        #: monotonic stamp of each peer's last successful RPC response —
        #: quorum_info serves it as last_contact_s, and the HA health
        #: sampling counts "live" members from it
        self.peer_contact: Dict[str, float] = {}
        self._step_down_cbs: List = []

    def _call_peer(self, addr: str, method: str, req: dict,
                   timeout: float):
        """Peer RPC via the injectable transport, behind the chaos
        injector's partition gate (outbound-only dropping cuts the link
        both ways — responses ride the same call)."""
        from alluxio_tpu_torch.utils import faults

        if faults.armed() and \
                faults.injector().link_blocked(self.node_id, addr):
            raise ConnectionError(
                f"injected partition {self.node_id} -/- {addr}")
        return self.transport(addr, method, req, timeout=timeout)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.log.open()
        self._load_snapshot()
        # replay the durable log into local state up to... nothing is
        # known-committed yet; entries apply as commit advances (either by
        # winning an election or by hearing a leader's commit index).
        self._stopped = False
        t = threading.Thread(target=self._timer_loop,
                             name=f"raft-timer-{self.node_id}", daemon=True)
        t.start()
        self._threads.append(t)
        a = threading.Thread(target=self._apply_loop,
                             name=f"raft-apply-{self.node_id}", daemon=True)
        a.start()
        self._threads.append(a)
        for nid in self.peers:
            s = threading.Thread(target=self._peer_loop, args=(nid,),
                                 name=f"raft-peer-{self.node_id}-{nid}",
                                 daemon=True)
            s.start()
            self._threads.append(s)

    def stop(self) -> None:
        with self.lock:
            self._stopped = True
            self.commit_cv.notify_all()
            self.apply_cv.notify_all()
        for ev in self._peer_wakeups.values():
            ev.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        self.log.close()

    def on_step_down(self, cb) -> None:
        self._step_down_cbs.append(cb)

    # -- snapshots ------------------------------------------------------------
    def _snap_dir(self) -> str:
        return os.path.join(self._folder, "raft", self.node_id, "snapshots")

    def _latest_snapshot_path(self) -> Optional[str]:
        d = self._snap_dir()
        if not os.path.isdir(d):
            return None
        snaps = [f for f in os.listdir(d) if f.endswith(".snap")]
        if not snaps:
            return None
        return os.path.join(d, max(
            snaps, key=lambda f: int(f.split("_")[1].split(".")[0], 16)))

    def _load_snapshot(self) -> None:
        p = self._latest_snapshot_path()
        if p is None:
            return
        with open(p, "rb") as f:
            snap = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
        self._restore_fn(snap["components"])
        self.snapshot_term = snap["term"]
        self.commit_index = max(self.commit_index, snap["index"])
        self.applied_index = snap["index"]
        self.applied_seq = snap["seq"]
        if self.log.start_index <= snap["index"]:
            self.log.truncate_prefix(snap["index"])

    def take_snapshot(self) -> None:
        """Snapshot local applied state; truncate the covered log prefix.
        File IO happens outside the consensus lock (under _snap_io_lock,
        which also serializes concurrent periodic/admin/install callers)."""
        with self._snap_io_lock:
            with self._state_lock:
                # _state_lock freezes component state (appliers take it
                # before mutating); consensus proceeds under self.lock
                # while the potentially-large serialization runs
                with self.lock:
                    index, seq = self.applied_index, self.applied_seq
                    term = self.log.term_at(
                        index, snapshot_term=self.snapshot_term)
                    if index == 0:
                        return
                comps = self._snapshot_fn()
            d = self._snap_dir()
            os.makedirs(d, exist_ok=True)
            blob = msgpack.packb({"term": term, "index": index, "seq": seq,
                                  "components": comps}, use_bin_type=True)
            self._write_snapshot_file(d, term, index, blob)
            with self.lock:
                self.snapshot_term = term
                self._entries_since_snapshot = 0
                if self.log.start_index <= index:
                    self.log.truncate_prefix(index)
            # GC older snapshots
            keep = self._latest_snapshot_path()
            for f in os.listdir(d):
                if f.endswith(".snap") and os.path.join(d, f) != keep:
                    try:
                        os.remove(os.path.join(d, f))
                    except OSError:
                        pass

    def _write_snapshot_file(self, d: str, term: int, index: int,
                             blob: bytes) -> None:
        """Caller holds _snap_io_lock (unique tmp per thread regardless)."""
        tmp = os.path.join(d, f".tmp.{os.getpid()}.{threading.get_ident()}")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, f"{term:08x}_{index:016x}.snap"))

    # -- elections -----------------------------------------------------------
    def _reset_election_deadline(self) -> None:
        lo, hi = self._election_timeout_ms
        stagger = self._rank * 0.15 * (hi - lo)
        self._deadline = time.monotonic() + \
            (random.uniform(lo, hi) + stagger) / 1000.0

    def _timer_loop(self) -> None:
        while True:
            with self.lock:
                if self._stopped:
                    return
                state = self.state
                expired = time.monotonic() >= self._deadline
            if state == LEADER:
                # heartbeat tick: nudge idle peer senders
                for ev in self._peer_wakeups.values():
                    ev.set()
                time.sleep(self._heartbeat_ms / 1000.0)
            else:
                if expired:
                    from alluxio_tpu_torch.utils import faults

                    if faults.armed() and faults.injector() \
                            .election_frozen(self.node_id):
                        # chaos: sit this one out (still votes) — the
                        # drill decides who may win the next election
                        with self.lock:
                            self._reset_election_deadline()
                    else:
                        self._start_election()
                time.sleep(0.02)

    def _start_election(self, *, force: bool = False) -> None:
        """``force`` skips the pre-vote round — used by leadership
        transfer (Raft §3.10 TimeoutNow): the target must be able to
        depose a HEALTHY leader, which pre-vote exists to prevent."""
        if not force and not self._pre_vote_wins():
            # a live leader is still heartbeating a majority (we're the
            # partitioned/rejoining one): do NOT bump the term — pre-vote
            # (Raft §9.6) keeps a rejoining node from deposing a healthy
            # leader and failing its in-flight commits
            with self.lock:
                self._reset_election_deadline()
            return
        with self.lock:
            if self._stopped or self.state == LEADER:
                return
            self.state = CANDIDATE
            self.log.term += 1
            term = self.log.term
            self.log.voted_for = self.node_id
            self.log.save_meta()
            self.leader_id = None
            self._reset_election_deadline()
            last_idx = self.log.last_index
            last_term = self.log.term_at(
                last_idx, snapshot_term=self.snapshot_term)
        votes = [1]  # self-vote
        done = threading.Event()

        def ask(addr):
            try:
                resp = self._call_peer(addr, "request_vote", {
                    "term": term, "candidate_id": self.node_id,
                    "last_log_index": last_idx, "last_log_term": last_term,
                    "force": force,
                }, timeout=self._election_timeout_ms[0] / 1000.0)
            except Exception:  # noqa: BLE001 peer down: no vote
                return
            with self.lock:
                if resp["term"] > self.log.term:
                    self._become_follower(resp["term"], None)
                    done.set()
                    return
                if resp.get("granted") and self.state == CANDIDATE \
                        and self.log.term == term:
                    votes[0] += 1
                    if votes[0] >= self.quorum_size:
                        self._become_leader()
                        done.set()

        threads = [threading.Thread(target=ask, args=(a,), daemon=True)
                   for a in self.peers.values()]
        for t in threads:
            t.start()
        if not self.peers:  # single-node quorum
            with self.lock:
                self._become_leader()
        done.wait(timeout=self._election_timeout_ms[1] / 1000.0)

    def _pre_vote_wins(self) -> bool:
        """Pre-vote round (Raft §9.6): ask peers whether they would grant
        a vote at term+1 WITHOUT bumping terms. A peer refuses while its
        own election deadline is fresh (it hears a live leader). True
        when a majority would vote — only then is a real (disruptive)
        election worth starting."""
        with self.lock:
            if self._stopped or self.state == LEADER:
                return False
            term = self.log.term + 1
            last_idx = self.log.last_index
            last_term = self.log.term_at(
                last_idx, snapshot_term=self.snapshot_term)
        if not self.peers:
            return True
        votes = [1]
        decided = threading.Event()

        def ask(addr):
            try:
                resp = self._call_peer(addr, "request_vote", {
                    "term": term, "candidate_id": self.node_id,
                    "last_log_index": last_idx, "last_log_term": last_term,
                    "pre_vote": True,
                }, timeout=self._election_timeout_ms[0] / 1000.0)
            except Exception:  # noqa: BLE001 unreachable: no pre-vote
                return
            if resp.get("granted"):
                with self.lock:
                    votes[0] += 1
                    if votes[0] >= self.quorum_size:
                        decided.set()

        threads = [threading.Thread(target=ask, args=(a,), daemon=True)
                   for a in self.peers.values()]
        for t in threads:
            t.start()
        decided.wait(timeout=self._election_timeout_ms[0] / 1000.0)
        with self.lock:
            return votes[0] >= self.quorum_size

    def _become_leader(self) -> None:
        """Caller holds the lock. Appends a no-op barrier record in the new
        term (Raft's leader-completeness read barrier: once it commits, all
        previous terms' entries are committed and applied here)."""
        if self.state == LEADER:
            return
        self.state = LEADER
        self.leader_id = self.node_id
        for nid in self.peers:
            self.next_index[nid] = self.log.last_index + 1
            self.match_index[nid] = 0
        barrier = RaftRecord(self.log.term, self.log.last_index + 1, [])
        self.log.append(barrier)
        self._advance_commit()
        LOG.info("raft %s: leader for term %d", self.node_id, self.log.term)
        for ev in self._peer_wakeups.values():
            ev.set()

    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        """Caller holds the lock."""
        was_leader = self.state == LEADER
        if term > self.log.term:
            self.log.term = term
            self.log.voted_for = None
            self.log.save_meta()
        self.state = FOLLOWER
        if leader is not None:
            self.leader_id = leader
        elif was_leader:
            # stepping down with no known successor: a stale self-
            # pointing leader_id would read as "someone else won" to
            # transfer_leadership and misdirect client redirects
            self.leader_id = None
        self._reset_election_deadline()
        if was_leader:
            LOG.warning("raft %s: stepped down in term %d",
                        self.node_id, term)
            self.commit_cv.notify_all()
            for cb in self._step_down_cbs:
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    LOG.exception("step-down callback failed")

    # -- RPC handlers (peer-facing) ------------------------------------------
    def handle_request_vote(self, req: dict) -> dict:
        if req.get("pre_vote"):
            return self._handle_pre_vote(req)
        with self.lock:
            if not req.get("force") and req["term"] > self.log.term:
                # Leader stickiness for REAL votes too (Raft §4.2.3):
                # pre-vote gates a candidate on ITS view, but a candidate
                # that passed pre-vote just before a leader emerged can
                # still depose the fresh leader and churn terms (observed
                # as back-to-back step-downs after a failover).  While we
                # hear a live leader — or ARE one — ignore the candidate
                # without adopting its term; a legitimately newer leader
                # still flips us via AppendEntries, and leadership
                # transfer (TimeoutNow) bypasses with ``force``.
                lo_s = self._election_timeout_ms[0] / 1000.0
                leader_fresh = self.state == LEADER or \
                    (time.monotonic() - self._last_leader_contact) < lo_s
                if leader_fresh:
                    return {"term": self.log.term, "granted": False}
            if req["term"] > self.log.term:
                self._become_follower(req["term"], None)
            granted = False
            if req["term"] == self.log.term and \
                    self.log.voted_for in (None, req["candidate_id"]):
                last_idx = self.log.last_index
                last_term = self.log.term_at(
                    last_idx, snapshot_term=self.snapshot_term)
                # candidate log must be at least as up-to-date (§5.4.1)
                if (req["last_log_term"], req["last_log_index"]) >= \
                        (last_term, last_idx):
                    granted = True
                    self.log.voted_for = req["candidate_id"]
                    self.log.save_meta()
                    self._reset_election_deadline()
            return {"term": self.log.term, "granted": granted}

    def _handle_pre_vote(self, req: dict) -> dict:
        """Pre-vote answer: NO state mutation (term, voted_for, deadline
        all untouched). Granted only when (a) we ourselves have not heard
        a leader within the MINIMUM election timeout (gating on the
        randomized deadline would refuse the first legitimate candidate
        after a leader death and chain refusal rounds) and (b) the
        candidate's term+log could win."""
        with self.lock:
            lo_s = self._election_timeout_ms[0] / 1000.0
            leader_fresh = self.state == LEADER or \
                (time.monotonic() - self._last_leader_contact) < lo_s
            if req["term"] < self.log.term or leader_fresh:
                return {"term": self.log.term, "granted": False}
            last_idx = self.log.last_index
            last_term = self.log.term_at(
                last_idx, snapshot_term=self.snapshot_term)
            granted = (req["last_log_term"], req["last_log_index"]) >= \
                (last_term, last_idx)
            return {"term": self.log.term, "granted": granted}

    def handle_append_entries(self, req: dict) -> dict:
        with self.lock:
            if req["term"] < self.log.term:
                return {"term": self.log.term, "success": False}
            self._become_follower(req["term"], req["leader_id"])
            self._reset_election_deadline()
            self._last_leader_contact = time.monotonic()
            prev_i, prev_t = req["prev_index"], req["prev_term"]
            if prev_i >= self.log.start_index - 1 or prev_i == 0:
                local_prev = self.log.term_at(
                    prev_i, snapshot_term=self.snapshot_term)
            else:
                # prev is inside our snapshotted prefix: anything the
                # leader sends there is already committed state
                local_prev = prev_t
            if local_prev == -1 or local_prev != prev_t:
                # missing or conflicting: ask to back up (include a hint)
                return {"term": self.log.term, "success": False,
                        "hint_index": min(self.log.last_index + 1,
                                          prev_i)}
            dirty = False
            for w in req.get("records", []):
                rec = RaftRecord.from_wire(w)
                if rec.index <= self.log.last_index:
                    if self.log.term_at(
                            rec.index,
                            snapshot_term=self.snapshot_term) == rec.term:
                        continue  # duplicate
                    if rec.index <= self.applied_index:
                        # conflicting below applied state should be
                        # impossible (committed entries never conflict)
                        LOG.error("raft %s: conflict below applied index",
                                  self.node_id)
                        return {"term": self.log.term, "success": False}
                    self.log.truncate_from(rec.index)
                if rec.index == self.log.last_index + 1:
                    self.log.append(rec, fsync=False)
                    dirty = True
            if dirty:
                self.log.flush()
            if req["leader_commit"] > self.commit_index:
                self.commit_index = min(req["leader_commit"],
                                        self.log.last_index)
                self.apply_cv.notify_all()
                self.commit_cv.notify_all()
            return {"term": self.log.term, "success": True,
                    "match_index": self.log.last_index}

    def handle_install_snapshot(self, req: dict) -> dict:
        with self.lock:
            if req["term"] < self.log.term:
                return {"term": self.log.term, "ok": False}
            self._become_follower(req["term"], req["leader_id"])
            self._last_leader_contact = time.monotonic()
            snap = req["snapshot"]
            if snap["index"] <= self.applied_index:
                return {"term": self.log.term, "ok": True,
                        "match_index": self.log.last_index}
        # lock order _snap_io_lock -> _state_lock -> self.lock, same as
        # take_snapshot; _state_lock freezes appliers during restore
        with self._snap_io_lock:
            with self._state_lock:
                with self.lock:
                    # re-check: state may have moved while unlocked
                    if req["term"] < self.log.term:
                        return {"term": self.log.term, "ok": False}
                    if snap["index"] <= self.applied_index:
                        return {"term": self.log.term, "ok": True,
                                "match_index": self.log.last_index}
                self._restore_fn(snap["components"])
                with self.lock:
                    self.snapshot_term = snap["term"]
                    self.applied_index = snap["index"]
                    self.applied_seq = snap["seq"]
                    self.commit_index = max(self.commit_index, snap["index"])
            # persist the snapshot file BEFORE truncating the durable log
            # (a crash in between leaves snapshot+old-log, which recovery
            # reconciles; truncating first would leave a hole) — and do
            # the file IO outside the consensus lock
            d = self._snap_dir()
            os.makedirs(d, exist_ok=True)
            blob = msgpack.packb(snap, use_bin_type=True)
            self._write_snapshot_file(d, snap["term"], snap["index"], blob)
        with self.lock:
            # discard the log prefix the snapshot covers (usually all)
            self.log.records = [r for r in self.log.records
                                if r.index > snap["index"]]
            self.log.start_index = max(self.log.start_index,
                                       snap["index"] + 1)
            self.log.save_meta()
            self.log._rewrite()
            return {"term": self.log.term, "ok": True,
                    "match_index": self.log.last_index}

    def transfer_leadership(self, target_id: str,
                            timeout_s: float = 5.0) -> bool:
        """Leader-side graceful handover (Raft §3.10; reference: Ratis
        leadership transfer behind ``journal quorum elect``): pause new
        proposals, bring the target fully up to date, then TimeoutNow so
        it elects immediately (force-election past pre-vote). Returns
        True once this node observes the target's leadership. Aborts
        WITHOUT firing the election when catch-up fails — TimeoutNow at
        a lagging target can only depose the healthy leader and lose
        the vote (§5.4.1), a pure availability hole."""
        with self.lock:
            if self.state != LEADER:
                raise JournalClosedError(
                    f"not the raft leader (leader={self.leader_id})")
            if target_id not in self.peers:
                raise ValueError(f"unknown quorum member {target_id!r}")
            addr = self.peers[target_id]
            # §3.10: stop taking client requests for the duration, THEN
            # snapshot the index the target must reach — no append can
            # race past it while the flag is up
            self._transferring = True
            last = self.log.last_index
            term = self.log.term
        try:
            catch_up_deadline = time.monotonic() + timeout_s / 2
            caught_up = False
            while time.monotonic() < catch_up_deadline:
                with self.lock:
                    if self.match_index.get(target_id, 0) >= last:
                        caught_up = True
                        break
                    ev = self._peer_wakeups.get(target_id)
                if ev is not None:
                    ev.set()
                time.sleep(0.02)
            if not caught_up:
                return False  # abort: no TimeoutNow at a lagging target
            try:
                self._call_peer(addr, "timeout_now",
                               {"term": term, "leader_id": self.node_id},
                               timeout=2.0)
            except Exception:  # noqa: BLE001 target unreachable
                return False
            observe_deadline = time.monotonic() + timeout_s / 2
            while time.monotonic() < observe_deadline:
                with self.lock:
                    if self.state != LEADER:
                        # step-down cleared leader_id; the new leader's
                        # first heartbeat fills it in
                        if self.leader_id == target_id:
                            return True
                        if self.leader_id is not None:
                            return False  # someone else won
                time.sleep(0.02)
            return False
        finally:
            with self.lock:
                self._transferring = False

    def handle_timeout_now(self, req: dict) -> dict:
        """TimeoutNow from the leader: start a forced election NOW.
        §3.10: TimeoutNow is LEADER-initiated only — a sender that
        CONTRADICTS a leader we already recognize at the current term is
        rejected. When we have not yet recorded a leader for the term
        (leader_id None right after a vote-driven term bump, before the
        first AppendEntries) the request is accepted: the legitimate
        leader's transfer must not silently abort in that window, at the
        cost of also trusting an equal-term sender we cannot yet
        disprove. Like all of Raft this is crash-fault-tolerant only: a
        *malicious* peer forging the leader's id is outside the model
        (peers are trusted)."""
        with self.lock:
            if self._stopped or self.state == LEADER or \
                    req.get("term", 0) < self.log.term:
                return {"ok": False}
            sender = req.get("leader_id")
            # Accept when we have not yet recorded a leader for this term
            # (leader_id None right after a vote-driven term bump, before
            # the first AppendEntries) — the legitimate leader's transfer
            # must not silently abort then. Reject only a sender that
            # CONTRADICTS a known leader.
            if req.get("term", 0) == self.log.term and \
                    self.leader_id is not None and \
                    sender != self.leader_id:
                return {"ok": False}
        threading.Thread(target=self._start_election,
                         kwargs={"force": True}, daemon=True).start()
        return {"ok": True}

    def quorum_info(self) -> dict:
        now = time.monotonic()
        with self.lock:
            members = [{"node_id": self.node_id, "address": "self",
                        "role": self.state,
                        "match_index": self.log.last_index,
                        "last_contact_s": 0.0}]
            for nid, addr in self.peers.items():
                at = self.peer_contact.get(nid)
                members.append({
                    "node_id": nid, "address": addr,
                    "role": "LEADER" if nid == self.leader_id else "UNKNOWN"
                    if self.state != LEADER else "FOLLOWER",
                    "match_index": self.match_index.get(nid, 0),
                    # None = never heard from (or we are not the leader,
                    # so we do not probe peers at all)
                    "last_contact_s": None if at is None
                    else max(0.0, now - at)})
            return {"leader": self.leader_id, "term": self.log.term,
                    "commit_index": self.commit_index, "members": members}

    # -- leader write path ----------------------------------------------------
    def propose(self, entries: List[JournalEntry],
                timeout_s: float = 30.0) -> None:
        """Append a batch as the leader; block until committed on a
        quorum, then apply it ON THIS THREAD (the caller holds the owning
        component's write lock, which is what serializes application
        against readers). Raises JournalClosedError when not leader,
        deposed mid-flight, or quorum-commit times out — in the last two
        cases the batch MAY still commit later (ambiguous failure, as in
        the reference; the apply loop then applies it)."""
        # copy: the caller (JournalContext) clears its batch list after
        # write_and_flush returns, but this record outlives the call (log
        # retention + lazy re-serialization for follower replication)
        entries = list(entries)
        with self.lock:
            if self.state != LEADER:
                raise JournalClosedError(
                    f"not the raft leader (leader={self.leader_id})")
            if self._transferring:
                raise JournalClosedError(
                    "leadership transfer in progress; retry against "
                    "the new leader")
            rec = RaftRecord(self.log.term, self.log.last_index + 1, entries)
            self.log.append(rec)
            idx = rec.index
            self._local_batches[idx] = rec
            self._advance_commit()  # single-node quorum commits instantly
        for ev in self._peer_wakeups.values():
            ev.set()
        deadline = time.monotonic() + timeout_s
        try:
            with self.lock:
                while not (self.commit_index >= idx
                           and self.applied_index == idx - 1):
                    if self._stopped:
                        raise JournalClosedError("raft node stopped")
                    if self.state != LEADER and self.commit_index < idx:
                        raise JournalClosedError(
                            "lost leadership before commit; entry not "
                            "acknowledged")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise JournalClosedError(
                            "timed out waiting for quorum commit")
                    self.commit_cv.wait(timeout=min(remaining, 0.5))
            # committed + predecessor applied: apply on this thread.
            # _state_lock taken BEFORE self.lock (lock order) freezes
            # component state against snapshot capture; applied_index
            # cannot move meanwhile — our record is in _local_batches so
            # the apply loop skips it, and nothing can apply idx+1 first.
            with self._state_lock:
                with self.lock:
                    if self.log.get(idx) is not rec:
                        # deposed before replication: a new leader's record
                        # truncated ours away — the committed slot at idx
                        # is NOT our batch; never apply the stale entries
                        # (the apply loop handles the real record once we
                        # unregister in the finally block)
                        raise JournalClosedError(
                            "entry superseded after leadership loss; not "
                            "acknowledged")
                    for e in rec.entries:
                        self._apply_fn(e)
                        self.applied_seq = max(self.applied_seq, e.sequence)
                        self._entries_since_snapshot += 1
                    self.applied_index = idx
                    self.apply_cv.notify_all()
                    self.commit_cv.notify_all()
        finally:
            with self.lock:
                self._local_batches.pop(idx, None)
                self.apply_cv.notify_all()

    def _advance_commit(self) -> None:
        """Caller holds the lock. Leader-only: commit = highest index
        replicated on a quorum with a record of the current term (§5.4.2)."""
        if self.state != LEADER:
            return
        for idx in range(self.log.last_index, self.commit_index, -1):
            if self.log.term_at(idx, snapshot_term=self.snapshot_term) != \
                    self.log.term:
                break
            count = 1 + sum(1 for nid in self.peers
                            if self.match_index.get(nid, 0) >= idx)
            if count >= self.quorum_size:
                self.commit_index = idx
                self.apply_cv.notify_all()
                self.commit_cv.notify_all()
                break

    # -- replication (leader -> one peer) ------------------------------------
    def _peer_loop(self, nid: str) -> None:
        ev = self._peer_wakeups[nid]
        addr = self.peers[nid]
        while True:
            ev.wait(timeout=self._heartbeat_ms / 1000.0)
            ev.clear()
            with self.lock:
                if self._stopped:
                    return
                if self.state != LEADER:
                    continue
                term = self.log.term
                nxt = self.next_index.get(nid, self.log.last_index + 1)
                need_snap = nxt < self.log.start_index
                if not need_snap:
                    prev = nxt - 1
                    prev_term = self.log.term_at(
                        prev, snapshot_term=self.snapshot_term)
                    recs = [r.to_wire() for r in self.log.slice_from(nxt)]
                    commit = self.commit_index
            payload = None
            if need_snap:
                # read + decode the (possibly large) snapshot file OUTSIDE
                # the consensus lock — a slow standby must not stall
                # appends/votes into an election timeout
                snap_path = self._latest_snapshot_path()
                if snap_path is not None:
                    with open(snap_path, "rb") as f:
                        payload = msgpack.unpackb(
                            f.read(), raw=False, strict_map_key=False)
            try:
                if need_snap:
                    if payload is None:
                        # no snapshot on disk yet (all state in log):
                        # take one, then retry with it available
                        self.take_snapshot()
                        continue
                    resp = self._call_peer(addr, "install_snapshot", {
                        "term": term, "leader_id": self.node_id,
                        "snapshot": payload}, timeout=10.0)
                    self.peer_contact[nid] = time.monotonic()
                    with self.lock:
                        if resp["term"] > self.log.term:
                            self._become_follower(resp["term"], None)
                            continue
                        if resp.get("ok"):
                            self.match_index[nid] = payload["index"]
                            self.next_index[nid] = payload["index"] + 1
                    continue
                resp = self._call_peer(addr, "append_entries", {
                    "term": term, "leader_id": self.node_id,
                    "prev_index": prev, "prev_term": prev_term,
                    "records": recs, "leader_commit": commit,
                }, timeout=2.0)
            except Exception:  # noqa: BLE001 peer unreachable: retry later
                continue
            # any decoded reply is proof of life (quorum view + the
            # quorum-degraded health sampling read this)
            self.peer_contact[nid] = time.monotonic()
            with self.lock:
                if resp["term"] > self.log.term:
                    self._become_follower(resp["term"], None)
                    continue
                if self.state != LEADER or self.log.term != term:
                    continue
                if resp.get("success"):
                    self.match_index[nid] = resp["match_index"]
                    self.next_index[nid] = resp["match_index"] + 1
                    self._advance_commit()
                    if self.next_index[nid] <= self.log.last_index:
                        ev.set()  # more to send
                else:
                    hint = resp.get("hint_index")
                    self.next_index[nid] = max(
                        1, hint if hint is not None else nxt - 1)
                    ev.set()

    # -- apply loop -----------------------------------------------------------
    def _apply_loop(self) -> None:
        """Applies committed NON-local records in order (replication on
        followers; barrier records and orphaned batches on leaders).
        Records whose proposer is live-waiting are left to that thread."""
        from alluxio_tpu_torch.utils import faults

        while True:
            with self.lock:
                rec = None
                while not self._stopped:
                    if faults.armed() and faults.injector() \
                            .tailer_frozen(self.node_id):
                        # chaos tailer-freeze, Raft flavor: commit may
                        # advance but this member stops APPLYING — its
                        # served md_version stalls, exactly the standby
                        # staleness drill
                        self.apply_cv.wait(timeout=0.05)
                        continue
                    if self.applied_index < self.commit_index:
                        nxt = self.log.get(self.applied_index + 1)
                        if nxt is not None and \
                                nxt.index not in self._local_batches:
                            rec = nxt
                            break
                    self.apply_cv.wait(timeout=0.5)
                if self._stopped:
                    return
                was_leader = self.state == LEADER
            # apply under _state_lock -> lock (same order as propose /
            # take_snapshot); re-verify the record is still the next one
            # (a conflict truncation may have replaced it while unlocked)
            snap_due = False
            # FOLLOWERS ONLY: a leader applying an orphan/barrier record
            # must not wait on the tree write lock — a live-waiting
            # proposer holds the tree READ lock until this very record
            # applies, a cross-thread cycle that would stall every write
            # for the propose timeout.  Leaders have no standby readers
            # to exclude anyway; the rare just-deposed race (one batch
            # applied unexcluded) closes on the next loop iteration.
            excl = self.apply_exclusion if not was_leader else None
            with (excl() if excl is not None else contextlib.nullcontext()):
                with self._state_lock:
                    with self.lock:
                        if self._stopped:
                            return
                        if self.log.get(self.applied_index + 1) is not rec:
                            continue
                        for e in rec.entries:
                            self._apply_fn(e)
                            self.applied_seq = max(self.applied_seq,
                                                   e.sequence)
                            self._entries_since_snapshot += 1
                        self.applied_index = rec.index
                        self.commit_cv.notify_all()
                        self.apply_cv.notify_all()
                        snap_due = self._entries_since_snapshot >= \
                            self._snapshot_period
            if snap_due:
                try:
                    self.take_snapshot()
                except Exception:  # noqa: BLE001
                    LOG.exception("periodic raft snapshot failed")

    def is_leader(self) -> bool:
        with self.lock:
            return self.state == LEADER

    def leader_ready(self) -> bool:
        """Leader AND the no-op barrier of its term has been applied (all
        prior-term entries are in local state — safe to serve)."""
        with self.lock:
            return self.state == LEADER and \
                self.applied_index >= self.commit_index and \
                self.log.term_at(self.commit_index,
                                 snapshot_term=self.snapshot_term) == \
                self.log.term


def _peer_call(addr: str, method: str, req: dict, timeout: float):
    from alluxio_tpu_torch.rpc.core import RpcChannel

    return RpcChannel(addr).call(RAFT_SERVICE, method, req, timeout=timeout)


def raft_journal_service(node: RaftNode):
    """RPC surface (reference: ``grpc/raft_journal.proto`` +
    ``grpc/journal_master.proto`` quorum info)."""
    from alluxio_tpu_torch.rpc.core import ServiceDefinition

    svc = ServiceDefinition(RAFT_SERVICE)
    svc.unary("request_vote", node.handle_request_vote)
    svc.unary("append_entries", node.handle_append_entries)
    svc.unary("install_snapshot", node.handle_install_snapshot)
    svc.unary("get_quorum_info", lambda r: node.quorum_info())
    svc.unary("timeout_now", node.handle_timeout_now)
    return svc


class EmbeddedJournalSystem(JournalSystem):
    """The EMBEDDED journal flavor: a RaftNode + its RPC server.

    ``write_and_flush`` = propose-to-quorum; components register exactly as
    with the local journal; standby application is continuous (followers'
    components stay hot). Reference: ``RaftJournalSystem.java:150``.
    """

    def __init__(self, folder: str, *, node_id: str = "",
                 address: str = "", addresses: str = "",
                 election_timeout_ms: Tuple[int, int] = (300, 600),
                 heartbeat_interval_ms: int = 100,
                 snapshot_period_entries: int = 100_000,
                 **_ignored) -> None:
        super().__init__()
        members: Dict[str, str] = {}
        for a in [s.strip() for s in addresses.split(",") if s.strip()]:
            members[a] = a  # node_id IS the address (stable + unique)
        self._address = address or (next(iter(members)) if members else
                                    "127.0.0.1:0")
        if self._address not in members:
            members[self._address] = self._address
        self.node = RaftNode(
            node_id or self._address, members, folder,
            election_timeout_ms=election_timeout_ms,
            heartbeat_interval_ms=heartbeat_interval_ms,
            apply_fn=self._apply,
            snapshot_fn=lambda: {name: c.snapshot()
                                 for name, c in self._components.items()},
            restore_fn=self._restore_components,
            snapshot_period_entries=snapshot_period_entries)
        self._server = None
        self._seq_lock = threading.Lock()
        self._alloc_high = 0
        self._started = False

    def _restore_components(self, comps: dict) -> None:
        for name, comp in self._components.items():
            if name in comps:
                comp.restore(comps[name])
            else:
                comp.reset_state()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        from alluxio_tpu_torch.rpc.core import RpcServer

        host, _, port = self._address.rpartition(":")
        self._server = RpcServer(bind_host=host or "0.0.0.0",
                                 port=int(port))
        self._server.add_service(raft_journal_service(self.node))
        self._server.start()
        self.node.start()
        self._started = True

    def gain_primacy(self) -> None:
        """Block until this node wins an election and its barrier commits.
        With peers down in a fresh quorum this can wait; callers that want
        standby behavior use ``standby_start`` + a selector instead."""
        self.start()
        while not self.node.leader_ready():
            if self.node._stopped:
                raise JournalClosedError("raft node stopped during election")
            time.sleep(0.02)

    def standby_start(self) -> None:
        self.start()

    def gain_primacy_from_standby(self) -> None:
        self.gain_primacy()

    def catch_up(self) -> int:
        return 0  # replication applies continuously; nothing to tail

    def lose_primacy(self) -> None:
        with self.node.lock:
            if self.node.state == LEADER:
                self.node._become_follower(self.node.log.term, None)

    def stop(self) -> None:
        self.node.stop()
        if self._server is not None:
            self._server.stop()
            self._server = None
        self._started = False

    def is_primary(self) -> bool:
        return self.node.is_leader()

    # -- writing --------------------------------------------------------------
    def allocate_entry(self, entry_type: str, payload: dict) -> JournalEntry:
        # provisional; propose() order defines the authoritative log
        # order, and apply tracks max(seq) so a new leader never reuses one
        with self._seq_lock:
            with self.node.lock:
                seq = max(self.node.applied_seq, self._alloc_high) + 1
            self._alloc_high = seq
            return JournalEntry(seq, entry_type, payload)

    def write_and_flush(self, entries: List[JournalEntry]) -> None:
        if not entries:
            return
        self.node.propose(entries)

    # -- maintenance ----------------------------------------------------------
    def checkpoint(self) -> None:
        self.node.take_snapshot()

    def checkpoint_standby(self) -> None:
        self.node.take_snapshot()

    @property
    def sequence(self) -> int:
        with self.node.lock:
            return self.node.applied_seq

    @property
    def last_checkpoint_sequence(self) -> int:
        return 0

    def write_backup(self, backup_dir: str) -> str:
        os.makedirs(backup_dir, exist_ok=True)
        with self.node.lock:
            snap = {
                "sequence": self.node.applied_seq,
                "components": {name: comp.snapshot()
                               for name, comp in self._components.items()},
            }
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(backup_dir,
                            f"atpu-backup-{stamp}-{snap['sequence']}.bak")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(snap, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def quorum_info(self) -> dict:
        return self.node.quorum_info()

    def transfer_leadership(self, target_id: str) -> bool:
        return self.node.transfer_leadership(target_id)


class RaftPrimarySelector(PrimarySelector):
    """Adapts a RaftNode to the PrimarySelector SPI: primacy == elected
    leadership (reference: ``RaftPrimarySelector.java``)."""

    def __init__(self, journal: EmbeddedJournalSystem) -> None:
        self._journal = journal

    def start(self) -> None:
        self._journal.start()

    def try_acquire(self) -> bool:
        return self._journal.node.leader_ready()

    def is_primary(self) -> bool:
        return self._journal.node.is_leader()

    def release(self) -> None:
        self._journal.lose_primacy()
