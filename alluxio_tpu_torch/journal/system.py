"""Journal system: segmented WAL + checkpoints + group-commit flushing (a
copy of ``alluxio_tpu/journal/system.py``).

Re-design of the reference's journal stack
(``core/server/common/.../journal/{JournalSystem,AsyncJournalWriter,
JournalContext}.java`` and the UFS flavor ``journal/ufs/UfsJournal.java:71``):

- A **LocalJournalSystem** writes sequence-contiguous segment files
  ``<dir>/logs/0x<start>-0x<end>.log`` plus an active ``current.log``; a
  **checkpoint** is a msgpack snapshot of every `Journaled` component at a
  sequence number (``<dir>/checkpoints/0x<seq>.ckpt``), after which older
  segments are garbage-collected.
- **Group commit**: all entries of one ``JournalContext`` are written and
  fsynced together on context exit — the same acknowledged-durability
  contract the reference gets from ``AsyncJournalWriter``'s flush-before-
  RPC-return, batched per operation instead of per timer tick.
- **Primacy fencing** uses an epoch file + O_EXCL lock file; a master that
  loses the lock stops writing (the reference fences via log rotation /
  Raft terms). Raft-style replicated mode lives in ``journal/raft.py``.
- A NOOP flavor backs read-only/standby and unit-test uses.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

import msgpack

from alluxio_tpu_torch.journal.format import JournalEntry, Journaled
from alluxio_tpu_torch.utils.exceptions import JournalClosedError

LOG_DIR = "logs"
CKPT_DIR = "checkpoints"
ACTIVE_LOG = "current.log"


def sorted_segments(log_dir: str) -> List[str]:
    """Closed segments by start sequence, then the active log."""
    if not os.path.isdir(log_dir):
        return []
    segs = [f for f in os.listdir(log_dir) if f.endswith(".log")]
    return sorted(segs, key=lambda f: (1 << 62) if f == ACTIVE_LOG
                  else int(f.split("-")[0], 16))


def latest_checkpoint_name(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cks = [f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt")]
    if not cks:
        return None
    return max(cks, key=lambda f: int(f.split(".")[0], 16))


class JournalContext:
    """Scoped appender: entries written through one context are flushed
    (durable) by the time the context exits (reference: ``JournalContext``
    + ``MasterJournalContext``)."""

    def __init__(self, system: "JournalSystem") -> None:
        self._system = system
        self._pending: List[JournalEntry] = []

    def append(self, entry_type: str, payload: dict) -> JournalEntry:
        entry = self._system.allocate_entry(entry_type, payload)
        self._pending.append(entry)
        return entry

    def __enter__(self) -> "JournalContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._system.write_and_flush(self._pending)
        self._pending.clear()
        return False


class JournalSystem:
    """Abstract journal system."""

    def __init__(self) -> None:
        self._components: Dict[str, Journaled] = {}

    def register(self, component: Journaled) -> None:
        assert component.journal_name, "Journaled needs a journal_name"
        self._components[component.journal_name] = component

    # lifecycle
    def start(self) -> None: ...
    def gain_primacy(self) -> None: ...
    def lose_primacy(self) -> None: ...
    def stop(self) -> None: ...

    def is_primary(self) -> bool:
        return True

    # writing
    def allocate_entry(self, entry_type: str, payload: dict) -> JournalEntry:
        raise NotImplementedError

    def write_and_flush(self, entries: List[JournalEntry]) -> None:
        raise NotImplementedError

    def create_context(self) -> JournalContext:
        return JournalContext(self)

    def deferred_durability(self):
        """Scope in which journal contexts may DEFER their durability
        wait to scope exit (reference: ``AsyncJournalWriter`` — state is
        applied immediately, the fsync happens once per RPC, after all
        locks are released, before the response goes out). Default: a
        no-op scope; flavors with a real fsync override this."""
        import contextlib

        return contextlib.nullcontext()

    def immediate_durability(self):
        """Scope that suspends ``deferred_durability`` for writes that
        must be durable BEFORE their effects are exposed to other
        threads (e.g. id-chunk reservations: an id may be handed out,
        used and journaled by another RPC before the deferring RPC ever
        flushes its reservation)."""
        import contextlib

        return contextlib.nullcontext()

    # maintenance
    def checkpoint(self) -> None: ...

    def _apply(self, entry: JournalEntry) -> None:
        for comp in self._components.values():
            if comp.process_entry(entry):
                return
        raise ValueError(f"no component applied journal entry {entry.type}")


class NoopJournalSystem(JournalSystem):
    """Applies entries to state immediately; durability-free (tests)."""

    def __init__(self) -> None:
        super().__init__()
        self._seq = 0
        self._lock = threading.Lock()

    def allocate_entry(self, entry_type: str, payload: dict) -> JournalEntry:
        with self._lock:
            self._seq += 1
            return JournalEntry(self._seq, entry_type, payload)

    def write_and_flush(self, entries: List[JournalEntry]) -> None:
        # serialize applies: with the striped inode tree, concurrent
        # disjoint-subtree mutations reach here in parallel, and the
        # Journaled components' registries assume one applier at a time
        with self._lock:
            for e in entries:
                self._apply(e)


class LocalJournalSystem(JournalSystem):
    """Durable single-writer journal over a directory (local disk or any
    mounted shared filesystem — the UFS-journal analogue)."""

    #: bound on queued-but-unwritten entries in group-commit mode:
    #: producers block (briefly — one flusher drain) at the cap, so a
    #: flusher stall cannot grow the queue without bound
    COMMIT_QUEUE_MAX_ENTRIES = 10_000

    def __init__(self, folder: str, *,
                 max_log_size: int = 64 << 20,
                 checkpoint_period_entries: int = 2_000_000) -> None:
        super().__init__()
        self._folder = folder
        self._log_dir = os.path.join(folder, LOG_DIR)
        self._ckpt_dir = os.path.join(folder, CKPT_DIR)
        self._max_log_size = max_log_size
        self._checkpoint_period = checkpoint_period_entries
        self._seq = 0
        self._last_checkpoint_seq = 0
        self._primary = False
        self._file = None
        self._file_start_seq = 1
        self._lock = threading.RLock()
        self._closed = False
        # Durability is tracked by WRITE TICKETS, not sequence numbers:
        # a ticket is assigned under the main lock in the same critical
        # section as the batch's acceptance, so "synced ticket >= mine"
        # really means "my batch reached the disk".  (Sequence numbers
        # cannot carry this: they are allocated before the write, so a
        # batch written AFTER a covering fsync could carry a smaller
        # seq and be acknowledged without ever being fsynced.)
        self._write_ticket = 0    # batches accepted (inline: written)
        self._synced_ticket = 0   # batches known fsync-durable
        # inline group commit: one fsync covers every batch written
        # before it (reference: AsyncJournalWriter's flush batching)
        self._flush_lock = threading.Lock()
        self._deferred = threading.local()
        # -- dedicated group-commit flusher (atpu.master.journal.flush.
        # batch.time): entries are accepted + applied under the main
        # lock, queued, and written+fsynced by ONE background flusher
        # in timed batches; producers block only until their batch's
        # fsync completes — the same acknowledged-durability point,
        # off the callers' inode-lock critical sections.
        self._commit_cond = threading.Condition(self._lock)
        self._commit_queue: List[List[JournalEntry]] = []
        self._commit_queue_entries = 0
        self._batch_time_s = 0.0
        self._flusher: "threading.Thread | None" = None
        self._flusher_stop = False
        self._flush_error: "BaseException | None" = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        os.makedirs(self._log_dir, exist_ok=True)
        os.makedirs(self._ckpt_dir, exist_ok=True)

    def gain_primacy(self) -> None:
        """Replay (checkpoint + segments) then open a fresh active log."""
        with self._lock:
            self._replay()
            self._open_log()
            self._primary = True

    def lose_primacy(self) -> None:
        self._stop_flusher()
        with self._lock:
            self._primary = False
            self._close_log()

    def stop(self) -> None:
        self._stop_flusher()
        with self._lock:
            self._close_log()
            self._closed = True

    # -- group-commit flusher ----------------------------------------------
    def start_group_commit(self, batch_time_s: float = 0.005) -> None:
        """Start the dedicated journal flusher
        (``atpu.master.journal.flush.batch.time``): from here on,
        ``write_and_flush`` queues entries instead of writing inline,
        and the flusher coalesces up to ``batch_time_s`` of arrivals
        into one file write + one fsync.  Idempotent."""
        with self._lock:
            if self._flusher is not None:
                return
            self._batch_time_s = max(0.0, float(batch_time_s))
            self._flusher_stop = False
            self._flusher = threading.Thread(
                target=self._flusher_loop, name="journal-flusher",
                daemon=True)
            self._flusher.start()

    def _stop_flusher(self) -> None:
        with self._lock:
            t = self._flusher
            if t is None:
                return
            self._flusher_stop = True
            self._commit_cond.notify_all()
        t.join(timeout=30.0)
        with self._lock:
            self._flusher = None

    def _flusher_loop(self) -> None:
        from alluxio_tpu_torch.metrics import metrics as _metrics

        batch_timer = _metrics().timer("Master.MetadataJournalBatchSize")
        flush_timer = _metrics().timer("Master.MetadataJournalFlushTime")
        pressured = False  # queue was non-empty right after the last flush
        while True:
            with self._commit_cond:
                while not self._commit_queue and not self._flusher_stop:
                    self._commit_cond.wait(0.2)
                if not self._commit_queue and self._flusher_stop:
                    return
            # Coalescing window (reference: AsyncJournalWriter waits up
            # to the batch time for more entries) — applied ONLY under
            # sustained pressure: a lone sequential writer flushes
            # immediately (inline-class latency), while concurrent load
            # — which refills the queue during the previous fsync —
            # accumulates batch_time of arrivals into one fsync.
            if pressured and self._batch_time_s > 0 and \
                    not self._flusher_stop:
                time.sleep(self._batch_time_s)
            t0 = time.perf_counter()
            fd = None
            with self._commit_cond:
                batches = self._commit_queue
                self._commit_queue = []
                n_entries = self._commit_queue_entries
                self._commit_queue_entries = 0
                ticket = self._write_ticket
                try:
                    if self._file is None:
                        raise JournalClosedError(
                            "journal log closed with entries queued")
                    for batch in batches:
                        for e in batch:
                            self._file.write(e.encode())
                    self._maybe_rotate()
                    if self._seq - self._last_checkpoint_seq >= \
                            self._checkpoint_period:
                        self._checkpoint_locked()
                    if self._file is not None:
                        self._file.flush()
                        fd = self._file.fileno()
                except BaseException as e:  # noqa: BLE001 latch + surface
                    self._flush_error = e
                # free bounded-queue waiters
                self._commit_cond.notify_all()
            if fd is not None and self._flush_error is None:
                try:
                    self._fsync(fd)
                except (OSError, ValueError) as e:
                    # a concurrent rotation (checkpoint RPC) closes this
                    # fd AFTER fsyncing it and marks the written tickets
                    # synced — benign iff our ticket is already covered;
                    # a real fsync failure is latched: an acknowledged-
                    # durability journal must not limp on
                    with self._commit_cond:
                        if self._synced_ticket < ticket:
                            self._flush_error = e
            with self._commit_cond:
                if self._flush_error is None and \
                        ticket > self._synced_ticket:
                    self._synced_ticket = ticket
                pressured = bool(self._commit_queue)
                self._commit_cond.notify_all()
            batch_timer.update(float(n_entries))
            flush_timer.update(time.perf_counter() - t0)

    def _fsync(self, fd: int) -> None:
        """The one fsync choke point (tests/benches override to model
        slow devices; the chaos injector's ``fsync_errors`` countdown
        fails the next N syncs here — the ack-durability crash drill)."""
        from alluxio_tpu_torch.utils import faults

        if faults.armed() and faults.injector().take_fsync_error():
            raise OSError("injected journal fsync failure")
        os.fsync(fd)

    def is_primary(self) -> bool:
        return self._primary

    # -- replay -------------------------------------------------------------
    def _list_segments(self) -> List[str]:
        return sorted_segments(self._log_dir)

    def _latest_checkpoint(self) -> Optional[str]:
        return latest_checkpoint_name(self._ckpt_dir)

    def _replay(self) -> None:
        for comp in self._components.values():
            comp.reset_state()
        start_seq = 0
        ck = self._latest_checkpoint()
        if ck:
            with open(os.path.join(self._ckpt_dir, ck), "rb") as f:
                snap = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
            start_seq = snap["sequence"]
            for name, comp in self._components.items():
                if name in snap["components"]:
                    comp.restore(snap["components"][name])
        max_seq = start_seq
        for seg in self._list_segments():
            path = os.path.join(self._log_dir, seg)
            try:
                f = open(path, "rb")
            except FileNotFoundError:  # GC'd by a live primary mid-scan
                continue
            with f:
                for entry in JournalEntry.decode_stream(f):
                    if entry.sequence <= start_seq:
                        continue
                    self._apply(entry)
                    max_seq = max(max_seq, entry.sequence)
        self._seq = max_seq
        self._last_checkpoint_seq = start_seq

    # -- writing ------------------------------------------------------------
    def _open_log(self) -> None:
        self._file_start_seq = self._seq + 1
        path = os.path.join(self._log_dir, ACTIVE_LOG)
        self._file = open(path, "ab")

    def _close_log(self) -> None:
        if self._file is None:
            return
        self._file.flush()
        self._fsync(self._file.fileno())
        # every WRITTEN batch is in this file (or an earlier, already-
        # fsynced one): rotation is a durability point.  Batches still
        # in the commit queue (group-commit mode, one ticket each) are
        # not written yet and must stay uncovered.
        written = self._write_ticket - len(self._commit_queue)
        self._synced_ticket = max(self._synced_ticket, written)
        self._file.close()
        self._file = None
        cur = os.path.join(self._log_dir, ACTIVE_LOG)
        if os.path.exists(cur) and self._seq >= self._file_start_seq:
            final = os.path.join(
                self._log_dir,
                f"{self._file_start_seq:016x}-{self._seq:016x}.log")
            os.rename(cur, final)
        elif os.path.exists(cur) and os.path.getsize(cur) == 0:
            os.remove(cur)

    def _maybe_rotate(self) -> None:
        if self._file is not None and self._file.tell() >= self._max_log_size:
            self._close_log()
            self._open_log()

    def allocate_entry(self, entry_type: str, payload: dict) -> JournalEntry:
        with self._lock:
            if self._closed:
                raise JournalClosedError("journal is closed")
            if self._file is None:
                # tail-only (standby) or not yet primary: sequences are
                # assigned by the primary.  Allocating here would bump
                # _seq past entries we have not tailed, and catch_up
                # would then silently SKIP the primary's real entries
                # at those sequences — fail the write attempt instead.
                raise JournalClosedError("journal not open for writes")
            self._seq += 1
            return JournalEntry(self._seq, entry_type, payload)

    def write_and_flush(self, entries: List[JournalEntry]) -> None:
        """Accept + apply this batch; make it durable before returning —
        either right here, or (inside a ``deferred_durability`` scope)
        once at scope exit so one fsync covers every context the RPC
        opened AND coalesces with other threads' flushes (group commit,
        reference ``AsyncJournalWriter``).

        Inline mode writes the file under the main lock and fsyncs via
        the flush convoy.  Group-commit mode (``start_group_commit``)
        queues the batch for the dedicated flusher — the file write and
        fsync both leave the caller's critical section, and the caller
        blocks only until its batch's fsync completes.  Either way the
        in-memory apply happens here, under the main lock, in
        acceptance order — an entry is applied before it is durable:
        the same visibility contract as the reference, which applies
        first and flushes before the mutating RPC responds, so no
        ACKNOWLEDGED mutation is ever lost.
        """
        if not entries:
            return
        with self._lock:
            if self._closed or self._file is None:
                raise JournalClosedError("journal not open for writes")
            batched = self._flusher is not None
            if batched:
                if self._flush_error is not None:
                    raise JournalClosedError(
                        "journal flusher failed") from self._flush_error
                while self._commit_queue_entries >= \
                        self.COMMIT_QUEUE_MAX_ENTRIES:
                    self._commit_cond.wait(0.5)
                    if self._flush_error is not None:
                        raise JournalClosedError(
                            "journal flusher failed") from self._flush_error
                    if self._closed or self._file is None:
                        raise JournalClosedError("journal not open for writes")
                self._commit_queue.append(list(entries))
                self._commit_queue_entries += len(entries)
            else:
                for e in entries:
                    self._file.write(e.encode())
            self._write_ticket += 1
            ticket = self._write_ticket
            for e in entries:
                self._apply(e)
            if batched:
                self._commit_cond.notify_all()  # wake the flusher
            else:
                self._maybe_rotate()
                if self._seq - self._last_checkpoint_seq >= \
                        self._checkpoint_period:
                    self._checkpoint_locked()
        if getattr(self._deferred, "on", False):
            self._deferred.want = ticket
            return
        self._ensure_durable(ticket)

    def deferred_durability(self):
        import contextlib

        @contextlib.contextmanager
        def scope():
            prev = getattr(self._deferred, "on", False)
            # Nest-safe: an inner scope must not discard the outer scope's
            # accumulated flush obligation — entries journaled in the outer
            # scope before the inner one would otherwise be acknowledged
            # but never fsynced at outer-scope exit.
            prev_want = getattr(self._deferred, "want", 0)
            self._deferred.on = True
            self._deferred.want = prev_want
            try:
                yield
            finally:
                want = getattr(self._deferred, "want", 0)
                self._deferred.on = prev
                if prev:
                    self._deferred.want = max(want, prev_want)
                else:
                    self._deferred.want = 0  # don't seed later scopes
                    if want:
                        self._ensure_durable(want)

        return scope()

    def immediate_durability(self):
        import contextlib

        @contextlib.contextmanager
        def scope():
            prev = getattr(self._deferred, "on", False)
            self._deferred.on = False
            try:
                yield
            finally:
                self._deferred.on = prev

        return scope()

    def _ensure_durable(self, ticket: int) -> None:
        """Block until the batch holding ``ticket`` is fsync-durable.

        Group-commit mode: wait for the flusher to cover the ticket.
        Inline mode: one flusher syncs for the whole convoy — waiters
        that arrive while an fsync is in flight find their ticket
        already covered and return without issuing their own.  Tickets
        (assigned atomically with the write/acceptance) make coverage
        exact: a batch accepted after an fsync began can never be
        acknowledged by it."""
        if self._synced_ticket >= ticket:  # racy fast path: monotonic
            return
        if self._flusher is not None:
            with self._commit_cond:
                while self._synced_ticket < ticket:
                    if self._flush_error is not None:
                        raise JournalClosedError(
                            "journal flusher failed") from self._flush_error
                    if self._flusher is None or self._closed:
                        # stop() drains before closing; anything still
                        # uncovered here was never made durable
                        raise JournalClosedError("journal closed before "
                                                 "flush completed")
                    self._commit_cond.wait(0.5)
            return
        with self._flush_lock:
            with self._lock:
                if self._synced_ticket >= ticket:
                    return
                f = self._file
                if f is None:
                    # rotation/close fsyncs everything it closes
                    return
                f.flush()
                # tickets still sitting in the commit queue (one per
                # batch) are NOT in this file: an fsync here must never
                # cover them.  A caller whose own batch is among them
                # (flusher-shutdown race) must fail, not false-ack.
                target = self._write_ticket - len(self._commit_queue)
                if target < ticket:
                    raise JournalClosedError(
                        "journal flusher stopped with this batch "
                        "unwritten")
                fd = f.fileno()
            try:
                self._fsync(fd)
            except (OSError, ValueError):
                # the log rotated under us and closed this fd — rotation
                # fsyncs before closing, so our entries are durable
                with self._lock:
                    if self._synced_ticket >= ticket:
                        return
                    raise
            with self._lock:
                if target > self._synced_ticket:
                    self._synced_ticket = target

    # -- checkpoint ---------------------------------------------------------
    def checkpoint(self) -> None:
        with self._lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        snap = {
            "sequence": self._seq,
            "components": {name: comp.snapshot()
                           for name, comp in self._components.items()},
        }
        tmp = os.path.join(self._ckpt_dir,
                           f".tmp.{self._seq:016x}.{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(snap, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self._ckpt_dir, f"{self._seq:016x}.ckpt")
        os.rename(tmp, final)
        self._last_checkpoint_seq = self._seq
        # GC fully-covered closed segments (keep current.log)
        for seg in self._list_segments():
            if seg == ACTIVE_LOG:
                continue
            end = int(seg.split("-")[1].split(".")[0], 16)
            if end <= self._seq:
                try:
                    os.remove(os.path.join(self._log_dir, seg))
                except FileNotFoundError:
                    pass  # a standby's checkpoint GC'd it first
        # rotate the active log so the pre-checkpoint tail can be dropped too
        if self._file is not None:
            self._close_log()
            self._open_log()

    # -- standby mode (reference: standby masters tail the journal) ---------
    def standby_start(self) -> None:
        """Initial standby load: checkpoint + all durable segments, without
        opening a write log."""
        with self._lock:
            self.start()
            self._replay()

    def catch_up(self) -> int:
        """Apply entries newer than the local sequence (the tailer tick).
        Tolerates the primary's in-flight torn tail. STRICTLY contiguous:
        a sequence gap (e.g. the primary rotated the active log between
        our listdir and open, so we read the new log first) triggers a
        full rescan instead of silently skipping entries. Returns the
        number of entries applied."""
        applied = 0
        with self._lock:
            # a newer checkpoint than our state implies entries we can no
            # longer read from GC'd segments: reload from scratch
            ck = self._latest_checkpoint()
            if ck and int(ck.split(".")[0], 16) > self._seq:
                self._replay()
                return 0
            gap = False
            for seg in self._list_segments():
                path = os.path.join(self._log_dir, seg)
                try:
                    f = open(path, "rb")
                except FileNotFoundError:  # GC'd between list and open
                    continue
                with f:
                    for entry in JournalEntry.decode_stream(f):
                        if entry.sequence <= self._seq:
                            continue
                        if entry.sequence != self._seq + 1:
                            gap = True
                            break
                        self._apply(entry)
                        self._seq = entry.sequence
                        applied += 1
                if gap:
                    break
            if gap:
                # rotation raced the scan: rebuild deterministically
                self._replay()
        return applied

    def gain_primacy_from_standby(self) -> None:
        """Promotion for an already-tailing standby: finish the tail and
        open the write log — no state reset, so failover is O(tail), not
        O(snapshot) (reference: the standby's caught-up state serves)."""
        with self._lock:
            self.catch_up()
            self._open_log()
            self._primary = True

    def checkpoint_standby(self) -> None:
        """Checkpoint from standby state (no write log held). Shortens the
        primary-promotion replay (reference: checkpoint on standby)."""
        with self._lock:
            if self._primary:
                return
            self._checkpoint_locked()

    # -- backup / restore (reference: BackupLeaderRole.java:62 +
    # initFromBackup AlluxioMasterProcess.java:173-190) --------------------
    def write_backup(self, backup_dir: str) -> str:
        """Full metadata backup = one checkpoint-format file; returns its
        path. Safe on a live primary (state snapshot under the lock)."""
        os.makedirs(backup_dir, exist_ok=True)
        with self._lock:
            snap = {
                "sequence": self._seq,
                "components": {name: comp.snapshot()
                               for name, comp in self._components.items()},
            }
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(backup_dir,
                            f"atpu-backup-{stamp}-{snap['sequence']}.bak")
        n = 1
        while os.path.exists(path):  # same second + sequence: uniquify
            path = os.path.join(
                backup_dir,
                f"atpu-backup-{stamp}-{snap['sequence']}.{n}.bak")
            n += 1
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(snap, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        return path

    def init_from_backup(self, backup_path: str) -> bool:
        """Seed an EMPTY journal from a backup file: the backup becomes the
        initial checkpoint so the normal replay path restores it. Returns
        False (and does nothing) when the journal already has state."""
        self.start()
        if self._latest_checkpoint() is not None or any(
                self._list_segments()):
            return False
        with open(backup_path, "rb") as f:
            snap = msgpack.unpackb(f.read(), raw=False,
                                   strict_map_key=False)
        seq = int(snap["sequence"])
        tmp = os.path.join(self._ckpt_dir, ".tmp.restore")
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(snap, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self._ckpt_dir, f"{seq:016x}.ckpt"))
        return True

    # -- introspection ------------------------------------------------------
    @property
    def sequence(self) -> int:
        with self._lock:
            return self._seq

    @property
    def last_checkpoint_sequence(self) -> int:
        with self._lock:
            return self._last_checkpoint_seq


def create_journal_system(journal_type: str, folder: str, **kwargs) -> JournalSystem:
    """Factory keyed by ``atpu.master.journal.type``."""
    jt = journal_type.upper()
    if jt == "NOOP":
        return NoopJournalSystem()
    if jt in ("LOCAL", "UFS"):
        return LocalJournalSystem(folder, **kwargs)
    if jt == "EMBEDDED":
        try:
            from alluxio_tpu_torch.journal.raft import EmbeddedJournalSystem
        except ImportError as e:
            raise ValueError(
                "journal type EMBEDDED requires the replicated journal "
                "module (alluxio_tpu_torch.journal.raft); use LOCAL or UFS") from e
        return EmbeddedJournalSystem(folder, **kwargs)
    raise ValueError(f"unknown journal type {journal_type}")
