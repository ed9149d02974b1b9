"""Offline journal migration: LOCAL/UFS WAL <-> embedded Raft quorum (a
copy of ``alluxio_tpu/journal/migrate.py``; its output is the JAX
package's byte for byte).

Re-design of ``core/server/common/src/main/java/alluxio/master/journal/
JournalUpgrader.java:61`` + the flow proven by
``tests/.../ft/journal/JournalMigrationIntegrationTest.java``: an
operator on the single-writer LOCAL (or shared-UFS) journal adopts an HA
Raft quorum — or backs out of one — WITHOUT replaying through live
masters. The migration is entry-level:

  LOCAL -> EMBEDDED
    checkpoint        -> per-member Raft snapshot  (state as-is)
    segment entries   -> Raft log records at term 1 (applied by the
                         real masters when the quorum first boots)
  EMBEDDED -> LOCAL
    latest snapshot   -> LOCAL checkpoint
    log entries past it -> one closed LOCAL segment

Both layouts carry a ``VERSION`` marker file (the reference tracks
journal layout versions via the v0/v1 folder structure; a frame-header
version would break every existing log + the native scanner, so the
folder-level marker is the compatible equivalent). The tool refuses to
migrate formats newer than it understands.

Offline means offline: run with every master stopped. The LOCAL reader
uses the same torn-tail-tolerant scan as recovery, so an unclean
shutdown migrates exactly what a restart would have recovered.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import msgpack

from alluxio_tpu_torch.journal.format import JournalEntry
from alluxio_tpu_torch.journal.system import (
    CKPT_DIR, LOG_DIR, latest_checkpoint_name, sorted_segments,
)

FORMAT_VERSION = 1
_VERSION_FILE = "VERSION"

#: entries per Raft record written during migration (a record is one
#: group-commit batch; bounding it keeps single frames small)
_BATCH = 512


class MigrationError(Exception):
    pass


def _read_version(folder: str) -> int:
    try:
        with open(os.path.join(folder, _VERSION_FILE)) as f:
            return int(f.read().strip() or 1)
    except (FileNotFoundError, ValueError):
        return 1  # pre-marker folders are format 1

def _write_version(folder: str) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, _VERSION_FILE), "w") as f:
        f.write(f"{FORMAT_VERSION}\n")


def _check_version(folder: str) -> None:
    v = _read_version(folder)
    if v > FORMAT_VERSION:
        raise MigrationError(
            f"journal at {folder} is format v{v}; this tool understands "
            f"up to v{FORMAT_VERSION} — upgrade the software first")


# ---------------------------------------------------------------- readers
def read_local_state(local_folder: str) -> Tuple[
        Optional[dict], int, List[JournalEntry]]:
    """-> (checkpoint components | None, checkpoint seq, tail entries)."""
    _check_version(local_folder)
    ckpt_dir = os.path.join(local_folder, CKPT_DIR)
    log_dir = os.path.join(local_folder, LOG_DIR)
    comps: Optional[dict] = None
    start_seq = 0
    ck = latest_checkpoint_name(ckpt_dir)
    if ck:
        with open(os.path.join(ckpt_dir, ck), "rb") as f:
            snap = msgpack.unpackb(f.read(), raw=False,
                                   strict_map_key=False)
        comps = snap["components"]
        start_seq = snap["sequence"]
    entries: List[JournalEntry] = []
    for seg in sorted_segments(log_dir):
        with open(os.path.join(log_dir, seg), "rb") as f:
            for entry in JournalEntry.decode_stream(f):
                if entry.sequence > start_seq:
                    entries.append(entry)
    entries.sort(key=lambda e: e.sequence)
    return comps, start_seq, entries


def read_embedded_state(raft_folder: str, node_id: str) -> Tuple[
        Optional[dict], int, List[JournalEntry]]:
    """-> (snapshot components | None, snapshot seq, tail entries) for
    one quorum member's directory."""
    _check_version(raft_folder)
    node_dir = os.path.join(raft_folder, "raft", node_id)
    if not os.path.isdir(node_dir):
        raise MigrationError(f"no raft member state at {node_dir}")
    comps: Optional[dict] = None
    snap_seq = 0
    snap_dir = os.path.join(node_dir, "snapshots")
    if os.path.isdir(snap_dir):
        snaps = [f for f in os.listdir(snap_dir) if f.endswith(".snap")]
        if snaps:
            latest = max(snaps, key=lambda f: int(
                f.split("_")[1].split(".")[0], 16))
            with open(os.path.join(snap_dir, latest), "rb") as f:
                snap = msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False)
            comps, snap_seq = snap["components"], snap["seq"]
    entries: List[JournalEntry] = []
    log_path = os.path.join(node_dir, "log.bin")
    if os.path.exists(log_path):
        from alluxio_tpu_torch.journal.format import iter_frames, map_or_read

        with open(log_path, "rb") as f:
            data = map_or_read(f)
            for off, length in iter_frames(data):
                rec = msgpack.unpackb(bytes(data[off:off + length]),
                                      raw=False, strict_map_key=False)
                for seq, etype, payload in rec[2]:
                    if seq > snap_seq:
                        entries.append(JournalEntry(seq, etype, payload))
            if hasattr(data, "close"):
                data.close()
    entries.sort(key=lambda e: e.sequence)
    return comps, snap_seq, entries


def members_of(raft_folder: str) -> List[str]:
    d = os.path.join(raft_folder, "raft")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def freshest_member(raft_folder: str) -> str:
    """Pick the member with the highest (snapshot seq, last entry seq)."""
    best, best_key = "", (-1, -1)
    for m in members_of(raft_folder):
        try:
            _, snap_seq, entries = read_embedded_state(raft_folder, m)
        except MigrationError:
            continue
        key = (snap_seq, entries[-1].sequence if entries else snap_seq)
        if key > best_key:
            best, best_key = m, key
    if not best:
        raise MigrationError(f"no readable raft member under {raft_folder}")
    return best


# ---------------------------------------------------------------- writers
def _fsync_write(path: str, blob: bytes) -> None:
    tmp = path + ".migtmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_embedded_member(raft_folder: str, node_id: str,
                          comps: Optional[dict], snap_seq: int,
                          entries: List[JournalEntry]) -> None:
    """Materialize one quorum member's directory: snapshot + log at
    term 1. The member dirs are byte-identical across the quorum, which
    is a valid Raft state (all logs match; first election proceeds
    normally)."""
    node_dir = os.path.join(raft_folder, "raft", node_id)
    os.makedirs(node_dir, exist_ok=True)
    base_index = 0
    if comps is not None and snap_seq > 0:
        snap_dir = os.path.join(node_dir, "snapshots")
        os.makedirs(snap_dir, exist_ok=True)
        base_index = snap_seq  # any positive base works; seq is natural
        blob = msgpack.packb(
            {"term": 1, "index": base_index, "seq": snap_seq,
             "components": comps}, use_bin_type=True)
        _fsync_write(os.path.join(
            snap_dir, f"{1:08x}_{base_index:016x}.snap"), blob)
    # log records: one batch per _BATCH entries, indices base+1..
    import struct
    import zlib

    frames = bytearray()
    index = base_index
    for i in range(0, len(entries), _BATCH):
        batch = entries[i:i + _BATCH]
        index += 1
        body = msgpack.packb(
            [1, index, [[e.sequence, e.type, e.payload] for e in batch]],
            use_bin_type=True)
        frames += struct.pack("<II", len(body), zlib.crc32(body)) + body
    if frames:
        _fsync_write(os.path.join(node_dir, "log.bin"), bytes(frames))
    _fsync_write(os.path.join(node_dir, "meta.bin"), msgpack.packb(
        {"term": 1, "voted_for": None, "start_index": base_index + 1},
        use_bin_type=True))


def local_to_embedded(local_folder: str, raft_folder: str,
                      addresses: List[str]) -> dict:
    """LOCAL/UFS journal -> a fresh Raft quorum's initial state."""
    if not addresses:
        raise MigrationError("need the quorum member addresses "
                             "(atpu.master.embedded.journal.addresses)")
    for m in members_of(raft_folder):
        raise MigrationError(
            f"raft state already exists at {raft_folder}/raft/{m}; "
            f"refusing to overwrite a quorum")
    comps, snap_seq, entries = read_local_state(local_folder)
    if comps is None and not entries:
        raise MigrationError(f"nothing to migrate in {local_folder}")
    if comps is not None and snap_seq <= 0:
        # a checkpoint at sequence 0 cannot become a Raft snapshot
        # (index 0 means "none") and its covered segments may be GC'd —
        # never risk silently dropping it
        raise MigrationError(
            f"checkpoint at {local_folder} has sequence {snap_seq}; "
            f"cannot anchor a Raft snapshot — take a fresh checkpoint "
            f"on the source journal first")
    for addr in addresses:
        write_embedded_member(raft_folder, addr, comps, snap_seq, entries)
    _write_version(raft_folder)
    return {"members": list(addresses), "checkpoint_seq": snap_seq,
            "entries": len(entries)}


def embedded_to_local(raft_folder: str, local_folder: str,
                      node_id: str = "") -> dict:
    """One quorum member's state -> a LOCAL/UFS journal folder."""
    node_id = node_id or freshest_member(raft_folder)
    comps, snap_seq, entries = read_embedded_state(raft_folder, node_id)
    ckpt_dir = os.path.join(local_folder, CKPT_DIR)
    log_dir = os.path.join(local_folder, LOG_DIR)
    if latest_checkpoint_name(ckpt_dir) or sorted_segments(log_dir):
        raise MigrationError(
            f"{local_folder} already holds journal state; refusing to "
            f"overwrite")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    if comps is not None and snap_seq > 0:
        _fsync_write(
            os.path.join(ckpt_dir, f"{snap_seq:016x}.ckpt"),
            msgpack.packb({"sequence": snap_seq, "components": comps},
                          use_bin_type=True))
    if entries:
        blob = bytearray()
        for e in entries:
            blob += e.encode()
        first, last = entries[0].sequence, entries[-1].sequence
        _fsync_write(os.path.join(log_dir, f"{first:016x}-{last:016x}.log"),
                     bytes(blob))
    _write_version(local_folder)
    return {"source_member": node_id, "checkpoint_seq": snap_seq,
            "entries": len(entries)}
