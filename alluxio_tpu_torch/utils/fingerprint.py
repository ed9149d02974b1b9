"""UFS fingerprints for metadata sync (a copy of
``alluxio_tpu/utils/fingerprint.py``).

Re-design of ``core/common/src/main/java/alluxio/underfs/Fingerprint.java``:
a fingerprint captures the identity-bearing attributes of a UFS entry
(type, content hash/etag, length, mtime, owner/group/mode). Metadata sync
compares the stored fingerprint with a fresh one to decide whether the
inode must be re-synced, split into *metadata* changes (owner/mode) vs
*content* changes (hash/length).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

INVALID = "INVALID"


@dataclass(frozen=True)
class Fingerprint:
    kind: str = INVALID  # "FILE" | "DIRECTORY" | INVALID
    content_hash: str = "_"
    length: int = -1
    owner: str = "_"
    group: str = "_"
    mode: int = -1

    @staticmethod
    def invalid() -> "Fingerprint":
        return Fingerprint()

    @staticmethod
    def from_status(status) -> "Fingerprint":
        """Build from a ``UfsStatus`` (see ``underfs/base.py``)."""
        if status is None:
            return Fingerprint.invalid()
        return Fingerprint(
            kind="DIRECTORY" if status.is_directory else "FILE",
            content_hash=status.content_hash or str(status.last_modified_ms or "_"),
            length=status.length if not status.is_directory else -1,
            owner=status.owner or "_",
            group=status.group or "_",
            mode=status.mode if status.mode is not None else -1,
        )

    def is_valid(self) -> bool:
        return self.kind != INVALID

    def serialize(self) -> str:
        return (f"kind={self.kind}|hash={self.content_hash}|len={self.length}"
                f"|owner={self.owner}|group={self.group}|mode={self.mode}")

    @staticmethod
    def parse(s: Optional[str]) -> "Fingerprint":
        if not s:
            return Fingerprint.invalid()
        parts = dict(p.split("=", 1) for p in s.split("|") if "=" in p)
        try:
            return Fingerprint(
                kind=parts.get("kind", INVALID),
                content_hash=parts.get("hash", "_"),
                length=int(parts.get("len", -1)),
                owner=parts.get("owner", "_"),
                group=parts.get("group", "_"),
                mode=int(parts.get("mode", -1)),
            )
        except ValueError:
            return Fingerprint.invalid()

    def matches_content(self, other: "Fingerprint") -> bool:
        return (self.kind == other.kind
                and self.content_hash == other.content_hash
                and self.length == other.length)

    def matches_metadata(self, other: "Fingerprint") -> bool:
        return (self.owner == other.owner and self.group == other.group
                and self.mode == other.mode)

    def matches(self, other: "Fingerprint") -> bool:
        return self.matches_content(other) and self.matches_metadata(other)
