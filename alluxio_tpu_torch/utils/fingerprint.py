"""UFS fingerprints: the part of ``alluxio_tpu/utils/fingerprint.py``
that the worker's ``persist_file`` returns (reference:
``underfs/Fingerprint.java``) — the same serialized string."""

from __future__ import annotations

from dataclasses import dataclass

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
    def from_status(status) -> "Fingerprint":
        """Build from a ``UfsStatus`` (see ``underfs/base.py``)."""
        if status is None:
            return Fingerprint()
        return Fingerprint(
            kind="DIRECTORY" if status.is_directory else "FILE",
            content_hash=status.content_hash
            or str(status.last_modified_ms or "_"),
            length=status.length if not status.is_directory else -1,
            owner=status.owner or "_",
            group=status.group or "_",
            mode=status.mode if status.mode is not None else -1,
        )

    def serialize(self) -> str:
        return (f"kind={self.kind}|hash={self.content_hash}|len={self.length}"
                f"|owner={self.owner}|group={self.group}|mode={self.mode}")
