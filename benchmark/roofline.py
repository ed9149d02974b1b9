"""Published peaks of the card and the bytes each measured kernel must
move. A byte is counted once where it is read and once where it is
written, whatever implements the work, so a fused kernel is later
judged against the same work."""

from __future__ import annotations

#: NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s (at the full
#: 700 W power limit; every run prints the card's own limit)
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(batch: int, record_bytes: int, image_elems: int,
                 label_bytes: int = 4) -> int:
    """A batch of records read once, its bf16 images and int32 labels
    written once."""
    return batch * (record_bytes + 2 * image_elems + label_bytes)


def bound_s(nbytes: int) -> float:
    """The least time the card's memory can move ``nbytes`` in."""
    return nbytes / HBM_BYTES_PER_S
