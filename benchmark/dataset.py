"""The generated dataset of one run: file bytes on the host, the block
layout in static order, and what the format needs to name each block's
contents. Both the program (through the cluster) and the reference
read these same bytes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class Block:
    """One block of one file, in the dataset's static order."""

    file: int
    index: int
    offset: int
    length: int


@dataclass
class Dataset:
    paths: List[str]
    host: List[np.ndarray]
    blocks: List[Block]
    #: format-specific layout (record ids of each block, sample of each block)
    info: Dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.host)

    def block_bytes(self, i: int) -> np.ndarray:
        b = self.blocks[i]
        return self.host[b.file][b.offset:b.offset + b.length]


def file_blocks(file: int, size: int, block_size: int) -> List[Block]:
    """The blocks a file of ``size`` bytes is cut into."""
    return [Block(file, i, off, min(block_size, size - off))
            for i, off in enumerate(range(0, size, block_size))]
