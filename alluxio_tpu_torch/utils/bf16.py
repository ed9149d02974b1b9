"""bf16 between torch and numpy without ``ml_dtypes``.

numpy has no bf16, so a bf16 tensor crosses as its raw 16-bit words: a
``uint16`` array (or an ``ml_dtypes.bfloat16`` array, which has the same
words) is reinterpreted, never converted through float.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as a C-order numpy array on the host; bf16 as its
    ``uint16`` words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def numpy_to_tensor(arr, *, bf16: bool = False) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr``; with ``bf16``, ``arr``'s
    16-bit words read as bf16."""
    arr = np.array(arr, order="C")  # a copy; keeps a 0-d shape
    if bf16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bf16 words must be 16-bit, not {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its element size, so that
    ``torch.equal`` compares bit patterns (NaNs and signed zeros too)."""
    if t.dtype.is_floating_point:
        return t.view(_INT_OF_SIZE[t.element_size()])
    return t
