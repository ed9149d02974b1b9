"""The comparisons that decide ``correct``: each gives one number to
hold against its limit."""

from __future__ import annotations

import numpy as np

from benchmark.reference.decode import bf16_bits_to_f32


def image_gap(got_bits: np.ndarray, want_bits: np.ndarray) -> float:
    """Widest absolute gap between two bf16 images given as bit
    patterns; a shape that differs, or a NaN, is an infinite gap."""
    if got_bits.shape != want_bits.shape:
        return float("inf")
    if np.array_equal(got_bits, want_bits):
        return 0.0
    gap = np.abs(bf16_bits_to_f32(got_bits) - bf16_bits_to_f32(want_bits))
    if gap.size == 0:
        return 0.0
    worst = float(gap.max())
    return float("inf") if np.isnan(gap).any() else worst


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Positions that differ, counting every position one side lacks."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    n = min(got.size, want.size)
    return int((got[:n] != want[:n]).sum()) + abs(got.size - want.size)


def block_order(order: str, seed: int, epoch: int, n_blocks: int):
    """The blocks an epoch visits, as indices in static order: the file
    order, or for a shuffled job the permutation drawn from
    ``SeedSequence([seed, epoch])`` (the order the traffic states)."""
    if order == "static":
        return list(range(n_blocks))
    if order == "shuffled":
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return [int(i) for i in rng.permutation(n_blocks)]
    raise ValueError(f"unknown order {order!r}")
