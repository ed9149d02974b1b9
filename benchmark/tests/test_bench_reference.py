"""The NumPy reference agrees with the port's decode on the CPU, int32
wraparound of the labels included, and the control does not."""

import numpy as np
import pytest
import torch

from alluxio_tpu_torch.ops.decode import decode_image_records
from alluxio_tpu_torch.prefetch.oracle import (AccessOracle, BlockRef,
                                               DatasetManifest)
from benchmark.reference import compare, decode


def _records(seed, n=12, h=5, w=7, c=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (n, 4 + h * w * c), dtype=np.uint8)
    # labels over the whole int32 range, the sign bit included
    rows[:, :4] = rng.integers(-2**31, 2**31, n, dtype=np.int64) \
        .astype("<i4").view(np.uint8).reshape(n, 4)
    return rows, (h, w, c)


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 9])
def test_decode_matches_the_port_bit_for_bit(seed):
    rows, (h, w, c) = _records(seed)
    imgs, labels = decode_image_records(torch.from_numpy(rows), height=h,
                                        width=w, channels=c)
    want_bits, want_labels = decode.decode(rows, h, w, c)
    got_bits = imgs.view(torch.int16).numpy().view(np.uint16)
    assert compare.image_gap(got_bits, want_bits) == 0.0
    assert compare.mismatches(labels.numpy(), want_labels) == 0
    assert (want_labels < 0).any()
    plain = decode.to_bf16_bits(decode.normalised(rows, h, w, c))
    assert np.array_equal(plain, want_bits)


def test_the_fp8_control_fails_the_image_limit():
    from benchmark import harness

    limit = harness.plugin("consumers", "decode_images").LIMITS[
        "image_gap_max"]
    rows, (h, w, c) = _records(3, n=64)
    want, _ = decode.decode(rows, h, w, c)
    ctrl, _ = decode.decode_fp8(rows, h, w, c)
    assert compare.image_gap(ctrl, want) > limit


def test_round_mantissa_is_nearest_even():
    x = np.array([1.0, 1.0625, 1.125, 1.1875, 2.3, -0.7], dtype=np.float32)
    got = decode.round_mantissa(x, 3)
    assert got.tolist() == pytest.approx([1.0, 1.0, 1.125, 1.25, 2.25,
                                          -0.6875])


def test_shuffled_order_is_the_oracles():
    n = 21
    blocks = tuple(BlockRef(path=f"/f{i}", block_index=0, block_id=100 + i,
                            length=1) for i in range(n))
    oracle = AccessOracle(DatasetManifest(blocks=blocks), 2**31 + 3)
    for epoch in range(4):
        want = [r.block_id - 100 for r in oracle.epoch_sequence(epoch)]
        assert compare.block_order("shuffled", 2**31 + 3, epoch, n) == want
    assert compare.block_order("static", 1, 0, n) == list(range(n))


def test_mismatches_count_missing_positions():
    assert compare.mismatches(np.arange(5), np.arange(7)) == 2
    assert compare.mismatches(np.array([1, 2, 9]), np.array([1, 2, 3])) == 1
