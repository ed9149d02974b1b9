"""The port's record decode against the JAX package's.

Labels are compared exactly and bf16 images bit for bit (tolerance 0):
both packages run the same op order in float32 before the bf16 cast.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from alluxio_tpu.ops import decode as jax_decode  # noqa: E402
from alluxio_tpu_torch.ops import decode  # noqa: E402


def _bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_image_record_round_trip():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8)
    labels = np.array([3, 1, 4, 999], dtype=np.int32)
    blob = decode.encode_image_records(imgs, labels)
    assert blob == jax_decode.encode_image_records(imgs, labels)
    rb = decode.image_record_bytes(8, 8, 3)
    assert rb == jax_decode.image_record_bytes(8, 8, 3)
    records = torch.frombuffer(bytearray(blob), dtype=torch.uint8) \
        .reshape(4, rb)
    out, out_labels = decode.decode_image_records(records, height=8,
                                                  width=8)
    assert out.shape == (4, 8, 8, 3)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out_labels.numpy(), labels)


@pytest.mark.parametrize("shape", [(16, 8, 8, 3), (5, 4, 6, 1)])
def test_decode_matches_jax_bit_for_bit(shape):
    n, h, w, c = shape
    rng = np.random.default_rng(n * 100 + c)
    imgs = rng.integers(0, 256, size=shape, dtype=np.uint8)
    # labels >= 2^24 and negative ones exercise the byte-3 shift
    labels = rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)
    labels[:3] = [2**24, 2**31 - 1, -1][:min(3, n)]
    blob = np.frombuffer(jax_decode.encode_image_records(imgs, labels),
                         dtype=np.uint8).reshape(n, -1)
    want_imgs, want_labels = jax_decode.decode_image_records(
        jnp.asarray(blob), height=h, width=w, channels=c)
    got_imgs, got_labels = decode.decode_image_records(
        torch.from_numpy(blob.copy()), height=h, width=w, channels=c)
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    np.testing.assert_array_equal(labels, got_labels.numpy())
    np.testing.assert_array_equal(
        _bf16_bits(got_imgs),
        np.asarray(want_imgs).view(np.uint16))


def test_sum_bytes_wraps_like_uint32():
    # int32 block whose uint32 sum exceeds 2^32: exact mod-2^32 agreement
    x = np.full(4096, -1, dtype=np.int32)
    x[:7] = 2**31 - 1
    want = int(jax_decode.sum_bytes(jnp.asarray(x)))
    got = int(decode.sum_bytes(torch.from_numpy(x)))
    assert got == want
    u8 = np.random.default_rng(1).integers(0, 256, size=100_000,
                                           dtype=np.uint8)
    assert int(decode.sum_bytes(torch.from_numpy(u8))) == \
        int(jax_decode.sum_bytes(jnp.asarray(u8)))
