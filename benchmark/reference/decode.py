"""Record decode: ``label(4 B LE) || H*W*C uint8`` -> bf16 normalised
image (``x / 255``, ``(x - mean) / std`` in float32, then bf16 rounded to
nearest even) and the int32 label."""

from __future__ import annotations

import numpy as np

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalised(rows: np.ndarray, height: int, width: int,
               channels: int) -> np.ndarray:
    """float32 images of ``(B, record_bytes)`` uint8 records."""
    x = rows[:, 4:4 + height * width * channels].reshape(
        -1, height, width, channels).astype(np.float32)
    x = x / np.float32(255.0)
    return (x - MEAN[:channels]) / STD[:channels]


def labels(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows[:, :4]).view("<i4").reshape(-1)


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (uint16), rounded to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u >> np.uint32(16)).astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def round_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """float32 rounded to ``bits`` explicit mantissa bits, nearest even:
    3 is fp8 e4m3's mantissa (the range of a normalised image is inside
    e4m3's normal range)."""
    drop = np.uint32(23 - bits)
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    half = np.uint32((1 << (23 - bits - 1)) - 1)
    u = u + half + ((u >> drop) & np.uint32(1))
    return ((u >> drop) << drop).view(np.float32)


def _lookup(rows: np.ndarray, height: int, width: int, channels: int,
            table: np.ndarray) -> np.ndarray:
    """Each pixel byte through its channel's column of ``table``."""
    pix = rows[:, 4:4 + height * width * channels].reshape(
        -1, height, width, channels)
    out = np.empty(pix.shape, dtype=table.dtype)
    for ch in range(channels):
        np.take(table[:, ch], pix[..., ch], out=out[..., ch])
    return out


def _table(channels: int, fp8: bool) -> np.ndarray:
    """``(256, channels)`` bf16 bits of every byte value: the decode is a
    function of a byte and its channel alone, so applying
    :func:`normalised` to every byte value once and looking the pixels up
    gives the same bits as applying it to every pixel."""
    every = np.repeat(np.arange(256, dtype=np.uint8), channels)
    rows = np.concatenate([np.zeros(4, np.uint8), every])[None, :]
    img = normalised(rows, 256, 1, channels).reshape(256, channels)
    return to_bf16_bits(round_mantissa(img, 3) if fp8 else img)


def decode(rows: np.ndarray, height: int, width: int, channels: int):
    """(bf16 bits ``(B, H, W, C)``, int32 labels ``(B,)``)."""
    return (_lookup(rows, height, width, channels, _table(channels, False)),
            labels(rows))


def decode_fp8(rows: np.ndarray, height: int, width: int, channels: int):
    """The control: the same decode with the image rounded through fp8
    (e4m3's 3 mantissa bits) before bf16."""
    return (_lookup(rows, height, width, channels, _table(channels, True)),
            labels(rows))
