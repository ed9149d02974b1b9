"""Record decode ops: raw cached bytes -> model-ready batches.

The port of ``alluxio_tpu/ops/decode.py`` in plain PyTorch (no kernel
backs this module). The functions follow their input tensor's device.
The op order is the JAX package's, so the bf16 images and int32 labels
agree bit for bit with it: f32, ``/ 255.0``, ``(x - mean) / std``, bf16.

Record format: ``label(4B little-endian) || H*W*C uint8 pixels``.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_image_records(records: torch.Tensor, *, height: int, width: int,
                         channels: int = 3):
    """(batch, record_bytes) uint8 -> ((batch,H,W,C) bf16 normalized,
    int32 labels)."""
    b = records.to(torch.int32)
    # int32 shifts: byte 3 << 24 wraps into the sign bit, as in JAX
    labels = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    pixels = records[:, 4:4 + height * width * channels]
    imgs = pixels.reshape(-1, height, width, channels).to(torch.float32)
    imgs = imgs / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=records.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=records.device)
    imgs = (imgs - mean) / std
    return imgs.to(torch.bfloat16), labels


def image_record_bytes(height: int, width: int, channels: int = 3) -> int:
    return 4 + height * width * channels


def encode_image_records(images, labels) -> bytes:
    """Host-side encoder (writers and tests): the inverse of
    :func:`decode_image_records`."""
    images = np.asarray(images, dtype=np.uint8)
    labels = np.asarray(labels, dtype=np.int32)
    n = images.shape[0]
    flat = images.reshape(n, -1)
    out = np.empty((n, 4 + flat.shape[1]), dtype=np.uint8)
    out[:, :4] = labels.astype("<i4").view(np.uint8).reshape(n, 4)
    out[:, 4:] = flat
    return out.tobytes()


def sum_bytes(block: torch.Tensor) -> torch.Tensor:
    """Sum of a block's elements as uint32 with wraparound (a full
    device-side read of a cached block). ``torch.sum`` promotes integers
    to int64, so the result is masked to 32 bits: a 0-d int64 tensor in
    ``[0, 2**32)``."""
    return torch.sum(block.to(torch.int64)).bitwise_and_(0xFFFFFFFF)
