#!/usr/bin/env python
"""The flagship path on the PyTorch port: cached record shards ->
device-resident batches -> a train epoch on the card.

The port's counterpart of ``examples/jax_training_pipeline.py``, step
for step, with the same sizes and seed (the reference's analogues are
``examples/.../Performance.java`` + ``MiniBenchmark.java`` read loops).
The consumer is a train loop, which is what this framework exists to
feed: the ``DeviceBlockLoader`` serves warm cache blocks as CUDA tensors
(kept in the card's memory across epochs), decoded on the card into
batches for a linear-softmax model trained with plain SGD
(``torch.optim.SGD(lr=1e-2)``, no momentum). Where the JAX example runs
an epoch as one scanned jit, this one runs a plain loop over the
batches, one optimizer step each.

    python examples/torch_training_pipeline.py [--master host:19998]
                                               [--device cpu]

Runs on the current CUDA card, and raises without one; ``--device cpu``
runs it on the CPU on purpose.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

# runnable from anywhere: the library lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import time


def run(fs, device: str = "cuda") -> list:
    """Trains for 3 epochs; returns each epoch's mean loss."""
    import numpy as np
    import torch

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.device import resolve_device
    from alluxio_tpu_torch.ops.decode import (
        decode_image_records, encode_image_records, image_record_bytes,
    )

    H = W = 32
    C = 3
    n_shards, recs_per_shard, batch = 2, 512, 64
    rec_bytes = image_record_bytes(H, W, C)
    rng = np.random.default_rng(0)

    # 1. ingest: record shards into the cache (a real pipeline mounts
    #    the dataset's UFS and distributedLoads instead)
    paths = []
    for s in range(n_shards):
        imgs = rng.integers(0, 255, (recs_per_shard, H, W, C), np.uint8)
        labels = rng.integers(0, 10, recs_per_shard, np.int32)
        p = f"/examples/shard-{s}"
        fs.write_all(p, encode_image_records(imgs, labels),
                     write_type=WriteType.MUST_CACHE)
        paths.append(p)
    print(f"cached {n_shards} shards x {recs_per_shard} records")

    # 2. device loader: warm blocks come back as tensors on the device
    #    and stay in its memory across epochs ("cuda": the current card)
    dev = resolve_device(None if device == "cuda" else device)
    loader = DeviceBlockLoader(fs, paths, device=dev, hbm_bytes=256 << 20)

    n_batches = (n_shards * recs_per_shard) // batch
    w = torch.zeros((H * W * C, 10), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((10,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    opt = torch.optim.SGD([w, b], lr=1e-2)

    def train_epoch(blocks):
        usable = recs_per_shard * rec_bytes
        recs = torch.cat(
            [blk[:usable] for blk in blocks]).reshape(-1, rec_bytes)
        recs = recs[:n_batches * batch].reshape(n_batches, batch,
                                                rec_bytes)
        losses = []
        for rb in recs:
            imgs, labels = decode_image_records(rb, height=H, width=W,
                                                channels=C)
            x = imgs.reshape(imgs.shape[0], -1).to(torch.float32)
            logits = x @ w + b
            loss = -torch.log_softmax(logits, dim=-1)[
                torch.arange(labels.shape[0], device=dev),
                labels.long()].mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    epoch_losses = []
    for epoch in range(3):
        t0 = time.monotonic()
        blocks = [blk for blk in loader.epoch()]  # device hits after ep 0
        loss = float(train_epoch(blocks))  # forces the epoch
        epoch_losses.append(loss)
        print(f"epoch {epoch}: loss {loss:.4f} in "
              f"{time.monotonic() - t0:.2f}s "
              f"({n_batches} batches, one optimizer step each)")
    print("loader HBM stats:", loader.hbm_stats())
    loader.close()
    return epoch_losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the current card; raises without one) or "
                    "cpu")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.master:
            from alluxio_tpu_torch.client.file_system import FileSystem

            fs = stack.enter_context(
                contextlib.closing(FileSystem(args.master)))
        else:
            from alluxio_tpu_torch.minicluster import LocalCluster

            d = stack.enter_context(tempfile.TemporaryDirectory())
            cluster = stack.enter_context(
                LocalCluster(d, num_workers=1,
                             block_size=8 << 20,
                             worker_mem_bytes=256 << 20))
            fs = stack.enter_context(
                contextlib.closing(cluster.file_system()))
        run(fs, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
