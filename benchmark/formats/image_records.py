"""Fixed-size image records: ``label (4 B little-endian) || H*W*C uint8``.

Records never straddle a block: a block holds ``block // record`` whole
records and zero padding after them, and the last block of a file ends
with its last record. Record ids run through the files in static order.
"""

from __future__ import annotations

import numpy as np

from benchmark.dataset import Block, Dataset


def make(cfg: dict, seed: int, device) -> Dataset:
    import torch

    rb = cfg["stored_record_bytes"]
    if rb != cfg["label_bytes"] + cfg["height"] * cfg["width"] * cfg["channels"]:
        raise ValueError("stored_record_bytes is not the label and the image")
    block = cfg["block_size_bytes"]
    per_block = block // rb
    n = cfg["num_samples_per_file"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    paths, host, blocks, records = [], [], [], []
    rid = 0
    for f in range(cfg["num_files_train"]):
        recs = torch.randint(0, 256, (n, rb), dtype=torch.uint8,
                             generator=gen, device=device)
        labels = torch.randint(0, cfg["num_classes"], (n,), dtype=torch.int32,
                               generator=gen, device=device)
        recs[:, :4] = labels.view(torch.uint8).reshape(n, 4)
        nblk = -(-n // per_block)
        size = (nblk - 1) * block + (n - (nblk - 1) * per_block) * rb
        buf = torch.zeros(size, dtype=torch.uint8, device=device)
        for b in range(nblk):
            k = min(per_block, n - b * per_block)
            buf[b * block:b * block + k * rb] = \
                recs[b * per_block:b * per_block + k].reshape(-1)
            blocks.append(Block(f, b, b * block, min(block, size - b * block)))
            records.append((rid, k))
            rid += k
        paths.append(f"/bench/{cfg['name']}/part-{f:05d}")
        host.append(buf.cpu().numpy())
        del recs, labels, buf
    return Dataset(paths, host, blocks,
                   {"record_bytes": rb, "records_of_block": records,
                    "per_block": per_block, "per_file": n,
                    "block_size": block})


def rows(ds: Dataset, ids) -> np.ndarray:
    """The stored records of the given ids, as ``(len(ids), record_bytes)``."""
    info = ds.info
    rb, per_block, n = info["record_bytes"], info["per_block"], info["per_file"]
    out = np.empty((len(ids), rb), dtype=np.uint8)
    for i, rid in enumerate(ids):
        f, j = divmod(int(rid), n)
        b, k = divmod(j, per_block)
        off = b * info["block_size"] + k * rb
        out[i] = ds.host[f][off:off + rb]
    return out


def label_table(ds: Dataset) -> np.ndarray:
    """The label of every record id, read from the stored bytes."""
    from benchmark.reference.decode import labels

    rb = ds.info["record_bytes"]
    out = []
    for blk, (_rid, k) in zip(ds.blocks, ds.info["records_of_block"]):
        raw = ds.host[blk.file][blk.offset:blk.offset + k * rb]
        out.append(labels(raw.reshape(k, rb)))
    return np.concatenate(out)
