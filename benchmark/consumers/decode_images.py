"""ResNet-50's input step: ``DeviceBlockLoader.epoch()`` through
``batched_device_iterator``, then ``ops.decode.decode_image_records`` on
every batch on the device.

Compared once the window has closed: the labels of every batch of the
window, exactly (copied batch by batch into slabs of pinned host
memory, so that what the checker keeps takes no device memory); for a
sample of batches drawn from the seed (a
reservoir of ``KEEP_IMAGES``), the record bytes the loader delivered,
exactly, and the bf16 images by their widest gap from the reference's;
and that every epoch that ended inside the window gave all its
batches. The sampled batches are copied, on the consumer's stream, into
host memory pinned at set-up, so the device holds the program's state
and not the checker's.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import compare, decode

#: see PERF.md for the readings each limit was set from
LIMITS = {"image_gap_max": 0.0625, "label_mismatches": 0,
          "record_mismatches": 0, "short_epochs": 0}
KEEP_IMAGES = 8
#: labels a slab of host memory holds
LABEL_SLAB = 1 << 18


class Consumer:
    dtype = np.uint8

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        cfg = ctx.cfg
        self.batch = cfg["batch_size"]
        self.shape = (cfg["height"], cfg["width"], cfg["channels"])
        self.rng = np.random.default_rng([ctx.seed, 1])
        self.labels = []   # (epoch, batch, slab, offset, n), every batch
        self.images = []   # (epoch, batch, rows), the reservoir's slots
        self._slots = self._host_slots(ctx.device)
        self._label_slabs = [self._label_slab()]
        self._label_at = 0
        self.seen = 0
        self.complete = {}  # epoch -> batches, for epochs that ended
        self.window_epochs = set()
        self._streams = {}

    def epoch(self, loader, e: int, wait, keep: bool):
        import torch

        from alluxio_tpu_torch.client.torch_io import batched_device_iterator
        from alluxio_tpu_torch.ops.decode import decode_image_records

        h, w, c = self.shape
        it = batched_device_iterator(
            loader, record_bytes=self.ctx.data.info["record_bytes"],
            batch_size=self.batch)
        if keep:
            self.window_epochs.add(e)
        j = 0
        try:
            for recs in wait(it):
                with torch.profiler.record_function("bench.decode"):
                    imgs, labels = decode_image_records(
                        recs, height=h, width=w, channels=c)
                if keep:
                    self._keep(e, j, imgs, labels, recs)
                j += 1
                yield recs.shape[0]
        finally:
            it.close()
        self.complete[e] = j

    def _host_slots(self, device):
        """``KEEP_IMAGES`` slots of host memory for the sampled batches'
        images (bf16) and records, pinned on the card's machine."""
        import torch

        pin = device.type == "cuda"
        rb = self.ctx.data.info["record_bytes"]
        return (torch.empty((KEEP_IMAGES, self.batch) + self.shape,
                            dtype=torch.bfloat16, pin_memory=pin),
                torch.empty((KEEP_IMAGES, self.batch, rb),
                            dtype=torch.uint8, pin_memory=pin))

    def _label_slab(self):
        import torch

        return torch.empty(LABEL_SLAB, dtype=torch.int32,
                           pin_memory=self.ctx.device.type == "cuda")

    def _keep(self, e, j, imgs, labels, recs) -> None:
        n = labels.shape[0]
        if self._label_at + n > LABEL_SLAB:
            self._label_slabs.append(self._label_slab())
            self._label_at = 0
        s = len(self._label_slabs) - 1
        self._label_slabs[s][self._label_at:self._label_at + n].copy_(
            labels.reshape(-1), non_blocking=True)
        self.labels.append((e, j, s, self._label_at, n))
        self._label_at += n
        if len(self.images) < KEEP_IMAGES:
            slot = len(self.images)
            self.images.append(None)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
        if slot < KEEP_IMAGES:
            # asynchronous on the current stream, after the decode: the
            # slot's previous copy is ordered before this one
            ni, nr = imgs.shape[0], recs.shape[0]
            self._slots[0][slot, :ni].copy_(imgs, non_blocking=True)
            self._slots[1][slot, :nr].copy_(recs, non_blocking=True)
            self.images[slot] = (e, j, ni, nr)
        self.seen += 1

    def finish(self) -> None:
        """Move what is kept to the host (after the window's sync, before
        the device is freed)."""
        import torch

        self.labels = [(e, j, self._label_slabs[s][o:o + n].numpy())
                       for e, j, s, o, n in self.labels]
        imgs, recs = self._slots
        self.images = [(e, j, imgs[s, :ni].view(torch.int16).numpy()
                        .view(np.uint16), recs[s, :nr].numpy())
                       for s, (e, j, ni, nr) in enumerate(self.images)]
        self._slots = None

    def _ids(self, e: int, j: int) -> np.ndarray:
        stream = self._stream(e)
        return stream[j * self.batch:(j + 1) * self.batch]

    def _stream(self, e: int) -> np.ndarray:
        """Record ids in the order epoch ``e`` delivers them."""
        if e not in self._streams:
            recs = self.ctx.data.info["records_of_block"]
            self._streams[e] = np.concatenate(
                [np.arange(recs[b][0], recs[b][0] + recs[b][1])
                 for b in self.ctx.block_order(e)])
        return self._streams[e]

    def epoch_batches(self, e: int) -> int:
        return self._stream(e).size // self.batch

    def check(self, control: bool = False):
        """``({name: (value, limit)}, answers checked, answers wrong)``.
        With ``control``, the reference in fp8 stands in for the
        program's outputs."""
        from benchmark.formats.image_records import label_table, rows

        ds, (h, w, c) = self.ctx.data, self.shape
        table = label_table(ds)
        label_bad = 0
        wrong = set()
        for e, j, got in self.labels:
            want = table[self._ids(e, j)]
            bad = compare.mismatches(want if control else got, want)
            label_bad += bad
            if bad:
                wrong.add((e, j))
        gap, rec_bad = 0.0, 0
        for e, j, got, delivered in self.images:
            recs = rows(ds, self._ids(e, j))
            bad = compare.mismatches(delivered, recs)
            rec_bad += bad
            if bad:
                wrong.add((e, j))
            want, _ = decode.decode(recs, h, w, c)
            if control:
                got, _ = decode.decode_fp8(recs, h, w, c)
            g = compare.image_gap(got.reshape(want.shape)
                                  if got.size == want.size else got, want)
            gap = max(gap, g)
            if g > LIMITS["image_gap_max"]:
                wrong.add((e, j))
        short = sum(1 for e, n in self.complete.items()
                    if e in self.window_epochs
                    and n != self.epoch_batches(e))
        checks = {"image_gap_max": (gap, LIMITS["image_gap_max"]),
                  "label_mismatches": (label_bad,
                                       LIMITS["label_mismatches"]),
                  "record_mismatches": (rec_bad,
                                        LIMITS["record_mismatches"]),
                  "short_epochs": (short, LIMITS["short_epochs"])}
        return checks, len(self.labels), len(wrong)
