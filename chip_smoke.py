#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alluxio_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``alluxio_tpu_torch/ops/csrc``
with ``nvcc`` (into ``build/torch_kernels/``), then:

1. kernel phase: ``scaled_sum`` against its plain PyTorch version on the
   card, for exact equality, at every calibration size, ``7*512*1024``
   and the 2 GiB working set, with scales 1, 3, -2 and an int32
   wraparound case; CUDA-event times of the kernel, the plain version and
   two one-call full reads of the same bytes (``torch.sum`` to int64, and
   a float32 sum) at 2 GiB;
2. main path: 64 shards x 32 MiB laid out as block files, served through
   the port's ``LocalBlockInStream`` to its ``DeviceBlockLoader``; epoch 1
   moves them host -> device, epoch 2 must be all device-tier hits; then
   ``K`` chained ``scaled_sum`` calls over the device-resident set (the
   warm-tier scan), checked against the same chain on the plain version;
3. decode: four 32 MiB blocks of 64x64x3 records through
   ``batched_device_iterator`` and ``decode_image_records`` on the card,
   checked bit for bit against the same decode on the CPU.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. Without a CUDA card, or without the repository beside it, it
exits non-zero and prints no result. All data is made from a seed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016

BLOCK_BYTES = 32 << 20   # bench.py's shard size
NUM_BLOCKS = 64          # 64 x 32 MiB = the 2 GiB device working set
K = 100                  # chained warm-tier scans on the main path
DECODE_BLOCKS = 4
H = W = 64
C = 3
BATCH = 128

#: H100 SXM peaks (NVIDIA's data sheet): device-memory rate, and the
#: CUDA-core rate (67 TFLOP/s float32; the table has no int32 entry, so
#: the kernel's integer multiply-adds are held against it)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_int32(n: int, gen, device):
    import torch

    return torch.empty(n, dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)


# -- set-up -------------------------------------------------------------------
def setup() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for mod in ("grpc", "msgpack"):
        print(f"importable {mod}: "
              f"{importlib.util.find_spec(mod) is not None}", flush=True)

    from alluxio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in sorted(_build.build_log.items()):
        print(f"--- nvcc {name}.cu ---\n{log.strip()}", file=sys.stderr)


# -- kernel phase -------------------------------------------------------------
def kernel_phase(device, big_n: int) -> dict:
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    sizes = [r * rk._LANES for r in rk.CALIBRATION_ROWS]
    sizes += [7 * 512 * rk._LANES, big_n]
    max_err = 0
    big = None
    for n in sizes:
        x = random_int32(n, gen, device)
        for scale in (1, 3, -2):
            s = torch.tensor([scale], dtype=torch.int32, device=device)
            got = int(rk.scaled_sum(x, s))
            want = int(rk.scaled_sum_reference(x, s))
            max_err = max(max_err, abs(got - want))
            if got != want:
                fail(f"scaled_sum n={n} scale={scale}: kernel {got} != "
                     f"plain {want}")
        if n == big_n:
            big = x
        else:
            del x
    wrap = torch.full((512 * rk._LANES,), 2**30, dtype=torch.int32,
                      device=device)
    got = int(rk.scaled_sum(wrap, 3))
    want = int(rk.scaled_sum_reference(wrap, 3))
    max_err = max(max_err, abs(got - want))
    if got != want:
        fail(f"scaled_sum wraparound: kernel {got} != plain {want}")
    print(f"kernel phase: {len(sizes) * 3 + 1} comparisons exact "
          f"(sizes {sizes})", flush=True)

    s = torch.tensor([3], dtype=torch.int32, device=device)
    kernel_ms = time_ms(lambda: rk.scaled_sum(big, s), reps=20)
    plain_ms = time_ms(lambda: rk.scaled_sum_reference(big, s), reps=3,
                       warmup=1)
    # two one-call full reads of the same bytes: PyTorch's int64 sum (the
    # integer reduction it has) and a float32 sum over the same bits
    # (its tuned reduction path; the value is meaningless)
    ceiling_ms = time_ms(lambda: torch.sum(big, dtype=torch.int64),
                         reps=20)
    float_ms = time_ms(lambda: big.view(torch.float32).sum(), reps=20)
    nbytes = big.numel() * 4 + 4 + 4  # x, scale, out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * big.numel() / CORE_OPS_PER_S * 1e3
    print(f"scaled_sum at {big.numel() * 4 / 2**30:.3f} GiB: kernel "
          f"{kernel_ms:.4f} ms ({big.numel() * 4 / kernel_ms / 1e6:.1f} "
          f"GB/s), plain {plain_ms:.4f} ms, int64 sum {ceiling_ms:.4f} "
          f"ms, float32 sum {float_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "read_ceiling_ms": ceiling_ms, "float_sum_ms": float_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# -- the worker stand-in ------------------------------------------------------
class ShardSource:
    """Stands in for a same-host worker until the cluster client is
    ported: each path is one block file, read by short circuit."""

    def __init__(self, files: dict) -> None:
        self._files = files  # path -> (file id, block file)

    def get_status(self, path):
        fid, _ = self._files[path]
        return SimpleNamespace(file_id=fid, block_ids=[fid << 24])

    def open_file(self, path, info=None, max_open_streams=1):
        return _ShardFile(self._files[path][1])


class _ShardFile:
    def __init__(self, block_file: str) -> None:
        self._block_file = block_file
        self._stream = None

    def block_stream(self, index: int):
        from alluxio_tpu_torch.client.block_streams import LocalBlockInStream

        if index != 0:
            fail(f"shard files hold one block, asked for {index}")
        if self._stream is None:
            self._stream = LocalBlockInStream(
                self._block_file, os.path.getsize(self._block_file))
        return self._stream

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def block_dir(need_bytes: int) -> str:
    shm = Path("/dev/shm")
    if shm.is_dir():
        st = os.statvfs(shm)
        if st.f_bavail * st.f_frsize > need_bytes + (256 << 20):
            return tempfile.mkdtemp(prefix="atpu-torch-smoke-", dir=shm)
    return tempfile.mkdtemp(prefix="atpu-torch-smoke-")


# -- main path ----------------------------------------------------------------
def main_path(device, workdir: str, num_blocks: int, block_bytes: int,
              k: int) -> int:
    """Drives the main path; returns the kernel launches it made."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    files = {}
    t0 = time.perf_counter()
    for i in range(num_blocks):
        path = os.path.join(workdir, f"shard-{i:03d}.blk")
        random_int32(block_bytes // 4, gen, device).cpu().numpy() \
            .tofile(path)
        files[f"/bench/shard-{i}"] = (i + 1, path)
    print(f"main path: {num_blocks} x {block_bytes >> 20} MiB block files "
          f"in {workdir} ({time.perf_counter() - t0:.2f} s)", flush=True)

    paths = list(files)
    loader = DeviceBlockLoader(ShardSource(files), paths, device=device,
                               hbm_bytes=num_blocks * block_bytes
                               + (64 << 20),
                               prefetch=2, dtype=np.int32)
    hits = metrics().counter("Client.JaxHbmHits")
    try:
        rk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = list(loader.epoch())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hits0 = hits.count
        blocks = list(loader.epoch())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if hits.count - hits0 != num_blocks:
            fail(f"epoch 2: {hits.count - hits0} device-tier hits, "
                 f"want {num_blocks}")
        if any(a is not b for a, b in zip(first, blocks)):
            fail("epoch 2 did not return the device-resident pages")
        del first
        x = torch.cat(blocks)
        acc = torch.zeros((), dtype=torch.int32, device=device)
        # the first use of a PyTorch kernel in a process loads its CUDA
        # module (lazy loading, tens of ms): pay it for the chain's
        # elementwise ops outside the timed region
        torch.remainder(torch.remainder(acc, 3) + 1 + acc, 1000003)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            acc = torch.remainder(
                rk.scaled_sum(x, torch.remainder(acc, 3) + 1) + acc,
                1000003)
        end.record()
        end.synchronize()
        chain_ms = start.elapsed_time(end)
        launches = rk.launches
        got = int(acc)
    finally:
        loader.close()
    if launches != k:
        fail(f"main path launched scaled_sum {launches} times, want {k}")

    # the loaded bytes are the files' bytes, and the chain's value is
    # the plain version's
    for i, path in enumerate(files.values()):
        host = torch.from_numpy(np.fromfile(path[1], dtype=np.int32))
        if not torch.equal(blocks[i].cpu(), host):
            fail(f"block {i} on the device differs from its file")
    ref = torch.zeros((), dtype=torch.int32, device=device)
    for _ in range(k):
        ref = torch.remainder(
            rk.scaled_sum_reference(x, torch.remainder(ref, 3) + 1) + ref,
            1000003)
    if got != int(ref):
        fail(f"chained scan: kernel chain {got} != plain chain {int(ref)}")
    total = num_blocks * block_bytes
    print(f"main path: epoch 1 (host->device) {t1 - t0:.3f} s "
          f"({total / (t1 - t0) / 1e9:.2f} GB/s), epoch 2 (device tier) "
          f"{t2 - t1:.4f} s, {num_blocks} hits; warm-tier scan K={k}: "
          f"{chain_ms:.2f} ms, {k * total / chain_ms / 1e6:.1f} GB/s, "
          f"acc {got} == plain; launches {launches}", flush=True)
    return launches


# -- decode -------------------------------------------------------------------
def decode_phase(device, workdir: str, num_blocks: int,
                 block_bytes: int) -> None:
    import torch

    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              encode_image_records,
                                              image_record_bytes)

    rng = np.random.default_rng(SEED + 2)
    rec_bytes = image_record_bytes(H, W, C)
    per_block = block_bytes // rec_bytes
    files = {}
    for i in range(num_blocks):
        imgs = rng.integers(0, 255, size=(per_block, H, W, C),
                            dtype=np.uint8)
        labels = rng.integers(0, 1000, size=per_block, dtype=np.int32)
        raw = encode_image_records(imgs, labels)
        raw += b"\0" * (block_bytes - len(raw))  # pad to the block size
        path = os.path.join(workdir, f"e2e-{i}.blk")
        Path(path).write_bytes(raw)
        files[f"/bench/e2e-{i}"] = (1000 + i, path)
    loader = DeviceBlockLoader(ShardSource(files), list(files),
                               device=device,
                               hbm_bytes=num_blocks * block_bytes
                               + (8 << 20))
    n = 0
    try:
        for batch in batched_device_iterator(loader, record_bytes=rec_bytes,
                                             batch_size=BATCH):
            imgs, labels = decode_image_records(batch, height=H, width=W,
                                                channels=C)
            want_imgs, want_labels = decode_image_records(
                batch.cpu(), height=H, width=W, channels=C)
            if not torch.equal(labels.cpu(), want_labels):
                fail(f"decode batch {n}: labels differ from the CPU's")
            if not torch.equal(imgs.cpu().view(torch.int16),
                               want_imgs.view(torch.int16)):
                fail(f"decode batch {n}: bf16 images differ from the "
                     f"CPU's")
            if imgs.shape != (BATCH, H, W, C) or \
                    not bool(torch.isfinite(imgs).all()):
                fail(f"decode batch {n}: bad shape or non-finite values")
            n += 1
    finally:
        loader.close()
    want_n = num_blocks * per_block // BATCH
    if n != want_n:
        fail(f"decode: {n} batches, want {want_n}")
    print(f"decode: {n} batches of {BATCH} records bit-exact against the "
          f"CPU", flush=True)


def main() -> int:
    if importlib.util.find_spec("alluxio_tpu_torch") is None:
        print("chip_smoke.py: the alluxio_tpu_torch package is not beside "
              "this script; run it from the repository root",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    setup()
    kern = kernel_phase(device, NUM_BLOCKS * BLOCK_BYTES // 4)
    workdir = block_dir(NUM_BLOCKS * BLOCK_BYTES
                        + DECODE_BLOCKS * BLOCK_BYTES)
    try:
        launches = main_path(device, workdir, NUM_BLOCKS, BLOCK_BYTES, K)
        decode_phase(device, workdir, DECODE_BLOCKS, BLOCK_BYTES)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "scaled_sum", "route": "cuda",
        "source": "alluxio_tpu_torch/ops/csrc/reduce_kernel.cu",
        "replaces": "alluxio_tpu/ops/reduce_kernel.py:51",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
        "read_ceiling_ms": kern["read_ceiling_ms"],
        "float_sum_ms": kern["float_sum_ms"],
    }]}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
