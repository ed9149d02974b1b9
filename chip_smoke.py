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
   checked bit for bit against the same decode on the CPU;
4. train: ``bench.py``'s e2e path on the same four blocks, served from
   the loader's device tier: 3 epochs of linear-softmax SGD (85 batches
   x 128, float32), then 3 epochs of the flagship ViT (4 layers, d_model
   256, bf16, AdamW 3e-4; 170 batches x 64, ``images_to_tokens``, one
   train step a batch). Before the first step, the same weights are
   carried to the CPU and the first batch's loss, float32 logits and
   every gradient leaf on the card are held against the CPU's
   (``FIRST_STEP_TOL``, ``FIRST_STEP_LOSS_ATOL``). It fails on that, on
   a non-finite loss, and on a ViT whose last-epoch mean loss is not
   below its first.
   It prints per-step ms (CUDA events), records/s, GB/s into the step,
   each path's bound, and, from ``torch.profiler`` over 20 more steps,
   launches per step and the card's busy share. Then the ViT's train
   state is saved to a directory-backed namespace, restored into a fresh
   model, and must be bit-identical and give the same next-step loss.
5. mesh: the mesh layer over an NCCL group of one rank (one card), a
   ``{"data": 1, "model": 1}`` mesh: (a) ``MeshBlockCache.load_global``
   over the main path's 64 x 32 MiB shard files, then ``global_batch``
   of 64 seeded indices, ``ring_shift(1)``, ``gather_all``,
   ``replicate`` and a 2-row ``turnover``, each byte for byte against
   the files, ``global_batch`` timed against its bytes bound and
   profiled for host<->device copies (there must be none); (b) 3 dp x tp
   steps of the flagship ViT against the single-card steps from the same
   weights and batches, (c) one step of its MoE variant, both bit for
   bit (loss, logits, every parameter and moment); (d) ``ring_attention``
   against ``reference_attention``; (e) ``pipeline_apply`` with one
   stage against the stage applied in sequence. At one rank every
   collective is a copy through NCCL, so these check the mesh code on
   the card, not NVLink rates.

It prints the card's name and power limit, one ``{"train": {...}}``
line, one ``{"mesh": {...}}`` line, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase exits
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

#: train phase (bench.py's e2e): epochs over the four record blocks, the
#: linear model's batch is BATCH, the ViT's VIT_BATCH
EPOCHS = 3
VIT_BATCH = 64
PATCH = 16
#: the flagship's widths (bench.py:821-824), at its full depth
VIT_WIDTHS = dict(d_model=256, n_heads=8, d_ff=1024, n_layers=4)
N_CLASSES = 1000
LINEAR_LR = 1e-3
VIT_LR = 3e-4
PROFILE_STEPS = 20
#: the first ViT step on the card against the same step on the CPU (same
#: weights, same batch, both bf16). The two backends run the same bf16
#: ops but sum the matmuls in another order, so a result moves by a few
#: bf16 ulps. The float32 logits and each gradient leaf are held to
#: 2**-5 of the tensor's largest magnitude, the bf16 measure of the CPU
#: parity tests against JAX (tests/test_torch_transformer.py). At
#: initialisation the loss is near ln(1000) = 6.9078 whatever the
#: forward does, so it is held tighter: 1e-3 absolute, 28x the 3.5e-5
#: measured on an H100 and a twentieth of its distance from ln(1000).
FIRST_STEP_TOL = 2.0 ** -5
FIRST_STEP_LOSS_ATOL = 1e-3

#: mesh phase: global indices in one global_batch, ViT steps held
#: against one card (dense, then MoE), ring-attention cases
#: ([B, T, H, D], dtype), pipeline microbatches (M, rows, width)
MESH_BATCH = 64
MESH_STEPS = 3
MOE_STEPS = 1
MOE_EXPERTS = 4
RING_CASES = (((64, 16, 8, 32), "bfloat16"), ((1, 8192, 8, 64), "float32"))
#: ring attention against reference_attention: float32 within 1e-5
#: absolute, the CPU parity tests' bound (the same products, summed
#: blockwise in another order); bf16 within 2**-7 of the largest
#: |output|, one bf16 step at the largest binade, since both round a
#: float32 result and may round it apart
RING_ATOL = 1e-5
RING_BF16_TOL = 2.0 ** -7
PIPE_SHAPE = (8, 1024, 256)

#: H100 SXM peaks (NVIDIA's data sheet): device-memory rate, and the
#: CUDA-core rate (67 TFLOP/s float32; the table has no int32 entry, so
#: the kernel's integer multiply-adds and the linear model's float32
#: matmuls are held against it), and the bf16 dense tensor-core rate for
#: the ViT's matmuls
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


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
def recheck(x, scale, want: int) -> str:
    """After a kernel/plain mismatch: the plain version once more on the
    same, unmodified input, and the host's sum of a copy of it. If they
    disagree with ``want``, the card did not read one input back the same
    way twice, and the fault is not the kernel's."""
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    s = int(scale)
    again = int(rk.scaled_sum_reference(x, scale))
    total = int((x.cpu().numpy().astype(np.int64) * s).sum()) & 0xFFFFFFFF
    host = total - (1 << 32) if total >= 1 << 31 else total
    verdict = ("the input reads back stably" if again == want == host
               else "the input does NOT read back stably")
    return f"plain again {again}, host sum of a copy {host}: {verdict}"


def kernel_phase(device, big_n: int) -> dict:
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    sizes = [r * rk._LANES for r in rk.CALIBRATION_ROWS]
    sizes += [7 * 512 * rk._LANES, big_n]
    max_err = 0
    big = None
    first = None
    for n in sizes:
        x = random_int32(n, gen, device)
        for scale in (1, 3, -2):
            s = torch.tensor([scale], dtype=torch.int32, device=device)
            got = int(rk.scaled_sum(x, s))
            want = int(rk.scaled_sum_reference(x, s))
            first = first or f"n={n} scale={scale}: {got}"
            max_err = max(max_err, abs(got - want))
            if got != want:
                fail(f"scaled_sum n={n} scale={scale}: kernel {got} != "
                     f"plain {want}; {recheck(x, s, want)}")
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
        fail(f"scaled_sum wraparound: kernel {got} != plain {want}; "
             f"{recheck(wrap, 3, want)}")
    print(f"kernel phase: {len(sizes) * 3 + 1} comparisons exact "
          f"(sizes {sizes}; first {first})", flush=True)

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
              k: int) -> tuple:
    """Drives the main path; returns the kernel launches it made and its
    block files (path -> (file id, file))."""
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
    return launches, files


# -- decode -------------------------------------------------------------------
def record_files(workdir: str, num_blocks: int, block_bytes: int) -> dict:
    """``bench.py``'s e2e layout: blocks of 64x64x3 records with a 4-byte
    label, padded to the block size; returns path -> (file id, file)."""
    from alluxio_tpu_torch.ops.decode import (encode_image_records,
                                              image_record_bytes)

    rng = np.random.default_rng(SEED + 2)
    per_block = block_bytes // image_record_bytes(H, W, C)
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
    return files


def decode_phase(device, files: dict, num_blocks: int,
                 block_bytes: int) -> None:
    import torch

    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    rec_bytes = image_record_bytes(H, W, C)
    per_block = block_bytes // rec_bytes
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


# -- train phase --------------------------------------------------------------
class DirFS:
    """A directory standing in for the namespace: the three calls the
    checkpoints make, on files under ``root``."""

    def __init__(self, root: str) -> None:
        self._root = root

    def _at(self, path: str) -> str:
        return os.path.join(self._root, path.lstrip("/"))

    def write_all(self, path: str, data, **_kw) -> None:
        os.makedirs(os.path.dirname(self._at(path)), exist_ok=True)
        Path(self._at(path)).write_bytes(bytes(data))

    def read_all(self, path: str) -> bytes:
        return Path(self._at(path)).read_bytes()

    def list_status(self, path: str):
        return [SimpleNamespace(name=n) for n in os.listdir(self._at(path))]


def vit_flops_per_step(cfg, batch: int, tokens: int) -> float:
    """Matmul operations of one train step: the layers' projections, the
    head on the pooled rows and the two attention products at 3x their
    forward (forward, input and weight gradients); the embed product at
    2x, since the tokens are an input and need no gradient."""
    d, f = cfg.d_model, cfg.d_ff
    embed = 2 * batch * tokens * cfg.vocab_or_patch_dim * d
    fwd = 2 * batch * tokens * cfg.n_layers * (3 * d * d + d * d
                                               + 2 * d * f)
    fwd += 2 * batch * d * cfg.n_classes
    fwd += cfg.n_layers * 2 * 2 * batch * cfg.n_heads * tokens * tokens \
        * cfg.d_head
    return 3.0 * fwd + 2.0 * embed


def linear_softmax_loss(params, images, labels):
    """``bench.py``'s linear-softmax model: ``params = {"w": (H*W*C,
    n_classes), "b": (n_classes,)}``, float32; images are flattened and
    cast to float32. ``bench.py``'s loss sums ``log_softmax * one_hot``;
    picking the label's entry is the same value."""
    import torch

    x = images.reshape(images.shape[0], -1).float()
    logits = x @ params["w"] + params["b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def make_linear_train_step(tx):
    """``step(params, opt_state, images, labels) -> (params, opt_state,
    loss)`` for :func:`linear_softmax_loss`; ``params`` require grad."""
    import torch

    from alluxio_tpu_torch.utils.pytree import tree_leaves
    from alluxio_tpu_torch.utils.tracing import annotate

    def step(params, opt_state, images, labels):
        leaves = tree_leaves(params)
        with annotate("atpu.train.forward"):
            loss = linear_softmax_loss(params, images, labels)
        with annotate("atpu.train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        with annotate("atpu.train.update"):
            opt_state = tx.update(grads, opt_state, leaves)
        return params, opt_state, loss.detach()

    return step


def first_step_check(model, cpu_model, tokens, labels) -> dict:
    """The first ViT step's loss, float32 logits and gradients on the card
    against the CPU, from the same weights and batch; fails beyond
    ``FIRST_STEP_TOL``/``FIRST_STEP_LOSS_ATOL``."""
    import torch

    from alluxio_tpu_torch.models.transformer import forward, loss_fn

    def run(m, tok, lab):
        with torch.no_grad():
            logits = forward(m, tok)
        loss = loss_fn(m, tok, lab)
        grads = torch.autograd.grad(loss, m.leaves())
        return (float(loss.detach()), logits.cpu(),
                [g.float().cpu() for g in grads])

    def rel(a, b):  # max |a - b| over the largest |b|
        d, scale = float((a - b).abs().max()), float(b.abs().max())
        return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))

    card_loss, card_logits, card_grads = run(model, tokens, labels)
    cpu_loss, cpu_logits, cpu_grads = run(cpu_model, tokens.cpu(),
                                          labels.cpu())
    logits_rel = rel(card_logits, cpu_logits)
    grads_rel = [rel(a, b) for a, b in zip(card_grads, cpu_grads)]
    worst = max(range(len(grads_rel)), key=grads_rel.__getitem__)
    out = {"card_loss": card_loss, "cpu_loss": cpu_loss,
           "loss_abs_diff": abs(card_loss - cpu_loss),
           "loss_atol": FIRST_STEP_LOSS_ATOL, "logits_rel": logits_rel,
           "grads_rel_max": grads_rel[worst], "grads_rel_max_leaf": worst,
           "grad_leaves": len(grads_rel), "tol": FIRST_STEP_TOL}
    print(f"vit first step, card vs CPU: loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f} (|diff| {out['loss_abs_diff']:.3e}, tolerance "
          f"{FIRST_STEP_LOSS_ATOL:g}); logits max diff / max |logit| "
          f"{logits_rel:.3e}; worst of {len(grads_rel)} gradient leaves "
          f"(leaf {worst}) {grads_rel[worst]:.3e} (tolerance "
          f"{FIRST_STEP_TOL:.3e})", flush=True)
    if not out["loss_abs_diff"] <= FIRST_STEP_LOSS_ATOL:
        fail(f"vit first step: card loss {card_loss} vs CPU {cpu_loss}")
    if not logits_rel <= FIRST_STEP_TOL:
        fail(f"vit first step: logits differ by {logits_rel} of their "
             f"largest magnitude")
    if not grads_rel[worst] <= FIRST_STEP_TOL:
        fail(f"vit first step: gradient leaf {worst} differs by "
             f"{grads_rel[worst]} of its largest magnitude")
    return out


def bound_ms(flops: float, flop_rate: float, nbytes: float) -> dict:
    ops_ms = flops / flop_rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def run_epochs(name: str, loader, step, batch: int, epochs: int,
               state: tuple) -> tuple:
    """``epochs`` passes over the device tier; one ``step(state, imgs,
    labels) -> (state, loss)`` per decoded batch. Returns (state, per-epoch
    stats)."""
    import torch

    from alluxio_tpu_torch.client.torch_io import batched_device_iterator
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    rec_bytes = image_record_bytes(H, W, C)
    stats = []
    for e in range(epochs):
        losses = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for recs in batched_device_iterator(loader, record_bytes=rec_bytes,
                                            batch_size=batch):
            imgs, labels = decode_image_records(recs, height=H, width=W,
                                                channels=C)
            state, loss = step(state, imgs, labels)
            losses.append(loss)
        end.record()
        end.synchronize()
        dt = time.perf_counter() - t0
        losses = torch.stack(losses).float().cpu()
        if not bool(torch.isfinite(losses).all()):
            fail(f"{name} epoch {e + 1}: a loss is not finite")
        n = losses.numel()
        stats.append({
            "epoch": e + 1, "steps": n, "s": dt,
            "step_ms": start.elapsed_time(end) / n,
            "records_per_s": n * batch / dt,
            "gb_per_s_into_step": n * batch * rec_bytes / dt / 1e9,
            "mean_loss": float(losses.mean())})
        print(f"{name} epoch {e + 1}: {n} steps x {batch} records in "
              f"{dt:.3f} s, {stats[-1]['step_ms']:.4f} ms/step (CUDA "
              f"events), {stats[-1]['records_per_s']:.0f} records/s, "
              f"{stats[-1]['gb_per_s_into_step']:.3f} GB/s into the step, "
              f"mean loss {stats[-1]['mean_loss']:.5f}", flush=True)
    return state, stats


def profile_steps(loader, step, batch: int, n_steps: int, state):
    """``n_steps`` more steps under ``torch.profiler``: kernel launches
    per step and the share of the window in which the card was busy
    (the union of its kernel and copy intervals over the window)."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from alluxio_tpu_torch.client.torch_io import batched_device_iterator
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    batches = itertools.islice(batched_device_iterator(
        loader, record_bytes=image_record_bytes(H, W, C),
        batch_size=batch), n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for recs in batches:
            with record_function("atpu.decode"):
                imgs, labels = decode_image_records(recs, height=H,
                                                    width=W, channels=C)
            state, _ = step(state, imgs, labels)
        torch.cuda.synchronize()
    events = list(prof.events())
    # the named regions also appear on the device timeline, spanning the
    # kernels inside them: they are neither launches nor busy time
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("atpu.")]
    if not dev:
        return state, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) - \
        min(e.time_range.start for e in events)
    kernels = [e for e in dev if not e.name.startswith(("Memcpy",
                                                         "Memset"))]
    averages = prof.key_averages()
    top = sorted((a for a in averages if a.device_type == DeviceType.CUDA
                  and not a.key.startswith("atpu.")),
                 key=lambda a: a.self_device_time_total, reverse=True)[:8]
    # host time per step of each named region (CPU clock, profiler on)
    host_ms = {}
    for e in events:
        if e.name.startswith("atpu.") and e.device_type == DeviceType.CPU:
            host_ms[e.name] = host_ms.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) / n_steps / 1e3
    return state, {
        "steps": n_steps, "launches_per_step": len(kernels) / n_steps,
        "host_ms_per_step": host_ms,
        "device_busy_us_per_step": busy / n_steps,
        "window_us_per_step": window / n_steps,
        "busy_share": busy / window if window > 0 else None,
        "top": [(a.key, a.count / n_steps,
                 a.self_device_time_total / n_steps) for a in top]}


def train_phase(device, workdir: str, files: dict) -> dict:
    """bench.py's e2e path through the port: device tier -> batches ->
    decode -> (a) linear-softmax SGD, (b) the flagship ViT under AdamW;
    then the ViT's checkpoint round trip."""
    import torch

    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.models.checkpoint import (latest_step,
                                                     load_train_state,
                                                     save_train_state)
    from alluxio_tpu_torch.models.train import (make_train_state,
                                                make_train_step, sgd)
    from alluxio_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      images_to_tokens)
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)
    from alluxio_tpu_torch.utils.bf16 import bits
    from alluxio_tpu_torch.utils.pytree import tree_leaves

    rec_bytes = image_record_bytes(H, W, C)
    n_records = len(files) * (BLOCK_BYTES // rec_bytes)
    print(f"train phase: {len(files)} x {BLOCK_BYTES >> 20} MiB blocks, "
          f"{n_records} records; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    loader = DeviceBlockLoader(ShardSource(files), list(files),
                               device=device,
                               hbm_bytes=len(files) * BLOCK_BYTES
                               + (8 << 20))
    out = {}
    try:
        # (a) linear softmax, float32, SGD (bench.py:758-810)
        feat = H * W * C
        rng = np.random.default_rng(SEED + 3)
        params = {
            "w": torch.from_numpy((rng.standard_normal((feat, N_CLASSES))
                                   * 0.01).astype(np.float32)).to(device)
            .requires_grad_(),
            "b": torch.zeros(N_CLASSES, device=device, requires_grad=True)}
        tx = sgd(LINEAR_LR)
        lin_step = make_linear_train_step(tx)

        def linear(state, imgs, labels):
            p, o = state
            p, o, loss = lin_step(p, o, imgs, labels)
            return (p, o), loss

        _, lin_stats = run_epochs("linear", loader, linear, BATCH,
                                     EPOCHS, (params, tx.init(params)))
        lin_flops = 2.0 * 2 * BATCH * feat * N_CLASSES  # logits, grad w
        lin_bytes = 2 * 4 * (feat + 1) * N_CLASSES + BATCH * rec_bytes
        out["linear"] = {"epochs": lin_stats, **bound_ms(
            lin_flops, CORE_OPS_PER_S, lin_bytes)}

        # (b) the flagship ViT, bf16, AdamW 3e-4 (bench.py:820-869)
        cfg = TransformerConfig(
            vocab_or_patch_dim=PATCH * PATCH * C, n_classes=N_CLASSES,
            max_len=(H // PATCH) * (W // PATCH), **VIT_WIDTHS)
        model, opt, tx = make_train_state(cfg, device=device,
                                          learning_rate=VIT_LR, seed=0)
        cpu_model = Transformer(cfg, device="cpu", seed=1)
        cpu_model.load_param_tree(model.param_tree())  # carried over
        # the first batch of the first epoch, as the train loop sees it
        batches = batched_device_iterator(loader, record_bytes=rec_bytes,
                                          batch_size=VIT_BATCH)
        imgs, labels = decode_image_records(next(batches), height=H,
                                            width=W, channels=C)
        batches.close()
        tokens = images_to_tokens(imgs, patch=PATCH)
        first = first_step_check(model, cpu_model, tokens, labels)
        vit_step = make_train_step(cfg, tx)

        def vit(state, imgs, labels):
            m, o = state
            m, o, loss = vit_step(m, o, images_to_tokens(imgs, patch=PATCH),
                                  labels)
            return (m, o), loss

        (model, opt), vit_stats = run_epochs(
            "vit", loader, vit, VIT_BATCH, EPOCHS, (model, opt))
        if not vit_stats[-1]["mean_loss"] < vit_stats[0]["mean_loss"]:
            fail(f"vit loss did not fall: epoch 1 mean "
                 f"{vit_stats[0]['mean_loss']}, epoch {EPOCHS} mean "
                 f"{vit_stats[-1]['mean_loss']}")
        n_params = sum(p.numel() for p in model.leaves())
        # each input read once, each output written once: params, mu and
        # nu (in and out, bf16) and the batch's records
        vit_bytes = 2 * 3 * 2 * n_params + VIT_BATCH * rec_bytes
        out["vit"] = {
            "params": n_params,
            "first_step": first,
            "epochs": vit_stats, **bound_ms(
                vit_flops_per_step(cfg, VIT_BATCH, cfg.max_len),
                BF16_FLOPS_PER_S, vit_bytes)}
        print(f"vit bound per step: {out['vit']['bound_ms'] * 1e3:.2f} us "
              f"({out['vit']['bound_by']}; operations "
              f"{out['vit']['ops_ms'] * 1e3:.2f} us, bytes "
              f"{out['vit']['bytes_ms'] * 1e3:.2f} us); linear "
              f"{out['linear']['bound_ms'] * 1e3:.2f} us "
              f"({out['linear']['bound_by']})", flush=True)

        # launches and busy share over PROFILE_STEPS more steps, each path
        (model, opt), vprof = profile_steps(loader, vit, VIT_BATCH,
                                            PROFILE_STEPS, (model, opt))
        _, lprof = profile_steps(loader, linear, BATCH, PROFILE_STEPS,
                                 (params, ()))
        for name, prof in (("vit", vprof), ("linear", lprof)):
            out[name]["profile"] = prof
            if prof is not None:
                # the kernels' time against the unprofiled step (last
                # epoch), since the profiler slows the host
                prof["busy_share_of_step"] = \
                    prof["device_busy_us_per_step"] / 1e3 \
                    / out[name]["epochs"][-1]["step_ms"]
            if prof is None:
                print(f"{name} profile: the profiler showed no device "
                      f"events; launches and busy share not measured",
                      flush=True)
                continue
            print(f"{name} profile over {prof['steps']} steps: "
                  f"{prof['launches_per_step']:.1f} launches/step, device "
                  f"busy {prof['device_busy_us_per_step']:.1f} us of "
                  f"{prof['window_us_per_step']:.1f} us per step "
                  f"(busy share {prof['busy_share']:.4f}; of the "
                  f"unprofiled step {prof['busy_share_of_step']:.4f}); "
                  f"host ms/step "
                  f"under the profiler: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              sorted(prof["host_ms_per_step"].items())),
                  flush=True)
            for key, count, dev_us in prof["top"]:
                print(f"  {name} kernel: {dev_us:.1f} us/step in "
                      f"{count:g} launches/step  {key[:100]}", flush=True)

        # checkpoint round trip through a directory-backed namespace
        fs = DirFS(os.path.join(workdir, "ckpt"))
        at = EPOCHS * vit_stats[0]["steps"] + PROFILE_STEPS
        t0 = time.perf_counter()
        save_train_state(fs, f"/vit/step-{at}", model.param_tree(), opt,
                         step=at)
        t1 = time.perf_counter()
        fresh = Transformer(cfg, device=device, seed=2)
        params2, opt2, got_at = load_train_state(
            fs, f"/vit/step-{latest_step(fs, '/vit')}",
            like_params=fresh.param_tree(), like_opt=tx.init(fresh.leaves()))
        fresh.load_param_tree(params2)
        t2 = time.perf_counter()
        if got_at != at:
            fail(f"checkpoint step {got_at} != {at}")
        for a, b in zip(tree_leaves((model.param_tree(), opt)),
                        tree_leaves((fresh.param_tree(), opt2))):
            if a.device != b.device or not torch.equal(bits(a), bits(b)):
                fail("checkpoint round trip: a restored leaf differs")
        _, _, loss_a = vit_step(model, opt, tokens, labels)
        _, _, loss_b = vit_step(fresh, opt2, tokens, labels)
        if float(loss_a) != float(loss_b):
            fail(f"checkpoint round trip: next-step loss {float(loss_b)} "
                 f"!= {float(loss_a)}")
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, names in os.walk(os.path.join(workdir,
                                                             "ckpt"))
                     for f in names)
        out["checkpoint"] = {"bytes": nbytes, "save_s": t1 - t0,
                             "restore_s": t2 - t1,
                             "next_step_loss": float(loss_a)}
        print(f"checkpoint: {nbytes} bytes saved in {t1 - t0:.3f} s, "
              f"restored in {t2 - t1:.3f} s, every leaf bit-identical, "
              f"next-step loss {float(loss_a):.6f} on both", flush=True)
    finally:
        loader.close()
    return out


# -- mesh phase ---------------------------------------------------------------
def same_bits(a, b) -> bool:
    import torch

    from alluxio_tpu_torch.utils.bf16 import bits

    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a), bits(b))


def timed(fn) -> tuple:
    """``fn()``'s result and its time on the card in ms (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def check_rows(name: str, got, globals_, views) -> None:
    """Each row of ``got`` (on the card) against the file bytes of the
    global block it should hold."""
    host = got.cpu().numpy()
    for row, g in zip(host, globals_):
        if not np.array_equal(row, views[g]):
            fail(f"data plane {name}: row for block {g} differs from its "
                 f"file")


def profile_once(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its device events, the
    names of its host<->device copies, device µs by kernel, and the
    calls and host ms of each collective (the ``nccl:*`` regions that
    ``torch.distributed`` records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("atpu.")]
    averages = prof.key_averages()
    kernels = sorted(((a.key[:80], a.self_device_time_total)
                      for a in averages if a.device_type == DeviceType.CUDA
                      and not a.key.startswith("atpu.")),
                     key=lambda kv: kv[1], reverse=True)
    collectives = {a.key: (a.count, a.cpu_time_total / 1e3)
                   for a in averages if a.key.startswith("nccl:")}
    return {"device_events": dev,
            "host_copies": [n for n in dev if "HtoD" in n or "DtoH" in n],
            "kernels_us": kernels[:6], "collectives": collectives}


def data_plane_check(device, mesh, workdir: str, files: dict) -> dict:
    """(a): the main path's shard files through ``MeshBlockCache``."""
    import torch

    from alluxio_tpu_torch.parallel.ici_store import MeshBlockCache

    views = [np.memmap(path, np.uint8, "r") for _, path in files.values()]
    n = len(views)
    cache = MeshBlockCache(mesh, block_bytes=BLOCK_BYTES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = cache.load_global(ShardSource(files), list(files), report=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check_rows("load_global", cached, range(n), views)

    rng = np.random.default_rng(SEED + 4)
    idx_host = rng.integers(0, n, MESH_BATCH)
    idx = torch.from_numpy(idx_host).to(device)
    check_rows("global_batch", cache.global_batch(cached, idx), idx_host,
               views)
    # rank d receives rank (d + 1)'s shard: at one rank, its own
    check_rows("ring_shift", cache.ring_shift(cached, 1), range(n), views)
    check_rows("gather_all", cache.gather_all(cached), range(n), views)
    hot = int(rng.integers(0, n))
    check_rows("replicate", cache.replicate(cached, hot)[None], [hot],
               views)

    batch_ms = time_ms(lambda: cache.global_batch(cached, idx), reps=10)
    batch_bytes = 2 * MESH_BATCH * BLOCK_BYTES  # rows read, batch written
    prof = profile_once(lambda: cache.global_batch(cached, idx))
    events, copies = prof["device_events"], prof["host_copies"]
    if not events:
        fail("data plane: the profiler saw no device events in "
             "global_batch")
    if copies:
        fail(f"data plane: global_batch copied between host and card: "
             f"{sorted(set(copies))}")

    # turnover: two rows take two new files; the rest keep theirs
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    new = dict(files)
    rows = {3: "/bench/fresh-0", n - 5: "/bench/fresh-1"}
    for i, path in enumerate(rows.values()):
        at = os.path.join(workdir, f"fresh-{i}.blk")
        random_int32(BLOCK_BYTES // 4, gen, device).cpu().numpy().tofile(at)
        new[path] = (NUM_BLOCKS + 1 + i, at)
    ptr = cached.data_ptr()
    cached = cache.turnover(cached, ShardSource(new),
                            {g: (p, 0) for g, p in rows.items()},
                            report=False)
    if cached.data_ptr() != ptr:
        fail("data plane: turnover did not update the shard in place")
    views += [np.memmap(new[p][1], np.uint8, "r") for p in rows.values()]
    want = [n + list(rows).index(g) if g in rows else g for g in range(n)]
    check_rows("turnover", cached, want, views)
    bound = batch_bytes / HBM_BYTES_PER_S * 1e3
    out = {"blocks": n, "block_bytes": BLOCK_BYTES, "load_global_s": load_s,
           "load_gb_per_s": n * BLOCK_BYTES / load_s / 1e9,
           "global_batch_rows": MESH_BATCH, "global_batch_ms": batch_ms,
           "global_batch_bound_ms": bound,
           "global_batch_device_events": len(events),
           "global_batch_host_copies": len(copies),
           "global_batch_kernels_us": prof["kernels_us"]}
    print(f"mesh data plane: load_global {n} x {BLOCK_BYTES >> 20} MiB in "
          f"{load_s:.3f} s ({out['load_gb_per_s']:.2f} GB/s); "
          f"global_batch, ring_shift, gather_all, replicate, turnover byte "
          f"for byte against the files; global_batch of {MESH_BATCH} rows "
          f"{batch_ms:.4f} ms (CUDA events) against a {bound:.4f} ms bytes "
          f"bound; {len(events)} device events, no host<->device copy; "
          f"device µs by kernel {prof['kernels_us']}", flush=True)
    return out


def train_batches(device, files: dict, n_batches: int) -> list:
    """The first ``n_batches`` ViT batches of the train phase, as tokens
    and labels on the card."""
    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.models.transformer import images_to_tokens
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    loader = DeviceBlockLoader(ShardSource(files), list(files),
                               device=device, hbm_bytes=0)
    out = []
    try:
        batches = batched_device_iterator(
            loader, record_bytes=image_record_bytes(H, W, C),
            batch_size=VIT_BATCH)
        for recs in batches:
            imgs, labels = decode_image_records(recs, height=H, width=W,
                                                channels=C)
            out.append((images_to_tokens(imgs, patch=PATCH), labels))
            if len(out) == n_batches:
                break
        batches.close()
    finally:
        loader.close()
    return out


def sharded_step_check(device, mesh, cfg, batches, lr: float) -> dict:
    """(b)/(c): the dp x tp train step on ``mesh`` against the single-card
    step from the same seed and batches: loss, logits, every parameter
    and moment bit for bit."""
    import torch

    from alluxio_tpu_torch.models.checkpoint import (gather_opt_state,
                                                     gather_param_tree)
    from alluxio_tpu_torch.models.train import (make_eval_step,
                                                make_sharded_train_state,
                                                make_train_state,
                                                make_train_step)
    from alluxio_tpu_torch.parallel.mesh import shard_host_batch
    from alluxio_tpu_torch.utils.pytree import tree_leaves

    one, one_opt, tx = make_train_state(cfg, device=device,
                                        learning_rate=lr, seed=0)
    sh, sh_opt, stx, _ = make_sharded_train_state(cfg, mesh,
                                                  learning_rate=lr, seed=0)
    step_one = make_train_step(cfg, tx)
    step_mesh = make_train_step(cfg, stx, mesh=mesh)
    losses, ms_one, ms_mesh = [], [], []
    for i, (tokens, labels) in enumerate(batches):
        (one, one_opt, loss_one), ms = timed(
            lambda: step_one(one, one_opt, tokens, labels))
        ms_one.append(ms)
        (sh, sh_opt, loss_mesh), ms = timed(
            lambda: step_mesh(sh, sh_opt, shard_host_batch(mesh, tokens),
                              shard_host_batch(mesh, labels)))
        ms_mesh.append(ms)
        if not same_bits(loss_one, loss_mesh):
            fail(f"mesh step {i + 1} (moe_experts={cfg.moe_experts}): loss "
                 f"{float(loss_mesh)} != single card {float(loss_one)}")
        losses.append(float(loss_one))
    tokens = batches[-1][0]
    logits_one = make_eval_step(cfg)(one, tokens)
    logits_mesh = make_eval_step(cfg, mesh=mesh)(
        sh, shard_host_batch(mesh, tokens))
    if not same_bits(logits_one, logits_mesh):
        fail(f"mesh eval (moe_experts={cfg.moe_experts}): logits differ "
             f"from the single card's")
    mine = tree_leaves((gather_param_tree(sh), gather_opt_state(sh_opt, sh)))
    want = tree_leaves((one.param_tree(), one_opt))
    bad = [i for i, (a, b) in enumerate(zip(mine, want))
           if not same_bits(a, b)]
    if len(mine) != len(want) or bad:
        fail(f"mesh steps (moe_experts={cfg.moe_experts}): leaves {bad} of "
             f"the parameters and moments differ from the single card's")
    # one more step of each under the profiler, after the comparison
    profiles = {}
    for name, run in (
            ("one_card", lambda: step_one(one, one_opt, tokens, labels)),
            ("mesh", lambda: step_mesh(sh, sh_opt,
                                       shard_host_batch(mesh, tokens),
                                       shard_host_batch(mesh, labels)))):
        prof = profile_once(run)
        profiles[name] = {"device_events": len(prof["device_events"]),
                          "collectives": prof["collectives"]}
    print(f"mesh dp x tp, moe_experts={cfg.moe_experts}: {len(batches)} "
          f"step(s) bit-identical to one card (losses {losses}; logits and "
          f"{len(mine)} parameter and moment leaves); step ms one card "
          f"{ms_one}, mesh {ms_mesh}; one profiled step: {profiles}",
          flush=True)
    return {"moe_experts": cfg.moe_experts, "steps": len(batches),
            "losses": losses, "leaves": len(mine), "bit_identical": True,
            "step_ms_one_card": ms_one, "step_ms_mesh": ms_mesh,
            "profiled_step": profiles}


def ring_check(device, mesh) -> list:
    """(d): ring_attention over ``data`` against reference_attention."""
    import torch

    from alluxio_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    out = []
    for shape, dtype in RING_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   .to(getattr(torch, dtype)) for _ in range(3))
        for causal in (True, False):
            got = ring_attention(q, k, v, mesh=mesh, axis="data",
                                 causal=causal)
            want = reference_attention(q, k, v, causal=causal)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ms = time_ms(lambda: ring_attention(q, k, v, mesh=mesh,
                                                axis="data", causal=causal),
                         reps=3, warmup=1)
            ref_ms = time_ms(lambda: reference_attention(q, k, v,
                                                         causal=causal),
                             reps=3, warmup=1)
            case = {"shape": list(shape), "dtype": dtype, "causal": causal,
                    "max_abs_err": err, "max_abs_ref": scale,
                    "tol": RING_ATOL if dtype == "float32"
                    else RING_BF16_TOL * scale, "ms": ms,
                    "reference_ms": ref_ms}
            out.append(case)
            print(f"mesh ring_attention {list(shape)} {dtype} causal="
                  f"{causal}: max |diff| {err:.3e} (tolerance "
                  f"{case['tol']:.3e}), {ms:.4f} ms, reference {ref_ms:.4f} "
                  f"ms", flush=True)
            if not err <= case["tol"]:
                fail(f"ring_attention {list(shape)} {dtype} causal={causal}"
                     f": differs by {err} from reference_attention")
        del q, k, v
    return out


def pipeline_check(device, mesh, shape) -> dict:
    """(e): pipeline_apply over a one-stage ``pipe`` axis against the
    stage applied in sequence, bit for bit."""
    import torch

    from alluxio_tpu_torch.parallel.pipeline import pipeline_apply

    m, rows, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    params = {"w": torch.randn((1, d, d), generator=gen, device=device)
              * d ** -0.5,
              "b": torch.randn((1, d), generator=gen, device=device) * 0.1}
    micro = torch.randn(shape, generator=gen, device=device)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    got = pipeline_apply(stage, params, micro, mesh=mesh)
    want = torch.stack([stage({k: v[0] for k, v in params.items()}, x)
                        for x in micro])
    if not same_bits(got, want):
        fail("pipeline_apply differs from the stage applied in sequence")
    print(f"mesh pipeline_apply, 1 stage, {m} microbatches of {rows} x {d}: "
          f"bit-identical to the stage in sequence", flush=True)
    return {"stages": 1, "microbatches": m, "shape": list(shape),
            "bit_identical": True}


def mesh_phase(device, workdir: str, shard_files: dict,
               records: dict) -> dict:
    """The mesh layer over an NCCL group of one rank on this card."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from alluxio_tpu_torch.models.transformer import TransformerConfig
    from alluxio_tpu_torch.parallel.mesh import make_mesh

    store = dist.FileStore(os.path.join(workdir, "nccl-store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        print(f"mesh phase: backend {dist.get_backend()}, NCCL {nccl}, "
              f"world 1, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"on {torch.device('cuda', torch.cuda.current_device())}",
              flush=True)
        out = {"backend": dist.get_backend(), "nccl": nccl, "world": 1,
               "data_plane": data_plane_check(device, mesh, workdir,
                                              shard_files)}
        cfg = TransformerConfig(
            vocab_or_patch_dim=PATCH * PATCH * C, n_classes=N_CLASSES,
            max_len=(H // PATCH) * (W // PATCH), **VIT_WIDTHS)
        batches = train_batches(device, records, MESH_STEPS)
        out["vit"] = sharded_step_check(device, mesh, cfg, batches, VIT_LR)
        out["moe"] = sharded_step_check(
            device, mesh, dataclasses.replace(cfg, moe_experts=MOE_EXPERTS),
            batches[:MOE_STEPS], VIT_LR)
        out["ring_attention"] = ring_check(device, mesh)
        out["pipeline"] = pipeline_check(
            device, make_mesh({"pipe": 1}), PIPE_SHAPE)
    finally:
        dist.destroy_process_group()
    return out


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
        launches, shard_files = main_path(device, workdir, NUM_BLOCKS,
                                          BLOCK_BYTES, K)
        files = record_files(workdir, DECODE_BLOCKS, BLOCK_BYTES)
        decode_phase(device, files, DECODE_BLOCKS, BLOCK_BYTES)
        # the train path runs no kernel of the port (the JAX e2e path
        # reaches no Pallas kernel): its count is read all the same
        from alluxio_tpu_torch.ops import reduce_kernel as rk
        rk.launches = 0
        train = train_phase(device, workdir, files)
        train["kernel_launches"] = {"scaled_sum": rk.launches}
        print(f"train path: scaled_sum launched {rk.launches} times (the "
              f"path has no kernel of its own)", flush=True)
        rk.launches = 0
        mesh = mesh_phase(device, workdir, shard_files, files)
        mesh["kernel_launches"] = {"scaled_sum": rk.launches}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
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
    # the run drives one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
