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
2. main path: the port's ``LocalCluster`` (its master and one worker, a
   MEM tier of the working set plus 256 MiB in ``/dev/shm``, worker
   heartbeats on) and its ``FileSystem``, as ``bench.py``'s device path
   runs them: 64 seeded int32 shards x 32 MiB written with
   ``write_all(..., MUST_CACHE)`` (the cold write rate printed), then a
   ``DeviceBlockLoader`` over the client: epoch 1 moves them host ->
   device through the client's block ladder (the opens by rung printed),
   epoch 2 must be all device-tier hits; then ``K`` chained
   ``scaled_sum`` calls over the device-resident set (the warm-tier
   scan), checked against the same chain on the plain version. The
   shards also go to block files, the source of the phases that keep
   their stand-ins (2b, 2c) and of 2g's cluster;
2a. prefetch: the port's ``PrefetchService.from_fs`` over the cluster's
   client and the same paths (seed ``SEED``, lookahead 16, a 16-block
   budget, every placement in the device tier, a 100 ms heartbeat
   thread) feeds a fresh loader whose consumer runs on a side stream;
   after the warm-up gate, epoch 0 must follow ``epoch_sequence(0)``
   with every block equal to its shard, hits + late + misses = 64 and
   no failed adopt; epoch 1 must be 64 device-tier hits in
   ``epoch_sequence(1)``'s order; then ``K`` chained ``scaled_sum``
   calls over the shuffled epoch must give the main path's chained
   value and the plain chain's;
2d. master: on the same cluster, 2 000 empty files in 20 directories
   beside the 64 shards, half through a gRPC master client and half
   through one on the same-host fast path: per-call p50/p99 of
   ``create_file`` + ``complete_file``, ``get_status`` and
   ``list_status`` on each; then the master restarts on the same journal
   (replay time printed; the replay must scan its frames natively), the
   worker re-registers, the 64 shards must resolve to the same block ids
   and lengths, and one loader epoch over them must scan (``K`` chained
   ``scaled_sum``) to the main path's value. Then config #2 of 2e runs on
   the same cluster, and config #4 at ``bench.py``'s size (2e d). The
   cluster then stops and its directory goes, before 2e and 2c build
   their own tiers;
2e. suite: ``bench.py``'s device configs through the port's
   ``stress/tpu_suite.py``, each stage checking what it moved. (a) config
   #2 on the main path's cluster: 4 shards of ``min(BLOCK_BYTES, 64
   MiB)``, 4096 seeded 4 KiB reads batched 256 at a time onto the card,
   every batch equal to the files, MB/s against the adjacent ceiling;
   (b) config #3 on its own two-worker cluster with the job service, at
   the main path's corpus (64 x 32 MiB in 4 MiB blocks, the file count cut
   only if ``/dev/shm`` lacks the room): a warm reference onto the card,
   the corpus freed, a ``load`` job that must complete with every block
   located on both workers, then the loaded set onto the card with no
   UFS read, equal on the card to the warm set; ``K`` chained
   ``scaled_sum`` calls over it (the ``suite`` launches) equal the plain
   chain and the warm set's; the load's seconds split between the
   tasks' commit waits and the worker's fetches (both timers), the load
   untraced at the suite's settings; then the config once more, traced,
   with a trace ring that holds all of its spans and the worker metrics
   heartbeat (which drains the ring) held off: the fetch spans' phases,
   and the spans of the post-load ``read_all`` streams;
   (c) config #5
   at ``write_bench.run()``'s defaults (each file its own payload): no
   error, no unpersisted file, spilled bytes in the SSD tier, every file
   read back equal to its own payload through the cluster and from its
   UFS file; (d) the table read path: config #4 (the reference's seeded
   23-column Parquet table, a full scan through ``open_parquet`` against a
   3-column projection copied to the card) at ``bench.py``'s 2 x 30 000
   rows on the main path's cluster, then at 16 x 1 000 000 rows (about
   1.5 GB of Parquet) on a cluster of its own (a MEM tier of the table
   plus 256 MiB in ``/dev/shm``, partitions cut only if it lacks the
   room), each run's projected columns equal to the table's on the card;
   then ``table_bench.run_pushdown`` at its defaults (4 x 40 000 rows,
   3 repeats, a modeled 2 ms wire): planned and legacy ms, the planned
   table equal to the legacy one;
2f. clairvoyant: ``prefetch_bench.run_clairvoyant`` on the card at the JAX
   defaults (4 x 8 MiB, 1 MiB blocks, every placement in DRAM) and at the
   main path's corpus (64 x 32 MiB in 32 MiB blocks, lookahead 16, a 512
   MiB budget, ``hbm_fraction`` 0.25), two epochs each: hit rate, late
   count, p50/p99 block-ready ms, GB/s, the stall buckets and their
   verdict; every consumed block equal to its file's bytes on the card;
2b. page cache: ``LocalCacheManager`` with a 512 MB host tier of 1 MiB
   pages on disk (LRU) below a device tier: two passes of ``get_device``
   over all 2048 pages of the main path's files (2048 promotions, then
   2048 device hits), each file's pages equal to its device block, and
   one ``scaled_sum`` over all pages equal to the main path's set's;
2c. worker: the port's ``BlockWorker`` (one MEM tier of the working set
   plus 8 blocks, in ``/dev/shm`` when it has room, its shm dir) behind
   its ``RpcServer`` on 127.0.0.1, with a block master and a file master
   standing in (the block master frees a block a heartbeat reports
   before its commit, as the JAX one does); every read goes through the
   port's ``BlockStoreClient.open_block`` ladder (SHM, lease, remote,
   UFS), each route failing if a block was served by another rung than
   its own. First the host->device ceiling: one pinned 32 MiB and one
   pinned 2 GiB copy to the card, no host work. (i) the 64 shards
   written by short circuit (``LocalBlockOutStream``), 64 commits; (ii)
   a fresh loader reads them through the lease rung (the client with the
   SHM plane off) into the device tier (every lease held while the
   loader is open and released by ``close()``), epoch 2 is 64
   device-tier hits, then ``K`` chained ``scaled_sum`` calls equal the
   main path's chain and the plain chain; (ii') the same through the SHM
   rung (the JAX defaults): 64 leases and 64 SHM pins while the loader
   is open, none after the loader and then the client close, every block
   pre-faulted by the native library, each cold open's lease RPC and map
   traced (the route turns and the remote rung run in 2g); (iii) one
   ``pread_many`` of 256 seeded small reads on the remote rung
   (one ``read_many``) and on the SHM rung (one native plan), equal to
   the file; (iv) the prefetch loop at the JAX defaults
   (``hbm_fraction`` 0.25: DRAM placements through the worker's
   ``async_cache`` from the block files as UFS, pinned against
   eviction) over fresh block ids on the tier as (i)-(iii) left it: two
   epochs in the oracle's order with every block equal to its file,
   hits + late + misses = 64, at least one DRAM placement, no failed
   placement, evictions but no pinned block among them, and no pin left
   after the service closes; (v) 8 fresh blocks no worker holds through
   the UFS rung into a device tier, one stream a block, then 8 more
   striped at the JAX defaults, the worker streaming each from its
   striped, coalescing fetch: each block equal to its file, fetched once
   and each byte read from the UFS once, no fallback or failure, the
   fetch's time to first byte (p50, p99) printed, and ``K`` chained
   ``scaled_sum`` calls over each turn's blocks equal to the plain chain
   and the main path's over the same files (the ``worker_cold``
   launches); (v') four readers, each with its own client, start
   together on 8 fresh cold blocks: every reader's bytes equal the
   files, each block one fetch and one UFS read, joins and rungs
   printed; (vii) those 8 blocks through the SHM route with
   ``atpu.debug.fault.shm.map.error.rate`` 1.0: every block served by
   the lease rung into a full device tier, then, the injector reset, by
   the SHM rung with no fault; the worker runs a JSON-lines metrics
   sink and its web endpoint, whose info and blocks routes must list
   the store's blocks and whose sink file must hold
   ``Worker.UfsBlocksRead``. No pre-fault or plan may take the plain
   path. (vi) After that worker stopped, a second one with worker QoS on
   (its authenticator on its server) and a 32-block MEM tier: a
   "victim" reads 8 fresh cold blocks on demand into a device tier and
   scans them, then a "flood" tenant queues 16 fresh cold blocks through
   ``async_cache`` at PREFETCH and the victim reads 8 others; each
   victim chain the main path's (the ``worker_qos`` launches), every
   flood block cached and right once the async cache is idle, every
   block fetched once, the principals the worker saw printed;
2g. a worker in its own process: the port's ``MultiProcessCluster``
   under ``/dev/shm`` (its master and one worker, each a ``python -m
   alluxio_tpu_torch.shell.main <role>`` process; 32 MiB blocks; a MEM
   tier of the working set plus 256 MiB and room for what decode, train
   and mesh write, through the level-0 quota template) and its
   ``FileSystem``: the 64 shards written with ``write_all(MUST_CACHE)``,
   each one block on the worker; a loader's epoch 1 with every block on
   the SHM rung, epoch 2 all device-tier hits, ``K`` chained
   ``scaled_sum`` calls equal to the main path's chain and the plain
   chain (the ``multi_process`` launches); the route turns, each epoch
   1 of a fresh loader with no device tier, the route chosen by the
   client's keys only: the lease rung (``atpu.user.shm.enabled`` off),
   the SHM rung cold (the lease RPC and the map of each open traced)
   and again on the same client (no lease RPC), 8 blocks through the
   remote rung (``atpu.user.short.circuit.enabled`` off) one stream a
   block, striped (the stripe-size key) and one stream again, every
   block on its rung and equal to its file; 2d's metadata calls
   (create + complete, ``get_status``, ``list_status`` of 2 000 empty
   files) p50/p99 on the gRPC and fast-path transports. Each number
   prints beside its
   in-process counterpart (the main path, 2c's traced SHM read, 2d). The
   cluster then serves decode, train and mesh, and every one of its
   processes stops at the end of the run;
3. decode: four 32 MiB blocks of 64x64x3 records, written to 2g's
   cluster, through ``batched_device_iterator`` and
   ``decode_image_records`` on the card, checked bit for bit against the
   same decode on the CPU;
4. train: ``bench.py``'s e2e path on the same four blocks, read from
   2g's cluster and served from the loader's device tier: 3 epochs of linear-softmax SGD (85 batches
   x 128, float32), then 3 epochs of the flagship ViT (4 layers, d_model
   256, bf16, AdamW 3e-4; 170 batches x 64, ``images_to_tokens``, one
   train step a batch). Before the first step, the same weights are
   carried to the CPU and the first batch's loss, float32 logits and
   every gradient leaf on the card are held against the CPU's
   (``FIRST_STEP_TOL``, ``FIRST_STEP_LOSS_ATOL``). It fails on that, on
   a non-finite loss, and on a ViT whose last-epoch mean loss is not
   below its first.
   It prints per-step ms (CUDA events), records/s, GB/s into the step,
   each path's bound, and, from the port's ``device_trace`` (a
   ``torch.profiler`` capture written as a Chrome trace, which must hold
   the kernels) over 20 more steps, launches per step and the card's
   busy share. Then the ViT's train
   state is saved to a directory-backed namespace, restored into a fresh
   model, and must be bit-identical and give the same next-step loss.
5. mesh: the mesh layer over an NCCL group of one rank (one card), a
   ``{"data": 1, "model": 1}`` mesh: (a) ``MeshBlockCache.load_global``
   over the main path's 64 x 32 MiB shards in 2g's cluster (the
   turnover's two fresh shards written there too), then ``global_batch``
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
2h. stress, after the mesh: (a) 2g's corpus and everything else in its
   namespace deleted, ``python -m alluxio_tpu_torch.stress`` runs as a
   child process with ``--master`` at 2g's cluster: ``worker`` random (8
   threads) and sequential (4 threads) over 32 x 64 MiB shards, and
   ``master`` GetStatus, CreateFile and ListStatus (``--fixed-count
   100``, 8 threads), ``STRESS_DURATION_S`` each, the bench's namespace
   deleted after each;
   then the same five rows with no ``--master`` (the bench's in-process
   cluster). Each row must have no error and ops/s above 0; each prints
   beside its in-process row (ops/s, MB/s, p50, p99), and the attached
   client's metadata transport is printed; (b) a job master and two job
   workers, each a process of its own with the cluster's environment,
   run a ``stressbench`` job of the worker bench (random, 5 s, 4 x 64
   MiB shards a task) and then one of the master bench (GetStatus, 5 s):
   each join must count 2 tasks and no error, and no job role outlives
   its stop. 2g's cluster then stops; (c) a second multi-process
   cluster whose master keeps its namespace in the LSM store (in the
   cluster's directory, the JAX defaults otherwise): 2d's metadata
   workload by transport, printed beside 2g's HEAP master; the master
   restarts on the same journal and metastore, the 2 000 files must list
   as before, and the journal replay (from the master's banner) and the
   store's flushes, compactions and runs print; (d) ``python -m
   alluxio_tpu_torch.stress suite`` as a child process, its lines in the
   work directory: it must exit 0, or 1 with each failed row failed by
   its speed gate alone (``gate_miss``: a crash, a wrong byte or count
   fails the run), every row and gate printed; ``stress report`` renders
   the lines into the work directory, and the page must name every row.
2i. the observability loop, last: a ``MultiProcessCluster`` of its own
   (its master and one worker each a process, in ``/dev/shm``) with the
   metrics history, the health rules and the remediation engine on (not
   in dry run), the master's web server on an ephemeral port, tracing
   on, and the health and heartbeat keys cut (``OBS_KEYS``); the client
   runs the stack sampler. (a) The main path's 64 shards written THROUGH
   to the UFS and freed, every block cold; (b) a loader with a device
   tier and a ``PrefetchService`` whose budget the overlay retunes (its
   agent not started, so every block crosses the worker's cold fetch)
   reads them in the oracle's order, the consumer launching
   ``scaled_sum`` once a block and reading it back: the client's ``Client.InputBoundFraction`` must fire
   ``input-stall-sustained``, the engine must execute a ``retune`` and
   the client apply its overlay (``Client.ConfOverlayApplied``, the
   scheduler's budget doubled); the times from the first stalled sample
   to the alert, the action and the client are printed beside the
   selfheal bench's bound; ``get_health`` and the web server's health
   route must name the same alerts; (c) device-tier epochs (every block
   a hit) until the alert resolves and the overlay is withdrawn (the
   budget back at its boot value), within ``OBS_RESOLVE_DEADLINE_S``,
   the hit epochs' consumer wait and step a block printed; (d) every
   consumed block equal to its file, every block's result the plain
   version's, the ``K`` chain over the resident set the main path's
   and the plain chain's, the history holding the client's fraction
   through both epochs; (e) one traced remote read (short circuit off)
   through the worker process, whose stitched trace must hold spans of
   the client and of the worker, and its critical path (the
   ``attributed_pct`` under the obs gate of 90 is a recorded miss); (f)
   the master's profile of the client must hold the loader's producer
   frames; no role process may outlive the stop.

It prints the card's name and power limit, whether pyarrow imports,
one ``{"main": {...}}``
line, one ``{"prefetch": {...}}`` line, one ``{"master": {...}}`` line,
one ``{"page_cache": {...}}`` line, one ``{"worker": {...}}``
line, one ``{"train": {...}}``
line, one ``{"mesh": {...}}`` line, one ``{"suite": {...}}`` line, one
``{"clairvoyant": {...}}`` line, one ``{"multi_process": {...}}`` line,
one ``{"stress": {...}}`` line, one ``{"observability": {...}}`` line,
one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. Without a CUDA card, or without the repository beside it, it
exits non-zero and prints no result. All data is made from a seed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
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
#: prefetch phase: the JAX defaults' lookahead (16 blocks), a budget of
#: that many blocks, every placement in the device tier (2a keeps this
#: cut from the defaults so its numbers stay comparable across runs; 2c
#: runs the defaults' DRAM placements on the port's worker)
PREFETCH_LOOKAHEAD = 16
PREFETCH_HEARTBEAT_S = 0.1
#: page-cache phase, at the JAX defaults: 1 MiB pages, a 512 MB host tier
#: the master phase (2d): empty files beside the shards, in directories
MASTER_FILES = 2000
SUITE_FILES = NUM_BLOCKS  # config #3 at the main path's corpus (2 GiB)
PROJECTION_PARTITIONS = 16   # config #4 at a real training table's size:
PROJECTION_ROWS = 1_000_000  # 16 x 1M rows of 23 columns, ~1.5 GB Parquet
MASTER_DIRS = 20
#: config #3's trace ring: every span of the stage (a few per loaded
#: block, and the heartbeats' RPCs) with room to spare
SUITE_TRACE_RING = 1 << 17
PAGE_BYTES = 1 << 20
PAGE_CACHE_BYTES = 512 << 20
#: worker phase: a MEM tier of the working set and eight blocks more
#: (bench.py's worker_mem_bytes, 2 GiB + 256 MiB at full size), a 100 ms
#: block heartbeat, the mount id of the block files' UFS, the blocks read
#: through the remote rung, and the container ids the prefetch step's
#: fresh blocks start after
WORKER_SPARE_BLOCKS = 8
WORKER_HEARTBEAT_S = 0.1
WORKER_MOUNT_ID = 1
GRPC_BLOCKS = 8
#: the remote rung's striped turn: the JAX default stripe size
#: (atpu.user.remote.read.stripe.size), eight stripes a block
REMOTE_STRIPE_BYTES = 4 << 20
PREFETCH_CONTAINER_BASE = 100
#: 2g, the multi-process cluster: the readiness waits of its processes
MP_BOOT_S = 60.0
#: the cold turns' fresh blocks: a container range per turn
COLD_CONTAINER_BASE = 200
#: (2c v') readers of one set of cold blocks, started together
COALESCE_READERS = 4
COALESCE_CONTAINER_BASE = 300
#: (2c vi) the QoS worker's MEM tier, the flood's blocks, the victim's.
#: The phase caches 32 blocks; 36 keeps them at 89 % of the tier, under
#: the 95 % high watermark above which the worker's management heartbeat
#: evicts down to 70 % once the store is idle (and so would evict flood
#: blocks before the phase checks that they are cached)
QOS_TIER_BLOCKS = 36
QOS_FLOOD_BLOCKS = 16
QOS_CONTAINER_BASE = 400
#: the QoS worker's async-cache threads: 8 flood fetches in flight, 4
#: stripe tasks each, are four times the tenant cap (8 stripe tasks), so
#: the cap must park flood work
QOS_ASYNC_CACHE_THREADS = 8
#: the 2c worker's JSON-lines metrics sink ticks this often
SINK_INTERVAL = "1s"
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
    # config #4 and the table read path need pyarrow
    try:
        import pyarrow
    except ImportError as e:
        fail(f"pyarrow does not import: {e}")
    print(f"pyarrow imports: version {pyarrow.__version__}", flush=True)

    # the host's C++ compiler builds the port's native library (and is
    # nvcc's host compiler): the run fails without it
    gxx = shutil.which("g++")
    if gxx is None:
        fail("g++ is not on PATH: the native library cannot be built")
    print(subprocess.run([gxx, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()[0],
          flush=True)
    from alluxio_tpu_torch import native

    t0 = time.perf_counter()
    if not native.loaded():
        fail("the native library did not build or load")
    print(f"native library {native._lib_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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


def block_dir(need_bytes: int) -> str:
    shm = Path("/dev/shm")
    if shm.is_dir():
        st = os.statvfs(shm)
        if st.f_bavail * st.f_frsize > need_bytes + (256 << 20):
            return tempfile.mkdtemp(prefix="atpu-torch-smoke-", dir=shm)
    return tempfile.mkdtemp(prefix="atpu-torch-smoke-")


# -- main path ----------------------------------------------------------------
def chain(fn, x, k: int):
    """``k`` chained ``fn(x, scale)`` calls, each scale taken from the
    last result on the device (no host sync); returns the 0-d result."""
    import torch

    acc = torch.zeros((), dtype=torch.int32, device=x.device)
    for _ in range(k):
        acc = torch.remainder(fn(x, torch.remainder(acc, 3) + 1) + acc,
                              1000003)
    return acc


def main_path(device, workdir: str, num_blocks: int, block_bytes: int,
              k: int) -> dict:
    """Drives the main path through the port's own cluster: a
    ``LocalCluster`` (master and one worker, its MEM tier the working set
    plus 256 MiB) and its ``FileSystem``, as ``bench.py``'s device path
    does. The shards are written with ``write_all(MUST_CACHE)``, then a
    ``DeviceBlockLoader`` over the client reads them into the device
    tier. The shards also go to block files for the phases that keep
    their stand-ins. Returns the kernel launches it made, the running
    cluster and its client, the block files (path -> (file id, file)),
    the device blocks in file order, the chained value and epoch 1's
    time."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster import LocalCluster
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
    print(f"main path: {num_blocks} x {block_bytes >> 20} MiB shards made "
          f"from the seed ({time.perf_counter() - t0:.2f} s)", flush=True)

    t0 = time.perf_counter()
    cluster = LocalCluster(
        os.path.join(workdir, "cluster"), num_workers=1,
        block_size=block_bytes,
        worker_mem_bytes=num_blocks * block_bytes + (256 << 20),
        start_worker_heartbeats=True).start()
    fs = cluster.file_system()
    print(f"main path: LocalCluster (master at {cluster.master.address}, "
          f"one worker, MEM tier {(num_blocks * block_bytes >> 20) + 256} "
          f"MiB) up in {time.perf_counter() - t0:.2f} s", flush=True)
    write_s = write_files(fs, files)
    total = num_blocks * block_bytes
    print(f"main path: cold write {num_blocks} x {block_bytes >> 20} MiB "
          f"write_all(MUST_CACHE) {write_s:.3f} s "
          f"({total / write_s / 1e9:.2f} GB/s)", flush=True)

    paths = list(files)
    m = metrics()
    rungs = ("shm", "remote", "ufs")
    opens0 = {r: m.counter(f"Client.BlockOpens.{r}").count for r in rungs}
    leases = m.counter("Worker.ShmLeasesGranted")
    leases0 = leases.count
    loader = DeviceBlockLoader(fs, paths, device=device,
                               hbm_bytes=num_blocks * block_bytes
                               + (64 << 20),
                               prefetch=2, dtype=np.int32)
    hits = m.counter("Client.JaxHbmHits")
    try:
        rk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = list(loader.epoch())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wait_s = loader.stall_report()["total_wait_s"]
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
        acc, chain_ms = timed(lambda: chain(rk.scaled_sum, x, k))
        launches = rk.launches
        got = int(acc)
    finally:
        loader.close()
    opens = {r: m.counter(f"Client.BlockOpens.{r}").count - opens0[r]
             for r in rungs}
    if launches != k:
        fail(f"main path launched scaled_sum {launches} times, want {k}")
    if sum(opens.values()) != num_blocks:
        fail(f"main path: block opens by rung {opens}, want "
             f"{num_blocks} in all")

    # the loaded bytes are the shards' bytes, and the chain's value is
    # the plain version's
    for i, path in enumerate(files.values()):
        host = torch.from_numpy(np.fromfile(path[1], dtype=np.int32))
        if not torch.equal(blocks[i].cpu(), host):
            fail(f"block {i} on the device differs from its shard")
    ref = int(chain(rk.scaled_sum_reference, x, k))
    if got != ref:
        fail(f"chained scan: kernel chain {got} != plain chain {ref}")
    print(f"main path: epoch 1 (host->device) {t1 - t0:.3f} s "
          f"({total / (t1 - t0) / 1e9:.2f} GB/s, the consumer waits "
          f"{wait_s:.3f} s), block opens by rung "
          f"{opens} (Client.BlockOpens; the lease rung counts under shm), "
          f"{leases.count - leases0} SHM leases granted; epoch 2 (device "
          f"tier) {t2 - t1:.4f} s, {num_blocks} hits; warm-tier scan "
          f"K={k}: {chain_ms:.2f} ms, {k * total / chain_ms / 1e6:.1f} "
          f"GB/s, acc {got} == plain; launches {launches}", flush=True)
    return {"launches": launches, "files": files, "blocks": blocks,
            "chain": got, "epoch1_s": t1 - t0, "consumer_wait_s": wait_s,
            "cluster": cluster,
            "fs": fs, "cold_write_s": write_s, "opens": opens,
            "shm_leases": leases.count - leases0}


# -- prefetch phase -----------------------------------------------------------
def check_order(name: str, got: list, want_refs: list, main: dict) -> None:
    """Each yielded block against the main path's device block of the
    file the oracle put at its position (those were held against their
    files): the order and the bytes in one comparison, on the card."""
    import torch

    index = {path: i for i, path in enumerate(main["files"])}
    if len(got) != len(want_refs):
        fail(f"{name}: {len(got)} blocks, want {len(want_refs)}")
    for pos, (block, ref) in enumerate(zip(got, want_refs)):
        if not torch.equal(block, main["blocks"][index[ref.path]]):
            fail(f"{name}: block {pos} is not {ref.path}, the oracle's "
                 f"choice for that position, byte for byte")


def prefetch_phase(device, main: dict, k: int) -> dict:
    """(2a): the clairvoyant prefetch loop feeding a loader's device tier
    ahead of a consumer on a side stream, then the warm scan over the
    shuffled epoch; on the main path's cluster, through a new client."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.prefetch import PrefetchService

    files = main["files"]
    n = len(files)
    # a client of its own, as a new job's: it maps every block anew
    fs = main["cluster"].file_system()
    m = metrics()
    adopted = m.counter("Client.PrefetchHbmAdopted")
    adopt_failures = m.counter("Client.PrefetchHbmAdoptFailures")
    hbm_hits = m.counter("Client.JaxHbmHits")
    svc = PrefetchService.from_fs(
        fs, list(files), seed=SEED, lookahead_blocks=PREFETCH_LOOKAHEAD,
        budget_bytes=PREFETCH_LOOKAHEAD * BLOCK_BYTES, hbm_fraction=1.0,
        heartbeat_interval_s=PREFETCH_HEARTBEAT_S)
    side = torch.cuda.Stream(device=device)
    if side == torch.cuda.default_stream(device):
        fail("prefetch phase: the side stream is the default stream")
    loader = None
    try:
        # the loader binds its adopt hook first, so no tick finds the
        # service without one
        loader = DeviceBlockLoader(fs, list(files), device=device,
                                   hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                                   prefetch=2, dtype=np.int32,
                                   prefetch_service=svc)
        adopted0, failures0 = adopted.count, adopt_failures.count
        t0 = time.perf_counter()
        svc.start()
        if not svc.wait_ready(PREFETCH_LOOKAHEAD, timeout_s=60.0):
            fail(f"prefetch phase: {PREFETCH_LOOKAHEAD} placements not "
                 f"ready within 60 s: {svc.stats()}")
        warm_s = time.perf_counter() - t0
        warm_adopted = adopted.count - adopted0
        rk.launches = 0
        epochs = []
        for e in range(2):
            base, hits0, adopted_e = svc.stats(), hbm_hits.count, \
                adopted.count
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.cuda.stream(side):
                blocks = list(loader.epoch())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            st = svc.stats()
            out = {"epoch": e, "s": dt,
                   "gb_per_s": n * BLOCK_BYTES / dt / 1e9,
                   "hits": st["hits"] - base["hits"],
                   "late": st["late"] - base["late"],
                   "misses": st["misses"] - base["misses"],
                   "device_tier_hits": hbm_hits.count - hits0,
                   "adopted": adopted.count - adopted_e}
            epochs.append(out)
            if e == 0:  # epoch 0's samples alone: epoch 1 adds 64 zeros
                ready = m.timer("Client.PrefetchBlockReady").snapshot()
            check_order(f"prefetch epoch {e}", blocks,
                        svc.oracle.epoch_sequence(e), main)
            if out["hits"] + out["late"] + out["misses"] != n:
                fail(f"prefetch epoch {e}: hits {out['hits']} + late "
                     f"{out['late']} + misses {out['misses']} != {n}")
        e0, e1 = epochs
        placed = adopted.count - adopted0
        if warm_adopted < PREFETCH_LOOKAHEAD or placed < e0["hits"]:
            fail(f"prefetch epoch 0: {placed} adopts ({warm_adopted} "
                 f"before the gate) for {e0['hits']} hits")
        if adopt_failures.count != failures0:
            fail(f"prefetch phase: {adopt_failures.count - failures0} "
                 f"device-tier adopts failed")
        if e1["device_tier_hits"] != n or e1["hits"] != n:
            fail(f"prefetch epoch 1: {e1['device_tier_hits']} device-tier "
                 f"hits, {e1['hits']} scheduler hits, want {n}")
        # the warm scan over the shuffled epoch, on the consumer's stream
        with torch.cuda.stream(side):
            x = torch.cat(blocks)
            acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
            launches = rk.launches
            got = int(acc)
            plain = int(chain(rk.scaled_sum_reference, x, k))
        stats = svc.stats()
    finally:
        svc.close()  # stops the heartbeat and the adopt thread first
        if loader is not None:
            loader.close()
        fs.close()
    if launches != k:
        fail(f"prefetch phase launched scaled_sum {launches} times, want "
             f"{k}")
    if not got == main["chain"] == plain:
        fail(f"prefetch scan: kernel chain {got}, main path's chain "
             f"{main['chain']}, plain chain {plain}")
    out = {"blocks": n, "block_bytes": BLOCK_BYTES, "seed": SEED,
           "lookahead_blocks": PREFETCH_LOOKAHEAD,
           "budget_bytes": PREFETCH_LOOKAHEAD * BLOCK_BYTES,
           "hbm_fraction": 1.0, "heartbeat_s": PREFETCH_HEARTBEAT_S,
           "warm_up_s": warm_s, "warm_up_adopts": warm_adopted,
           "adopts": placed, "epochs": epochs,
           "main_path_epoch1_s": main["epoch1_s"],
           "epoch0_block_ready_p50_s": ready["p50"],
           "epoch0_block_ready_p99_s": ready["p99"],
           "late_arrivals": stats["late_arrivals"],
           "scan_ms": scan_ms, "scan_launches": launches, "chain": got}
    print(f"prefetch: warm-up gate ({PREFETCH_LOOKAHEAD} placements) "
          f"{warm_s:.3f} s; epoch 0 in the oracle's order, consumer on a "
          f"side stream: {e0['s']:.3f} s ({e0['gb_per_s']:.2f} GB/s) "
          f"against the main path's epoch 1 {main['epoch1_s']:.3f} s over "
          f"the same files; hit/late/miss {e0['hits']}/{e0['late']}/"
          f"{e0['misses']}, {placed} adopts; epoch 1 {e1['s']:.4f} s, "
          f"{e1['device_tier_hits']} device-tier hits; epoch 0's block "
          f"ready p50 "
          f"{ready['p50'] * 1e3:.3f} ms, p99 {ready['p99'] * 1e3:.3f} ms; "
          f"scan K={k} over the shuffled epoch {scan_ms:.2f} ms, acc {got} "
          f"== main path == plain; launches {launches}", flush=True)
    return out


# -- master phase -------------------------------------------------------------
def stop_cluster(main: dict) -> None:
    """Close the main path's client, stop its cluster and remove the
    cluster's directory (the worker's MEM tier), once."""
    from alluxio_tpu_torch.conf import Keys

    cluster = main.pop("cluster", None)
    if cluster is None:
        return
    main.pop("fs").close()
    cluster.stop()
    shutil.rmtree(cluster.conf.get(Keys.HOME), ignore_errors=True)


def _client_latencies(clients: dict, n_dirs: int, per_dir: int) -> dict:
    """Each client makes ``per_dir`` empty files in each of its own
    ``n_dirs`` directories (``/meta/<name>/dNN``): create_file +
    complete_file, get_status of each, list_status of each directory
    five times; per-call ms (p50, p99) of each, by client. The clients
    take turns call by call, the first of each pair alternating, after an
    untimed warm-up of each, so that every client does the same work in
    the same conditions."""
    names = list(clients)
    dirs = {name: [f"/meta/{name}/d{j:02d}" for j in range(n_dirs)]
            for name in names}
    ops = ("create_complete", "get_status", "list_status")
    samples = {name: {op: [] for op in ops} for name in names}
    for name, client in clients.items():
        for d in dirs[name]:
            client.create_directory(d, recursive=True)
        for _ in range(20):
            client.get_status(dirs[name][0])
            client.list_status(dirs[name][0])

    def turns(op: str, i: int, call) -> None:
        for name in (names if i % 2 == 0 else names[::-1]):
            t = time.perf_counter()
            got = call(clients[name], dirs[name])
            samples[name][op].append(time.perf_counter() - t)
            if op == "list_status" and len(got) != per_dir:
                fail(f"master phase: {name} listed {len(got)} entries, "
                     f"want {per_dir}")

    files = [(d, j) for d in range(n_dirs) for j in range(per_dir)]
    for i, (d, j) in enumerate(files):
        turns("create_complete", i, lambda c, ds: (
            c.create_file(f"{ds[d]}/f-{j:03d}"),
            c.complete_file(f"{ds[d]}/f-{j:03d}", length=0)))
    for i, (d, j) in enumerate(files):
        turns("get_status", i,
              lambda c, ds: c.get_status(f"{ds[d]}/f-{j:03d}"))
    for i in range(5 * n_dirs):
        turns("list_status", i,
              lambda c, ds: c.list_status(ds[i % n_dirs]))
    return {name: {op: {"calls": len(v), "p50_ms": pct(sorted(v), 50) * 1e3,
                        "p99_ms": pct(sorted(v), 99) * 1e3}
                   for op, v in samples[name].items()}
            for name in names}


#: the master's two transports, in the order 2d and 2g time them
TRANSPORTS = ("grpc", "fastpath")


def transport_latencies(name: str, address: str, fast_dir: str) -> dict:
    """``_client_latencies`` of ``MASTER_FILES`` empty files in
    ``MASTER_DIRS`` directories through a gRPC client and a same-host
    fast-path client of the master at ``address`` (its socket under
    ``fast_dir``), each held to its transport before and after."""
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    clients = {"grpc": FsMasterClient(address, fastpath=False),
               "fastpath": FsMasterClient(address, fastpath_dir=fast_dir)}
    per_dir = MASTER_FILES // MASTER_DIRS
    out = {"files": MASTER_FILES, "dirs": MASTER_DIRS,
           "files_per_dir": per_dir}
    try:
        for transport, client in clients.items():
            if client.transport != transport:
                fail(f"{name}: the {transport} client sends over "
                     f"{client.transport} (fast-path sockets under "
                     f"{fast_dir})")
        out.update(_client_latencies(
            clients, MASTER_DIRS // len(clients), per_dir))
        for transport, client in clients.items():
            if client.transport != transport:
                fail(f"{name}: the {transport} client fell back to "
                     f"{client.transport}")
    finally:
        for client in clients.values():
            client.close()
    return out


def master_phase(device, main: dict, k: int) -> dict:
    """(2d): the port's master on the main path's cluster at full size —
    metadata RPC latencies over gRPC and over the same-host fast path, a
    restart on the same journal, and a loader epoch over the shards by
    the restarted master's block ids."""
    import torch

    from alluxio_tpu_torch import native
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    t_phase = time.perf_counter()
    cluster, fs = main["cluster"], main["fs"]
    files = main["files"]
    before = {p: fs.get_status(p) for p in files}
    out = transport_latencies(
        "master phase", cluster.master.address,
        cluster.conf.get(Keys.MASTER_FASTPATH_DIR))
    out["shards"] = len(files)
    n_meta = sum(len(fs.list_status(f"/meta/{name}/d{j:02d}"))
                 for name in TRANSPORTS
                 for j in range(MASTER_DIRS // len(TRANSPORTS)))
    if n_meta != MASTER_FILES:
        fail(f"master phase: {n_meta} files under /meta, want "
             f"{MASTER_FILES}")
    fs.close()

    # restart on the same journal: the new master replays it, the worker
    # re-registers on the master's REGISTER answer to its heartbeat
    sequence = cluster.master.journal.sequence
    native.reset_counts()
    t0 = time.perf_counter()
    cluster.restart_master()
    restart_s = time.perf_counter() - t0
    replay_s = cluster.master.replay_s
    if cluster.master.journal.sequence != sequence:
        fail(f"master phase: replay reached sequence "
             f"{cluster.master.journal.sequence}, want {sequence}")
    if not native.loaded() or native.plain_calls()["scan"]:
        fail(f"master phase: the journal replay did not scan natively "
             f"(loaded {native.loaded()}, plain {native.plain_calls()})")
    t0 = time.perf_counter()
    cluster.workers[0].worker.heartbeat()
    register_s = time.perf_counter() - t0
    fs = main["fs"] = cluster.file_system()
    for path, st in before.items():
        now = fs.get_status(path)
        if (now.block_ids, now.length) != (st.block_ids, st.length) or \
                now.in_memory_percentage != 100:
            fail(f"master phase: {path} after the restart has blocks "
                 f"{now.block_ids} ({now.length} B, "
                 f"{now.in_memory_percentage} % in memory), before "
                 f"{st.block_ids} ({st.length} B)")
    n = len(files)
    loader = DeviceBlockLoader(fs, list(files), device=device,
                               hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                               prefetch=2, dtype=np.int32)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = list(loader.epoch())
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        check_order("master phase epoch", blocks,
                    [SimpleNamespace(path=p) for p in files], main)
        x = torch.cat(blocks)
        del blocks
        rk.launches = 0
        acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
        launches = rk.launches
        got = int(acc)
    finally:
        loader.close()
    plain = int(chain(rk.scaled_sum_reference, x, k))
    del x
    if launches != k:
        fail(f"master phase launched scaled_sum {launches} times, want {k}")
    if not got == main["chain"] == plain:
        fail(f"master phase scan: kernel chain {got}, main path's chain "
             f"{main['chain']}, plain chain {plain}")
    out.update({"journal_entries": sequence, "restart_s": restart_s,
                "replay_s": replay_s,
                "register_s": register_s, "epoch_s": epoch_s,
                "scan_ms": scan_ms, "scan_launches": launches,
                "chain": got, "s": time.perf_counter() - t_phase})
    lat = "; ".join(
        f"{name}: " + ", ".join(
            f"{op} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
            for op, v in out[name].items())
        for name in TRANSPORTS)
    print(f"master: {MASTER_FILES} empty files in {MASTER_DIRS} "
          f"directories ({out['dirs'] // len(TRANSPORTS)} a transport, "
          f"{out['files_per_dir']} files each, the "
          f"transports' calls alternating) beside the {n} shards, per "
          f"call ({lat}); restart "
          f"on the same journal {restart_s:.3f} s (stop, replay, serve), "
          f"replay of {sequence} entries {replay_s:.3f} s (native frame "
          f"scan), worker re-registered in {register_s:.3f} s, "
          f"{n} shards with the same block ids; epoch {epoch_s:.3f} s, "
          f"scan K={k} {scan_ms:.2f} ms, acc {got} == main path == plain; "
          f"launches {launches}; phase {out['s']:.1f} s", flush=True)
    return out



# -- suite phase (2e) ---------------------------------------------------------
def suite_random_4k(device, main: dict) -> dict:
    """(2e a): BASELINE config #2 on the main path's live cluster, as
    ``bench.py`` runs it after the headline on the same client: 4 shards of
    ``min(BLOCK_BYTES, 64 MiB)``, 4096 seeded 4 KiB reads, batches of 256
    copied to the card. The stage itself holds every device batch against
    the files' bytes."""
    from alluxio_tpu_torch.stress import tpu_suite

    t0 = time.perf_counter()
    row = tpu_suite.config2_random_4k(main["fs"], device,
                                      shard_bytes=min(BLOCK_BYTES, 64 << 20))
    row["s"] = time.perf_counter() - t0
    print(f"suite #2 random 4k: {row['value']} MB/s ({row['ops_per_s']} "
          f"reads/s) against the adjacent ceiling {row['ceiling_mb_per_s']} "
          f"MB/s (one read_all of a shard and one copy to the card): "
          f"{row['achieved_vs_ceiling']} of it, vs_baseline "
          f"{row['vs_baseline']} (1.0 = half the ceiling); "
          f"{row['batches_checked']} device batches equal the files; "
          f"stage {row['s']:.1f} s", flush=True)
    return row


def suite_prefetch(device, k: int) -> dict:
    """(2e b): BASELINE config #3 on its own cluster (two workers, the job
    service, 4 MiB blocks, a MEM tier a worker of the corpus plus 128 MiB,
    block heartbeats at 50 ms, all under ``/dev/shm``) at the main path's
    corpus: a warm reference streamed to the card, the corpus freed, a
    ``load`` job, the loaded set streamed to the card. The stage checks
    the job, the block count, the locations and their spread, and that
    the stream reads nothing from the UFS; here the loaded set must equal
    the warm set on the card, and ``K`` chained ``scaled_sum`` calls over
    it must equal the plain chain and the plain chain over the warm set.
    The timed load runs untraced at the suite's settings; its seconds are
    split between the tasks' commit waits (``Job.LoadCommitWait``) and
    the worker's fetches (``Worker.UfsFetchTime``). A second run of the
    whole config is traced, with a ring that holds all of its spans
    (``atpu.trace.ring.capacity`` ``SUITE_TRACE_RING``) and the worker's
    metrics heartbeat held off (it drains the ring and ships the spans
    to the master, which keeps none): the fetch spans' phases split its
    load, and the spans begun after its last fetch ended are the
    post-load ``read_all`` streams'. Its load seconds are reported apart
    from the timed load's."""
    import torch

    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.stress import tpu_suite
    from alluxio_tpu_torch.utils import tracing

    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    files, file_bytes = SUITE_FILES, BLOCK_BYTES
    # the UFS copy and one cached copy, and room to spare
    need = 2 * files * file_bytes + (256 << 20)
    print(f"suite #3: /dev/shm free {free} bytes, the phase needs {need}",
          flush=True)
    if free < need:
        files = max(2, (free - (256 << 20)) // (2 * file_bytes))
        print(f"suite #3: CUT to {files} files of {file_bytes >> 20} MiB "
              f"to fit /dev/shm", flush=True)

    def loaded_equals_warm(warm, loaded):
        x = torch.cat([t.view(torch.int32) for t in loaded])
        w = torch.cat([t.view(torch.int32) for t in warm])
        if not torch.equal(x, w):
            fail("suite #3: the loaded set differs from the warm set on "
                 "the card")
        return x, w

    def consumer(warm, loaded):
        x, w = loaded_equals_warm(warm, loaded)
        acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
        got = int(acc)
        plain = int(chain(rk.scaled_sum_reference, x, k))
        warm_plain = int(chain(rk.scaled_sum_reference, w, k))
        del x, w
        if not got == plain == warm_plain:
            fail(f"suite #3 scan: kernel chain {got}, plain chain {plain}, "
                 f"plain chain over the warm set {warm_plain}")
        return {"scan_ms": scan_ms, "chain": got, "equal": True,
                "bytes": sum(t.numel() for t in loaded)}

    def equal_only(warm, loaded):
        loaded_equals_warm(warm, loaded)
        return {"equal": True}

    def totals():
        m = metrics()
        return [m.timer(name).histogram()[1:]
                for name in ("Job.LoadCommitWait", "Worker.UfsFetchTime")]

    t0 = time.perf_counter()
    before = totals()
    rk.launches = 0
    row = tpu_suite.config3_prefetch(device, file_bytes=file_bytes,
                                     num_files=files, consumer=consumer)
    launches = rk.launches
    (wait_s, waits), (fetch_s, fetches) = [
        (s1 - s0, n1 - n0) for (s0, n0), (s1, n1) in zip(before, totals())]
    row["s"] = time.perf_counter() - t0
    if launches != k:
        fail(f"suite #3 launched scaled_sum {launches} times, want {k}")
    blocks = row["num_blocks"]
    if waits != blocks or fetches != blocks:
        fail(f"suite #3: {waits} commit waits and {fetches} fetches for "
             f"{blocks} loaded blocks")

    # the traced run: the same config, every span kept in the ring
    t1 = time.perf_counter()
    tracing.tracer().clear()
    try:
        traced = tpu_suite.config3_prefetch(
            device, file_bytes=file_bytes, num_files=files,
            consumer=equal_only,
            conf_overrides={
                Keys.TRACE_ENABLED: True,
                Keys.TRACE_RING_CAPACITY: SUITE_TRACE_RING,
                Keys.WORKER_METRICS_HEARTBEAT_INTERVAL: "1h"})
        spans = tracing.tracer().drain(SUITE_TRACE_RING)
    finally:
        tracing.set_tracing_enabled(False)
    traced_s = time.perf_counter() - t1
    if len(spans) >= SUITE_TRACE_RING:
        fail(f"suite #3: the trace ring filled ({len(spans)} spans)")
    fetches_traced = [sp for sp in spans
                      if sp["name"] == "atpu.worker.ufs_fetch"]
    if len(fetches_traced) != traced["num_blocks"]:
        fail(f"suite #3: {len(fetches_traced)} fetch spans for "
             f"{traced['num_blocks']} blocks of the traced load")
    phases = {}
    for span in fetches_traced:
        for name, ms in span.get("phases", ()):
            phases[name] = phases.get(name, 0.0) + ms
    load_end = max(sp["start_ms"] + sp["duration_ms"]
                   for sp in fetches_traced)
    post_load = {}
    for sp in spans:
        if sp["start_ms"] > load_end:
            count, ms = post_load.get(sp["name"], (0, 0.0))
            post_load[sp["name"]] = (count + 1, ms + sp["duration_ms"])
    row.update({"files": files, "file_bytes": file_bytes,
                "launches": launches,
                "commit_wait_s": wait_s,
                "commit_wait_ms_per_block": 1e3 * wait_s / blocks,
                "fetch_s": fetch_s,
                "fetch_ms_per_block": 1e3 * fetch_s / blocks,
                "traced_load": {
                    "blocks": traced["num_blocks"],
                    "load_seconds": traced["load_seconds"],
                    "post_load_mb_per_s": traced["value"],
                    "worker_metrics_heartbeat": "held off",
                    "s": traced_s,
                    "spans": len(spans), "ring": SUITE_TRACE_RING,
                    "fetch_span_ms_per_block": sum(
                        sp["duration_ms"] for sp in fetches_traced)
                    / len(fetches_traced),
                    "phase_ms_per_block": {
                        n: ms / len(fetches_traced)
                        for n, ms in phases.items()},
                    "post_load_spans": {
                        n: {"count": c, "ms": ms}
                        for n, (c, ms) in sorted(post_load.items())}}})
    tl = row["traced_load"]
    busiest = sorted(post_load.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"suite #3 prefetch: {files} x {file_bytes >> 20} MiB, {blocks} "
          f"blocks of 4 MiB; warm reference {row['warm_reference_mb_per_s']} "
          f"MB/s; load job {row['load_seconds']} s "
          f"({row['prefetch_mb_per_s']} MB/s, untraced), blocks by host "
          f"{row['blocks_by_host']}; post-load stream {row['value']} MB/s, "
          f"vs_baseline {row['vs_baseline']} (1.0 = 0.7 of the warm "
          f"reference), no UFS read, the loaded set equal to the warm set "
          f"on the card; load split: {blocks} commit waits "
          f"{wait_s:.3f} s in all, "
          f"{row['commit_wait_ms_per_block']:.2f} ms a block, against "
          f"{blocks} fetches {row['fetch_ms_per_block']:.2f} ms a block; "
          f"scan K={k} {row['consumer']['scan_ms']:.2f} ms, acc "
          f"{row['consumer']['chain']} == plain == warm set's plain; "
          f"launches {launches}; stage {row['s']:.1f} s", flush=True)
    print(f"suite #3 traced run (worker metrics heartbeat held off): load "
          f"job {tl['load_seconds']} s, post-load stream "
          f"{tl['post_load_mb_per_s']} MB/s, the loaded set equal to the "
          f"warm set on the card; {tl['spans']} spans in a ring of "
          f"{SUITE_TRACE_RING}: fetch spans "
          f"{tl['fetch_span_ms_per_block']:.2f} ms a block "
          f"({', '.join(f'{n} {v:.2f}' for n, v in tl['phase_ms_per_block'].items())}), "
          f"after the load "
          f"{', '.join(f'{n} x{c} {ms:.1f} ms' for n, (c, ms) in busiest)}; "
          f"stage {traced_s:.1f} s", flush=True)
    return row


def suite_write_eviction(main: dict) -> dict:
    """(2e c): BASELINE config #5 at ``write_bench.run()``'s defaults (24 x
    8 MiB ASYNC_THROUGH by 4 threads into a 64 MiB MEM tier over an SSD
    tier, LRFU) on its own cluster under ``/dev/shm``, graded against the
    main path's cold-write rate. The stage checks that there is no error
    and no unpersisted file, that the SSD tier holds spilled bytes, and
    reads every file back through the cluster and from its UFS file,
    each against its own payload."""
    from alluxio_tpu_torch.stress import tpu_suite

    cold_rate = NUM_BLOCKS * BLOCK_BYTES / main["cold_write_s"]
    t0 = time.perf_counter()
    row = tpu_suite.config5_write_eviction(cold_write_rate=cold_rate)
    row["s"] = time.perf_counter() - t0
    print(f"suite #5 write-through eviction: ingest {row['value']} MB/s "
          f"against the main path's cold write "
          f"{row['unpressured_cold_write_mb_per_s']} MB/s, vs_baseline "
          f"{row['vs_baseline']} (1.0 = half of it); durable after "
          f"{row['time_to_durable_s']} s, {row['unpersisted']} unpersisted; "
          f"tiers' used bytes {row['tier_used_bytes']}; "
          f"{row['read_back_files']} files read back equal through the "
          f"cluster and from the UFS; stage {row['s']:.1f} s", flush=True)
    return row


# -- table read path (2e d) ---------------------------------------------------
def _projection_line(name: str, row: dict) -> None:
    print(f"{name}: {row['value']}x speedup of the 3-of-23-column projection "
          f"into device memory over the full scan, vs_baseline "
          f"{row['vs_baseline']} (1.0 = 3x); full scan {row['full_scan_s']} s "
          f"({row['full_bytes']} decoded bytes), projection "
          f"{row['projection_s']} s ({row['projected_bytes']} bytes on the "
          f"card); {row['file_bytes']} Parquet bytes; "
          f"{row['columns_checked']} projected columns equal the table's on "
          f"the card; stage {row['s']:.1f} s", flush=True)


def suite_projection(device, main: dict) -> dict:
    """(2e d, bench size): BASELINE config #4 at ``bench.py``'s parameters
    (2 partitions x 30 000 rows) on the main path's live cluster, as the
    reference's ``run_all`` runs it. The stage holds every projected
    column on the card against the table's."""
    from alluxio_tpu_torch.stress import tpu_suite

    t0 = time.perf_counter()
    row = tpu_suite.config4_projection(main["fs"], device)
    row["s"] = time.perf_counter() - t0
    _projection_line("suite #4 projection (2 x 30 000 rows, main cluster)",
                     row)
    return row


def suite_projection_real(device) -> dict:
    """(2e d, real size): config #4 at ``PROJECTION_PARTITIONS`` x
    ``PROJECTION_ROWS`` rows of the same schema, on a cluster of its own
    (one worker, a MEM tier of the table plus 256 MiB in ``/dev/shm``,
    32 MiB blocks). Partitions are cut only when ``/dev/shm`` lacks the
    room, and the cut is printed."""
    from alluxio_tpu_torch.stress import tpu_suite
    from alluxio_tpu_torch.stress.cluster import bench_cluster

    parts = PROJECTION_PARTITIONS
    # a 23-column row is 96 bytes decoded; Parquet adds under a tenth
    part_bytes = PROJECTION_ROWS * 96 * 11 // 10
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    need = parts * part_bytes + (512 << 20)
    print(f"suite #4: /dev/shm free {free} bytes, the real-size table needs "
          f"{need}", flush=True)
    if free < need:
        parts = max(2, (free - (512 << 20)) // part_bytes)
        print(f"suite #4: CUT to {parts} partitions of {PROJECTION_ROWS} "
              f"rows to fit /dev/shm", flush=True)
    t0 = time.perf_counter()
    with bench_cluster(block_size=BLOCK_BYTES,
                       worker_mem_bytes=parts * part_bytes + (256 << 20)
                       ) as (fs, _cluster):
        row = tpu_suite.config4_projection(fs, device,
                                           rows_per_part=PROJECTION_ROWS,
                                           partitions=parts)
    row["s"] = time.perf_counter() - t0
    row["partitions"] = parts
    row["rows_per_part"] = PROJECTION_ROWS
    _projection_line(f"suite #4 projection ({parts} x {PROJECTION_ROWS} "
                     f"rows, own cluster)", row)
    return row


def suite_pushdown() -> dict:
    """(2e d, pushdown): ``table_bench.run_pushdown`` at its defaults (4 x
    40 000 rows of the 23-column store_sales table, 3 repeats, a modeled
    2 ms, 1000 Mb/s wire): the planned and the legacy path over the same
    warm table. It fails when the planned path's table differs from the
    legacy path's; the bench's own 2x gate is printed."""
    from alluxio_tpu_torch.stress import table_bench

    t0 = time.perf_counter()
    r = table_bench.run_pushdown()
    m = r.metrics
    out = {"params": r.params, "metrics": m, "errors": r.errors,
           "s": time.perf_counter() - t0}
    if not m["byte_identical"]:
        fail("pushdown: the planned path's table differs from the legacy "
             "path's")
    gate = "met" if m["speedup"] >= r.params["min_speedup"] else "MISSED"
    print(f"pushdown (4 x 40 000 rows, 3 of 23 columns, modeled 2 ms RTT): "
          f"planned {m['planned_ms']} ms against legacy {m['legacy_ms']} ms "
          f"a read of the table, {m['speedup']}x (the bench's "
          f"{r.params['min_speedup']}x gate {gate}), "
          f"{m['projected_mb_per_s']} MB/s projected; planned table equal "
          f"to the legacy one; stage {out['s']:.1f} s", flush=True)
    return out


# -- clairvoyant prefetch bench (2f) ------------------------------------------
def clairvoyant_phase(device) -> dict:
    """(2f): ``prefetch_bench.run_clairvoyant`` on the card, at the JAX
    defaults (4 x 8 MiB in 1 MiB blocks, lookahead 16, 128 MiB budget,
    every placement in DRAM) and at the main path's corpus (64 x 32 MiB in
    32 MiB blocks, lookahead 16, a 512 MiB budget, ``hbm_fraction``
    0.25), two epochs each; the file count of the second is cut only if
    ``/dev/shm`` lacks the room. Every consumed block must equal its
    file's bytes (the bench checks, on the card)."""
    from alluxio_tpu_torch.stress import prefetch_bench

    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    files = NUM_BLOCKS
    need = 2 * files * BLOCK_BYTES + (512 << 20)
    print(f"clairvoyant: /dev/shm free {free} bytes, the corpus run needs "
          f"{need}", flush=True)
    if free < need:
        files = max(4, (free - (512 << 20)) // (2 * BLOCK_BYTES))
        print(f"clairvoyant: CUT to {files} files of {BLOCK_BYTES >> 20} "
              f"MiB to fit /dev/shm", flush=True)
    runs = {}
    for name, kw in (
            ("defaults", {}),
            ("corpus", dict(num_files=files, file_bytes=BLOCK_BYTES,
                            block_size=BLOCK_BYTES,
                            lookahead_blocks=PREFETCH_LOOKAHEAD,
                            budget_bytes=512 << 20, hbm_fraction=0.25))):
        t0 = time.perf_counter()
        r = prefetch_bench.run_clairvoyant(device=device, **kw)
        m = r.metrics
        runs[name] = {"params": r.params, "metrics": m,
                      "s": time.perf_counter() - t0}
        if m["block_mismatches"] or m["blocks_checked"] != \
                r.params["epochs"] * m["blocks_per_epoch"]:
            fail(f"clairvoyant {name}: {m['block_mismatches']} of "
                 f"{m['blocks_checked']} consumed blocks differ from their "
                 f"files")
        stalls = {k[len("stall_"):-2]: v for k, v in m.items()
                  if k.startswith("stall_") and k.endswith("_s")}
        p = r.params
        print(f"clairvoyant {name} ({p['num_files']} x "
              f"{p['file_bytes'] >> 20} MiB in {p['block_size'] >> 20} MiB "
              f"blocks, lookahead {p['lookahead_blocks']}, budget "
              f"{p['budget_bytes'] >> 20} MiB, hbm_fraction "
              f"{p['hbm_fraction']}, {p['epochs']} epochs): hit rate "
              f"{m['hit_rate']} ({m['hits']} / {m['late']} / {m['misses']} "
              f"hit/late/miss, {m['late_arrivals']} late arrivals), block "
              f"ready p50 {m['p50_block_ready_ms']} ms p99 "
              f"{m['p99_block_ready_ms']} ms, {m['gb_per_s']} GB/s; stalls "
              f"{stalls} s, input-bound {m['input_bound_fraction']}, "
              f"verdict: {m['stall_verdict']}; {m['blocks_checked']} "
              f"consumed blocks equal their files on the card; "
              f"{runs[name]['s']:.1f} s", flush=True)
    return runs


# -- page-cache phase ---------------------------------------------------------
def page_cache_phase(device, workdir: str, main: dict) -> dict:
    """(2b): ``LocalCacheManager.get_device`` over every page of the main
    path's files, the host tier evicting below a device tier that holds
    them all."""
    import torch

    from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
    from alluxio_tpu_torch.client.cache.manager import LocalCacheManager
    from alluxio_tpu_torch.client.cache.meta import PageId
    from alluxio_tpu_torch.client.cache.page_store import LocalPageStore
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    files = main["files"]
    per_file = BLOCK_BYTES // PAGE_BYTES
    n_pages = len(files) * per_file
    m = metrics()
    hits = m.counter("Client.HbmPageHits")
    promotions = m.counter("Client.HbmPagePromotions")
    evictions = m.counter("Client.PagesEvicted")
    views = {p: np.memmap(f, np.uint8, "r") for p, (_, f) in files.items()}
    cache = LocalCacheManager(
        LocalPageStore(os.path.join(workdir, "pc")),
        capacity_bytes=PAGE_CACHE_BYTES, page_size=PAGE_BYTES,
        evictor="LRU",
        hbm_store=HbmPageStore(len(files) * BLOCK_BYTES + (64 << 20),
                               device=device))
    # pass 1's host time, split by the store calls it spends it in (the
    # device put's share is its host side: staging copy and enqueue)
    spent = {"page_file_write": 0.0, "page_file_delete": 0.0,
             "device_put": 0.0}

    def clocked(fn, key):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return run

    store, hbm = cache._store, cache.hbm
    store.put = clocked(store.put, "page_file_write")
    store.delete = clocked(store.delete, "page_file_delete")
    hbm.put = clocked(hbm.put, "device_put")
    passes = []
    try:
        for p in range(2):
            if p == 1:  # pass 2 unclocked (it calls none of them)
                del store.put, store.delete, hbm.put
            h0, p0, e0 = hits.count, promotions.count, evictions.count
            pages = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for path, (fid, _) in files.items():
                for i in range(per_file):
                    lease = cache.get_device(
                        PageId(f"{fid:x}", i),
                        host_fallback=lambda v=views[path], i=i:
                        v[i * PAGE_BYTES:(i + 1) * PAGE_BYTES])
                    if lease is None or lease.array.device != device:
                        fail(f"page cache pass {p + 1}: page {i} of {path} "
                             f"not served from the device tier")
                    pages.append(lease.array)
                    lease.close()
            torch.cuda.synchronize()
            passes.append({"pass": p + 1, "s": time.perf_counter() - t,
                           "hits": hits.count - h0,
                           "promotions": promotions.count - p0,
                           "host_evictions": evictions.count - e0})
        one, two = passes
        if (one["promotions"], one["hits"]) != (n_pages, 0) or \
                (two["promotions"], two["hits"]) != (0, n_pages):
            fail(f"page cache: passes {passes}, want {n_pages} promotions "
                 f"then {n_pages} device hits")
        for j, path in enumerate(files):
            got = torch.cat(pages[j * per_file:(j + 1) * per_file])
            if not torch.equal(got.view(torch.int32), main["blocks"][j]):
                fail(f"page cache: the pages of {path} differ from its "
                     f"device block")
        rk.launches = 0
        got = int(rk.scaled_sum(torch.cat(pages).view(torch.int32), 1))
        launches = rk.launches
        stats = cache.stats()
    finally:
        cache.close()
    whole = torch.cat(main["blocks"])
    kernel, plain = int(rk.scaled_sum(whole, 1)), \
        int(rk.scaled_sum_reference(whole, 1))
    if not got == kernel == plain:
        fail(f"page cache scan: {got}, main path's set: kernel {kernel}, "
             f"plain {plain}")
    one["ms_per_page"] = {k: v * 1e3 / n_pages for k, v in spent.items()}
    one["ms_per_page"]["rest"] = \
        (one["s"] - sum(spent.values())) * 1e3 / n_pages
    out = {"pages": n_pages, "page_bytes": PAGE_BYTES,
           "host_capacity_bytes": PAGE_CACHE_BYTES, "evictor": "LRU",
           "passes": passes, "host_bytes_after": stats["host_bytes"],
           "scan_launches": launches, "scaled_sum": got}
    print(f"page cache: {n_pages} pages of {PAGE_BYTES >> 20} MiB, host "
          f"tier {PAGE_CACHE_BYTES >> 20} MiB LRU; pass 1 {one['s']:.3f} s "
          f"({one['promotions']} promotions, {one['host_evictions']} host "
          f"evictions; ms a page: "
          + ", ".join(f"{k} {v:.4f}" for k, v in one["ms_per_page"].items())
          + f"), pass 2 {two['s']:.4f} s ({two['hits']} device hits); "
          f"every file's pages equal its device block; scaled_sum {got} "
          f"== main path's set (kernel and plain)", flush=True)
    return out


# -- worker phase -------------------------------------------------------------
class StandInBlockMaster:
    """Stands in for the block master until its slice is ported: the calls
    a worker makes (``get_worker_id``, ``register``, ``heartbeat``,
    ``commit_block``) and those of the prefetch executor
    (``get_worker_infos``, ``get_block_info(s)``), answered from what the
    worker told it. Like the JAX master it knows a block from a commit or
    from a persisted file (``know_blocks``) only: a heartbeat that reports
    an unknown block gets a FREE for it, so a delta that outran its commit
    would lose the block."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self.address = None
        self.capacity = {}
        self.used = {}
        self.lengths = {}     # known blocks: id -> length
        self.locations = {}   # located blocks: id -> tier
        self.commits = 0
        self.freed = []       # blocks a heartbeat reported before commit

    def get_worker_id(self, address) -> int:
        self.address = address
        return 1

    def register(self, worker_id, capacity, used, blocks, address=None):
        with self._lock:
            self.capacity, self.used = dict(capacity), dict(used)
            self.locations = {b: t for t, ids in blocks.items()
                              for b in ids if b in self.lengths}

    def heartbeat(self, worker_id, used, added, removed,
                  metrics_snapshot=None) -> dict:
        with self._lock:
            self.used = dict(used)
            for b in removed:
                self.locations.pop(b, None)
            free = [b for ids in added.values() for b in ids
                    if b not in self.lengths]
            self.locations.update((b, t) for t, ids in added.items()
                                  for b in ids if b in self.lengths)
            self.freed += free
        if free:
            return {"command": "FREE", "data": free}
        return {"command": "NOTHING", "data": []}

    def commit_block(self, worker_id, used_on_tier, tier, block_id,
                     length) -> None:
        with self._lock:
            self.lengths[block_id] = length
            self.locations[block_id] = tier
            self.used[tier] = used_on_tier
            self.commits += 1

    def know_blocks(self, lengths: dict) -> None:
        with self._lock:
            self.lengths.update(lengths)

    def get_worker_infos(self):
        from alluxio_tpu_torch.utils.wire import WorkerInfo

        with self._lock:
            return [WorkerInfo(
                id=1, address=self.address,
                capacity_bytes=sum(self.capacity.values()),
                used_bytes=sum(self.used.values()),
                capacity_bytes_on_tiers=dict(self.capacity),
                used_bytes_on_tiers=dict(self.used),
                block_count=len(self.locations))]

    def get_block_info(self, block_id):
        from alluxio_tpu_torch.utils.wire import BlockInfo, BlockLocation

        with self._lock:
            tier = self.locations.get(block_id)
            return BlockInfo(
                block_id=block_id, length=self.lengths.get(block_id, 0),
                locations=[] if tier is None else [BlockLocation(
                    worker_id=1, address=self.address, tier_alias=tier)])

    def get_block_infos(self, block_ids):
        return [self.get_block_info(b) for b in block_ids]


class WorkerFS:
    """Stands in for the file master until its slice: each path is one
    block (id ``block_id(container, 0)`` from the port's ``utils/ids``),
    persisted at its block file under mount ``WORKER_MOUNT_ID``. Each
    block's stream comes from the port's ``BlockStoreClient`` ladder
    (``open_block``), given the block master's ``BlockInfo`` and the
    block's UFS descriptor; the rung that served it is counted and the
    open timed. ``route``: ``"lease"`` is the client with the SHM plane
    off (the ladder's disabled path: a located block is leased by short
    circuit), ``"shm"`` the JAX defaults (a located block is leased and
    mapped through the SHM plane), ``"grpc"`` short circuit off (a
    located block is read remotely). An unlocated block takes the UFS
    rung on every route. ``stripe_size`` overrides the remote rung's
    stripe size (0: one stream a read). The client names the OS user to
    the worker as its principal."""

    RUNGS = {"lease": "lease", "shm": "shm", "grpc": "remote"}

    def __init__(self, files: dict, first_container: int, master, *,
                 route: str = "lease",
                 stripe_size: "int | None" = None) -> None:
        from alluxio_tpu_torch.client.block_store import BlockStoreClient
        from alluxio_tpu_torch.conf import Configuration, Keys
        from alluxio_tpu_torch.utils import ids

        self._ids = ids
        self._files = {path: (first_container + i, block_file)
                       for i, (path, (_, block_file)) in
                       enumerate(files.items())}
        self.block_master = master
        self.fs_master = SimpleNamespace(
            get_file_block_info_list=self._block_infos)
        self.route = route
        conf = Configuration(load_env=False)
        conf.set(Keys.USER_SHM_ENABLED, route == "shm")
        if stripe_size is not None:
            conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, stripe_size)
        self.store = BlockStoreClient.from_conf(
            master, conf, short_circuit=route != "grpc")
        self.session_id = ids.create_session_id()
        self.rungs = {}
        self.opens = 0
        self.open_s = 0.0

    def block_id(self, path: str) -> int:
        return self._ids.block_id(self._files[path][0], 0)

    def block_lengths(self) -> dict:
        return {self.block_id(p): os.path.getsize(f)
                for p, (_, f) in self._files.items()}

    def get_status(self, path):
        cid, block_file = self._files[path]
        return SimpleNamespace(
            path=path, file_id=self._ids.file_id_from_container(cid),
            block_ids=[self.block_id(path)], ufs_path=block_file,
            mount_id=WORKER_MOUNT_ID, persisted=True,
            length=os.path.getsize(block_file))

    def _block_infos(self, path):
        return [SimpleNamespace(offset=0, block_info=SimpleNamespace(
            block_id=self.block_id(path),
            length=os.path.getsize(self._files[path][1])))]

    def block_stream(self, path: str, *, with_ufs: bool = True):
        """``with_ufs=False`` opens without the UFS descriptor (a remote
        stream then batches small reads; a cold block has no rung)."""
        from alluxio_tpu_torch.utils.wire import FileBlockInfo

        block_file = self._files[path][1]
        length = os.path.getsize(block_file)
        info = self.block_master.get_block_info(self.block_id(path))
        info.length = length  # the file master's length
        t = time.perf_counter()
        stream = self.store.open_block(
            FileBlockInfo(block_info=info),
            ufs_info={"ufs_path": block_file, "offset": 0, "length": length,
                      "mount_id": WORKER_MOUNT_ID} if with_ufs else None)
        self.open_s += time.perf_counter() - t
        self.opens += 1
        self.rungs[stream.rung] = self.rungs.get(stream.rung, 0) + 1
        return stream

    def check_rungs(self, name: str, allowed=None) -> None:
        """Fail unless every block was served by the route's own rung
        (or by one of ``allowed``)."""
        allowed = allowed or {self.RUNGS[self.route]}
        if not self.rungs or set(self.rungs) - set(allowed):
            fail(f"{name}: blocks by rung {self.rungs}, want only "
                 f"{sorted(allowed)}")

    def open_file(self, path, info=None, max_open_streams=1):
        return _WorkerFile(self, path)

    def close(self) -> None:
        """Release the client's leases on the worker (after the loaders
        reading through it have closed)."""
        self.store.close()


class _WorkerFile:
    def __init__(self, fs: WorkerFS, path: str) -> None:
        self._fs = fs
        self._path = path
        self._stream = None

    def block_stream(self, index: int):
        if index != 0:
            fail(f"{self._path} holds one block, asked for {index}")
        if self._stream is None:
            self._stream = self._fs.block_stream(self._path)
        return self._stream

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def start_worker(workdir: str, tier_dir: str, tier_bytes: int, master, *,
                 qos: bool = False, sink_path: "str | None" = None,
                 web: bool = False):
    """The port's worker (one MEM tier of ``tier_bytes`` in ``tier_dir``,
    the main path's block files as its UFS) behind the port's RPC
    server on 127.0.0.1; returns (worker, server, client). ``qos``: worker
    QoS on with ``QOS_ASYNC_CACHE_THREADS`` async-cache threads, and the
    server authenticates every call (the worker's authenticator);
    ``sink_path``: a JSON-lines metrics sink there, one
    tick a ``SINK_INTERVAL``; ``web``: the web endpoint on port 0."""
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates
    from alluxio_tpu_torch.rpc.clients import WorkerClient
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.security.authentication import (
        worker_authenticator,
    )
    from alluxio_tpu_torch.underfs.registry import UfsManager
    from alluxio_tpu_torch.worker.process import BlockWorker

    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_TIERED_STORE_LEVELS, 1)
    conf.set(Keys.WORKER_HOSTNAME, "localhost")
    conf.set(Keys.WORKER_SHM_DIR, tier_dir)
    conf.set(Templates.WORKER_TIER_DIRS_PATH.format(0),
             os.path.join(tier_dir, "mem"))
    conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(0), str(tier_bytes))
    conf.set(Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL,
             f"{int(WORKER_HEARTBEAT_S * 1000)}ms")
    conf.set(Keys.WORKER_QOS_ENABLED, qos)
    if qos:
        conf.set(Keys.WORKER_ASYNC_CACHE_THREADS, QOS_ASYNC_CACHE_THREADS)
    if sink_path is not None:
        conf.set(Keys.METRICS_SINKS, "jsonl")
        conf.set(Keys.METRICS_SINK_JSONL_PATH, sink_path)
        conf.set(Keys.METRICS_SINK_INTERVAL, SINK_INTERVAL)
    if web:
        conf.set(Keys.WORKER_WEB_ENABLED, True)
        conf.set(Keys.WORKER_WEB_PORT, 0)
        conf.set(Keys.WORKER_WEB_BIND_HOST, "127.0.0.1")
    ufs = UfsManager()
    ufs.add_mount(WORKER_MOUNT_ID, workdir)
    worker = BlockWorker(conf, master, ufs_manager=ufs)
    server = RpcServer(bind_host="127.0.0.1", port=0,
                       authenticator=worker_authenticator(conf))
    server.add_service(worker_service(worker))
    worker.address.rpc_port = worker.address.data_port = server.start()
    worker.start()  # registers, then heartbeats
    return worker, server, WorkerClient(f"127.0.0.1:{worker.address.rpc_port}")


def h2d_ceiling(device) -> dict:
    """The host -> device ceiling: one pinned host buffer copied to the
    card asynchronously, no host work, CUDA-event time, at a block's size
    and at the working set's."""
    import torch

    out = {}
    for nbytes, reps in ((BLOCK_BYTES, 20), (NUM_BLOCKS * BLOCK_BYTES, 3)):
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        ms = time_ms(lambda: dev.copy_(host, non_blocking=True), reps=reps,
                     warmup=1)
        out[f"{nbytes >> 20}MiB"] = {"bytes": nbytes, "ms": ms,
                                     "gb_per_s": nbytes / ms / 1e6}
        del host, dev
    return out


def loader_read(name: str, device, fs, files: dict, main: dict, k: int,
                held, hits) -> dict:
    """A fresh loader over ``fs`` into the device tier: epoch 1 host ->
    device, epoch 2 all device-tier hits, then the K chained scans, equal
    to the main path's chain and the plain chain. ``held()`` reads what
    the worker holds for the loader while it is open."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    n = len(files)
    loader = DeviceBlockLoader(fs, list(files), device=device,
                               hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                               prefetch=2, dtype=np.int32)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = list(loader.epoch())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hits0 = hits.count
        blocks = list(loader.epoch())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        held_open = held()
        if hits.count - hits0 != n or \
                any(a is not b for a, b in zip(first, blocks)):
            fail(f"{name} epoch 2: {hits.count - hits0} device-tier hits, "
                 f"want {n}")
        check_order(name, blocks, [SimpleNamespace(path=p) for p in files],
                    main)
        del first
        x = torch.cat(blocks)
        rk.launches = 0
        acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
        launches = rk.launches
        got = int(acc)
    finally:
        loader.close()
    if launches != k:
        fail(f"{name} launched scaled_sum {launches} times, want {k}")
    plain = int(chain(rk.scaled_sum_reference, x, k))
    del x, blocks
    if not got == main["chain"] == plain:
        fail(f"{name} scan: kernel chain {got}, main path's chain "
             f"{main['chain']}, plain chain {plain}")
    return {"epoch1_s": t1 - t0, "epoch2_s": t2 - t1,
            "gb_per_s": n * BLOCK_BYTES / (t1 - t0) / 1e9,
            "main_path_epoch1_s": main["epoch1_s"], "device_tier_hits": n,
            "open_ms": fs.open_s * 1e3 / fs.opens, "held": held_open,
            "scan_ms": scan_ms, "scan_launches": launches, "chain": got}


def worker_phase(device, workdir: str, main: dict, k: int) -> dict:
    """(2c): the port's worker serves the main path's blocks through the
    port's ``BlockStoreClient`` ladder: a cold write-through by short
    circuit, warm reads by lease and through the SHM plane (traced) into
    fresh loaders and the warm scan, batched small reads on the remote
    and SHM rungs, the
    prefetch loop at the JAX defaults, its DRAM placements landing in the
    worker's MEM tier, and cold reads through the UFS rung."""
    from alluxio_tpu_torch import native
    from alluxio_tpu_torch.client.block_streams import LocalBlockOutStream
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.rpc.core import RpcChannel

    files = main["files"]
    n = len(files)
    # 2b's page files are not read again: give their room back
    shutil.rmtree(os.path.join(workdir, "pc"), ignore_errors=True)
    tier_bytes = (n + WORKER_SPARE_BLOCKS) * BLOCK_BYTES
    shm_free = None
    if Path("/dev/shm").is_dir():
        st = os.statvfs("/dev/shm")
        shm_free = st.f_bavail * st.f_frsize
    print(f"worker phase: /dev/shm free {shm_free} bytes; MEM tier "
          f"{tier_bytes} bytes", flush=True)
    ceiling = h2d_ceiling(device)
    print("host->device ceiling (pinned, no host work): " + ", ".join(
        f"{key} {c['ms']:.4f} ms ({c['gb_per_s']:.2f} GB/s)"
        for key, c in ceiling.items()) + f"; main path epoch 1 "
        f"{main['epoch1_s']:.3f} s "
        f"({n * BLOCK_BYTES / main['epoch1_s'] / 1e9:.2f} GB/s)", flush=True)
    tier_dir = block_dir(tier_bytes)
    master = StandInBlockMaster()
    sink_path = os.path.join(workdir, "worker-metrics.jsonl")
    worker, server, client = start_worker(workdir, tier_dir, tier_bytes,
                                          master, sink_path=sink_path,
                                          web=True)
    m = metrics()
    out = {"blocks": n, "block_bytes": BLOCK_BYTES, "tier_dir": tier_dir,
           "tier_bytes": tier_bytes, "dev_shm_free_bytes": shm_free,
           "heartbeat_s": WORKER_HEARTBEAT_S, "h2d_ceiling": ceiling}
    try:
        # (i) cold write-through by short circuit
        fs = WorkerFS(files, 1, master)
        views = {p: np.memmap(f, np.uint8, "r") for p, (_, f) in files.items()}
        t = time.perf_counter()
        for path in files:
            with LocalBlockOutStream(client, fs.session_id,
                                     fs.block_id(path),
                                     size_hint=BLOCK_BYTES) as stream:
                stream.write(views[path])
        write_s = time.perf_counter() - t
        del views
        time.sleep(3 * WORKER_HEARTBEAT_S)  # deltas reach the master
        report = worker.store.block_report()["MEM"]
        if sorted(report) != sorted(fs.block_lengths()) or \
                master.commits != n or master.freed:
            fail(f"worker cold write: {len(report)} blocks on the worker, "
                 f"{master.commits} commits, freed as orphans "
                 f"{master.freed}; want {n}, {n}, none")
        out["cold_write"] = {"s": write_s,
                             "gb_per_s": n * BLOCK_BYTES / write_s / 1e9,
                             "commits": master.commits}

        # (ii) warm read by the lease rung, then the warm scan
        sc = m.counter("Client.JaxShortCircuitBlocks")
        hits = m.counter("Client.JaxHbmHits")
        sc0 = sc.count
        read = loader_read("worker lease read", device, fs, files, main, k,
                           lambda: (worker.store.active_locks(),
                                    len(worker._short_circuit_leases)),
                           hits)
        fs.check_rungs("worker lease read")
        if sc.count - sc0 != n or read["held"] != (n, n):
            fail(f"worker lease read: {sc.count - sc0} short-circuit "
                 f"blocks, {read['held'][0]} read locks and "
                 f"{read['held'][1]} leases held while the loader is "
                 f"open, want {n} of each")
        released = worker.store.active_locks(), \
            len(worker._short_circuit_leases)
        if released != (0, 0):
            fail(f"worker lease read: {released[0]} read locks and "
                 f"{released[1]} leases left after the loader closed")
        out["lease_read"] = dict(read, short_circuit_blocks=n,
                                 rungs=dict(fs.rungs))
        launches = read["scan_launches"]

        # (ii') the same through the SHM rung, every block pre-faulted
        # by the native library
        out["shm_read"] = shm_read(device, files, master, worker, main, k,
                                   hits)

        # (iii) batched small reads on the remote and SHM rungs (the
        # route turns and the remote rung run on 2g's cluster)
        out["pread_many"] = pread_many_check(files, master)
        out["prefetch"] = worker_prefetch(device, worker, master, client,
                                          main, fs)
        from alluxio_tpu_torch.ops import reduce_kernel as rk

        rk.launches = 0
        out["cold_read"] = cold_turns(device, files, master, main, k)
        out["cold_launches"] = rk.launches
        out["coalesce"] = coalesce_turn(files, master, worker)
        out["fault_turn"] = fault_turn(device, files, master, worker,
                                       out["coalesce"].pop("paths"), main)
        out["web_and_sink"] = web_and_sink_check(worker, sink_path)
        fs.close()
        if any(native.plain_calls().values()):
            fail(f"worker phase: native calls took the plain path: "
                 f"{native.plain_calls()}")
        lr, sr = out["lease_read"], out["shm_read"]
        print(f"worker: cold write {n} x {BLOCK_BYTES >> 20} MiB by short "
              f"circuit {write_s:.3f} s "
              f"({out['cold_write']['gb_per_s']:.2f} GB/s), {master.commits}"
              f" commits; lease read epoch 1 {lr['epoch1_s']:.3f} s, SHM "
              f"read epoch 1 {sr['epoch1_s']:.3f} s, against the main "
              f"path's {main['epoch1_s']:.3f} s; epoch 2 {lr['epoch2_s']:.4f}"
              f" / {sr['epoch2_s']:.4f} s ({n} device-tier hits each); open "
              f"a block: lease {lr['open_ms']:.3f} ms, SHM cold "
              f"{sr['open_ms']:.3f} ms; open+close lease RPC "
              f"{out['prefetch']['lease_rpc_pair_ms']:.3f} ms; scan K={k} "
              f"{lr['scan_ms']:.2f} / {sr['scan_ms']:.2f} ms, acc "
              f"{lr['chain']} == main path == plain, launches {launches} / "
              f"{sr['scan_launches']}; SHM cold open: lease RPC p50 "
              f"{sr['lease_wait_ms']['p50']:.3f} ms, p99 "
              f"{sr['lease_wait_ms']['p99']:.3f} ms, map p50 "
              f"{sr['shm_map_ms']['p50']:.3f} ms"
              + f"; cold UFS rung {GRPC_BLOCKS} blocks: "
              + ", ".join(f"{t['mode']} {t['s']:.3f} s "
                          f"({t['gb_per_s']:.2f} GB/s, "
                          f"{t['ufs_reads_per_block']:g} UFS reads a block, "
                          f"TTFB p50 {t['ttfb_p50_ms']:.2f} ms)"
                          for t in out["cold_read"]),
              flush=True)
    finally:
        server.stop()
        worker.stop()  # heartbeats, then the async-cache threads
        RpcChannel.shutdown_pool()
        worker.ufs_manager.close()
        shutil.rmtree(tier_dir, ignore_errors=True)
    out["launches"] = launches
    # (vi) with /dev/shm holding one MEM tier at a time
    out["qos"] = qos_phase(device, workdir, main, k)
    return out


def qos_phase(device, workdir: str, main: dict, k: int) -> dict:
    """(2c vi), after the 2c worker stopped: a second port worker with
    worker QoS on (its authenticator on its server, so every call names
    a tenant), a MEM tier of ``QOS_TIER_BLOCKS`` blocks and
    ``QOS_ASYNC_CACHE_THREADS`` async-cache threads. A "victim" (the
    client's default principal, the OS user) reads 8 fresh cold blocks on
    demand into a device tier and scans them; then a "flood" tenant
    queues ``QOS_FLOOD_BLOCKS`` fresh cold blocks through ``async_cache``
    at PREFETCH, all requests at once, and the victim reads 8 others while the flood drains.
    The flood's stripe tasks outnumber the tenant cap, so the worker must
    park some (``Worker.QosFetchDeferred`` > 0). Every flood block must
    be cached once the async cache is idle, every block fetched from the
    UFS once, each fetch's span must name the victim's ON_DEMAND or the
    flood's PREFETCH, the bytes right and each victim chain the main
    path's. No time limit."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.clients import WorkerClient
    from alluxio_tpu_torch.rpc.core import RpcChannel
    from alluxio_tpu_torch.security.user import get_os_user
    from alluxio_tpu_torch.utils import tracing

    files = main["files"]
    paths = list(files)
    groups = {"flood": paths[:QOS_FLOOD_BLOCKS],
              "quiet": paths[QOS_FLOOD_BLOCKS:QOS_FLOOD_BLOCKS + 8],
              "flooded": paths[QOS_FLOOD_BLOCKS + 8:QOS_FLOOD_BLOCKS + 16]}
    base = {"flood": 1 + QOS_CONTAINER_BASE,
            "quiet": 1 + QOS_CONTAINER_BASE + QOS_FLOOD_BLOCKS,
            "flooded": 1 + QOS_CONTAINER_BASE + QOS_FLOOD_BLOCKS + 8}
    tier_bytes = QOS_TIER_BLOCKS * BLOCK_BYTES
    tier_dir = block_dir(tier_bytes)
    master = StandInBlockMaster()
    worker, server, _ = start_worker(workdir, tier_dir, tier_bytes, master,
                                     qos=True)
    m = metrics()
    victim = get_os_user()
    classes = ("ON_DEMAND", "ASYNC_FILL", "PREFETCH")
    out = {"tier_blocks": QOS_TIER_BLOCKS,
           "flood_blocks": QOS_FLOOD_BLOCKS, "victim_blocks": 8,
           "async_cache_threads": QOS_ASYNC_CACHE_THREADS}

    def gauges() -> dict:
        snap = m.snapshot()
        return {g: snap.get(f"Worker.{g}") for g in (
            "QosFetchDeferred", "QosFetchQueued", "QosFetchPromotedTotal")}

    def victim_epoch(name: str) -> dict:
        sub = {p: files[p] for p in groups[name]}
        fs = WorkerFS(sub, base[name], master)
        loader = DeviceBlockLoader(fs, list(sub), device=device,
                                   hbm_bytes=len(sub) * BLOCK_BYTES
                                   + (64 << 20),
                                   prefetch=2, dtype=np.int32)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = list(loader.epoch())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            fs.check_rungs(f"worker QoS victim ({name})", allowed={"ufs"})
            check_order(f"worker QoS victim ({name})", got,
                        [SimpleNamespace(path=p) for p in sub], main)
            scan = scan_blocks(f"worker QoS victim ({name})", got, main,
                               list(sub), k)
            del got
        finally:
            loader.close()
            fs.close()
        return {"s": dt, "gb_per_s": len(sub) * BLOCK_BYTES / dt / 1e9,
                **scan}

    tracing.set_tracing_enabled(True)
    since_ms = time.time() * 1000.0
    try:
        flood_fs = WorkerFS({p: files[p] for p in groups["flood"]},
                            base["flood"], master)
        for name in groups:
            master.know_blocks(WorkerFS(
                {p: files[p] for p in groups[name]}, base[name],
                master).block_lengths())
        f0 = fetch_counts()
        c0 = {c: m.counter(f"Worker.QosFetch.{c}").count for c in classes}
        rk.launches = 0
        out["quiet"] = victim_epoch("quiet")
        flood = WorkerClient(f"127.0.0.1:{worker.address.rpc_port}",
                             metadata=(("atpu-user", "flood"),))
        with ThreadPoolExecutor(QOS_FLOOD_BLOCKS) as pool:  # all at once
            accepted = list(pool.map(lambda p: flood.async_cache(
                flood_fs.block_id(p), files[p][1], 0, BLOCK_BYTES,
                mount_id=WORKER_MOUNT_ID, qos_class="PREFETCH"),
                groups["flood"]))
        if not all(accepted):
            fail(f"worker QoS: the async cache refused flood blocks: "
                 f"{accepted}")
        out["gauges_flood_queued"] = gauges()
        out["flooded"] = victim_epoch("flooded")
        out["gauges"] = gauges()
        t = time.perf_counter()
        if not worker.async_cache.wait_idle(600.0):
            fail("worker QoS: the async cache did not drain the flood")
        out["flood_drain_s"] = time.perf_counter() - t
        out["launches"] = rk.launches
        d = fetch_delta(f0)
        check_fetch("worker QoS", d, QOS_FLOOD_BLOCKS + 16)
        for p in groups["flood"]:
            bid = flood_fs.block_id(p)
            if not worker.store.has_block(bid):
                fail(f"worker QoS: flood block {p} is not cached")
            with worker.store.get_reader(bid) as r:
                got = np.frombuffer(r.read(0, r.length), dtype=np.uint8)
            if not np.array_equal(got, np.fromfile(files[p][1],
                                                   dtype=np.uint8)):
                fail(f"worker QoS: flood block {p} differs from its file")
        by_class = {c: m.counter(f"Worker.QosFetch.{c}").count - c0[c]
                    for c in classes}
        want_class = {"ON_DEMAND": 16, "ASYNC_FILL": 0,
                      "PREFETCH": QOS_FLOOD_BLOCKS}
        if by_class != want_class:
            fail(f"worker QoS: fetches by class {by_class}, want "
                 f"{want_class}")
        seen = {}
        for span in tracing.tracer().snapshot(limit=1 << 16):
            if span["name"] == "atpu.worker.ufs_fetch" and \
                    span["start_ms"] >= since_ms:
                key = f"{span['tags']['tenant']}/{span['tags']['class']}"
                seen[key] = seen.get(key, 0) + 1
        want_seen = {f"{victim}/ON_DEMAND": 16,
                     "flood/PREFETCH": QOS_FLOOD_BLOCKS}
        if seen != want_seen:
            fail(f"worker QoS: fetch spans by principal/class {seen}, "
                 f"want {want_seen}")
        time.sleep(worker.ufs_fetcher.QOS_STATS_TTL_S)  # a fresh sweep
        out["gauges_after_drain"] = gauges()
        if not out["gauges_after_drain"]["QosFetchDeferred"]:
            fail(f"worker QoS: the flood's {QOS_ASYNC_CACHE_THREADS} "
                 f"fetches in flight parked no stripe task at the tenant "
                 f"cap (gauges {out['gauges_after_drain']})")
        out.update(fetches_by_class=by_class, fetches_by_principal=seen,
                   fetches=d["UfsFetchStarted"],
                   ufs_block_reads=d["UfsBlocksRead"])
    finally:
        tracing.set_tracing_enabled(False)
        server.stop()
        worker.stop()
        RpcChannel.shutdown_pool()
        worker.ufs_manager.close()
        shutil.rmtree(tier_dir, ignore_errors=True)
    q, f = out["quiet"], out["flooded"]
    print(f"worker QoS (tier {QOS_TIER_BLOCKS} blocks, "
          f"{QOS_ASYNC_CACHE_THREADS} async-cache threads): victim epoch "
          f"without the flood {q['s']:.3f} s ({q['gb_per_s']:.2f} GB/s), "
          f"with {QOS_FLOOD_BLOCKS} PREFETCH flood blocks queued "
          f"{f['s']:.3f} s ({f['gb_per_s']:.2f} GB/s); flood drained "
          f"{out['flood_drain_s']:.3f} s later, every flood block cached; "
          f"{out['fetches']} fetches, {out['ufs_block_reads']} UFS block "
          f"reads; gauges with the flood queued "
          f"{out['gauges_flood_queued']}, after the victim's epoch "
          f"{out['gauges']}, after the drain {out['gauges_after_drain']}; "
          f"fetches by principal/class {out['fetches_by_principal']}; "
          f"scans K={k} {q['scan_ms']:.2f} / {f['scan_ms']:.2f} ms == main "
          f"path == plain", flush=True)
    return out


def shm_read(device, files: dict, master, worker, main: dict, k: int,
             hits) -> dict:
    """(2c ii'): a fresh loader reads the 64 blocks through the SHM rung
    into the device tier. While it is open the worker holds a lease and
    an SHM pin a block; after the loader and then the client close, none.
    The native library pre-faults every block, none on the plain path."""
    from alluxio_tpu_torch import native

    from alluxio_tpu_torch.utils import tracing

    n = len(files)
    fs = WorkerFS(files, 1, master, route="shm")
    native.reset_counts()
    # traced: each cold open's lease RPC and map, the in-process
    # counterpart of 2g's out-of-process SHM turn
    tracing.set_tracing_enabled(True)
    wall0 = time.time() * 1e3
    try:
        read = loader_read(
            "worker SHM read", device, fs, files, main, k,
            lambda: (worker.shm_store.stats()["live_leases"],
                     len(worker.store.shm_leased_blocks)), hits)
    finally:
        tracing.set_tracing_enabled(False)
    phases = shm_phases(wall0)
    if len(phases["lease_wait"]) != n or len(phases["shm_map"]) != n:
        fail(f"worker SHM read: {len(phases['lease_wait'])} lease RPCs "
             f"and {len(phases['shm_map'])} maps traced, want {n} each")
    prefaults = native.prefault_calls()
    fs.check_rungs("worker SHM read")
    after_loader = worker.shm_store.stats()["live_leases"]
    fs.close()
    after = (worker.shm_store.stats()["live_leases"],
             len(worker.store.shm_leased_blocks))
    plain = native.plain_calls()
    if read["held"] != (n, n) or after != (0, 0):
        fail(f"worker SHM read: leases and SHM pins {read['held']} while "
             f"the loader is open, {after} after the client closed; want "
             f"({n}, {n}), then (0, 0)")
    if not native.loaded() or plain["prefault"] or \
            prefaults != (n, n * BLOCK_BYTES):
        fail(f"worker SHM read: native library loaded {native.loaded()}, "
             f"(pre-faults, bytes) {prefaults}, plain path {plain}; want "
             f"True, {(n, n * BLOCK_BYTES)}, none")
    return dict(read, rungs=dict(fs.rungs),
                leases_after_loader_close=after_loader,
                leases_after_client_close=0, native_prefaults=n,
                **{f"{name}_ms": spread(ms) for name, ms in phases.items()})


def shm_phases(since_ms: float) -> dict:
    """The ``lease_wait`` and ``shm_map`` phases (ms) that the SHM
    transport recorded in the loader's host-read spans begun after
    ``since_ms`` (wall clock), one of each a mapped segment."""
    from alluxio_tpu_torch.utils.tracing import tracer

    out = {"lease_wait": [], "shm_map": []}
    for span in tracer().snapshot(limit=1 << 16):
        if span["name"] != "atpu.loader.host_read" or \
                span["start_ms"] < since_ms:
            continue
        for name, ms in span.get("phases", ()):
            if name in out:
                out[name].append(ms)
    return out


def pct(samples: list, p: float) -> float:
    return samples[min(len(samples) - 1, int(p / 100.0 * len(samples)))] \
        if samples else 0.0


def spread(samples: list) -> dict:
    """Mean, p50 and p99 of ``samples`` (ms)."""
    ordered = sorted(samples)
    return {"n": len(ordered), "mean": sum(ordered) / max(1, len(ordered)),
            "p50": pct(ordered, 50), "p99": pct(ordered, 99)}


def main_chain(main: dict, paths, k: int) -> int:
    """The plain chain over the main path's device blocks of ``paths``
    (they were held against their files)."""
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    order = {p: i for i, p in enumerate(main["files"])}
    x = torch.cat([main["blocks"][order[p]] for p in paths])
    return int(chain(rk.scaled_sum_reference, x, k))


def scan_blocks(name: str, blocks: list, main: dict, paths, k: int) -> dict:
    """``k`` chained ``scaled_sum`` calls over ``blocks`` (the kernel's
    launches counted), equal to the plain chain over them and to the
    main path's chain over the same files."""
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    x = torch.cat(blocks)
    l0 = rk.launches
    acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
    launches = rk.launches - l0
    got = int(acc)
    plain = int(chain(rk.scaled_sum_reference, x, k))
    want = main_chain(main, paths, k)
    if launches != k or not got == plain == want:
        fail(f"{name} scan: {launches} launches (want {k}), kernel chain "
             f"{got}, plain chain {plain}, main path's chain over the "
             f"same files {want}")
    return {"scan_ms": scan_ms, "scan_launches": launches, "chain": got}


def fetch_counts() -> dict:
    from alluxio_tpu_torch.metrics import metrics

    m = metrics()
    out = {n: m.counter(f"Worker.{n}").count for n in (
        "UfsFetchStarted", "UfsFetchBytes", "UfsFetchCoalesced",
        "UfsFetchFallbacks", "UfsFetchFailures", "UfsBlocksRead")}
    out["ttfb"] = m.timer("Worker.UfsFetchTtfb").snapshot()["count"]
    return out


def fetch_delta(before: dict) -> dict:
    after = fetch_counts()
    return {n: after[n] - before[n] for n in before}


def check_fetch(name: str, d: dict, blocks: int) -> None:
    """The worker fetched each of ``blocks`` cold blocks from the UFS
    exactly once, every byte once, with no fallback and no failure."""
    want = {"UfsFetchStarted": blocks, "UfsBlocksRead": blocks,
            "UfsFetchBytes": blocks * BLOCK_BYTES, "UfsFetchFallbacks": 0,
            "UfsFetchFailures": 0}
    got = {n: d[n] for n in want}
    if got != want:
        fail(f"{name}: fetch counters {got}, want {want}")


def cold_turns(device, files: dict, master, main: dict, k: int) -> list:
    """(2c v): the first ``GRPC_BLOCKS`` files as fresh block ids no
    worker holds, through the UFS rung into a loader's device tier, the
    worker streaming each block from its striped fetch and caching it as
    it streams: one stream a block, then striped at the JAX defaults,
    each turn on blocks of its own, then ``k`` chained scans of the
    turn's blocks. Every block must equal its file, cost the worker one
    fetch and one UFS read of each byte, and the chain must equal the
    plain chain and the main path's over the same files."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics

    cold_files = dict(list(files.items())[:GRPC_BLOCKS])
    stripes = metrics().counter("Client.RemoteReadStripes")
    ttfb = metrics().timer("Worker.UfsFetchTtfb")
    turns = []
    for i, (mode, stripe) in enumerate((("single", 0),
                                        ("striped", REMOTE_STRIPE_BYTES))):
        cfs = WorkerFS(cold_files, 1 + COLD_CONTAINER_BASE + i * GRPC_BLOCKS,
                       master, stripe_size=stripe)
        master.know_blocks(cfs.block_lengths())
        f0, st0 = fetch_counts(), stripes.count
        loader = DeviceBlockLoader(cfs, list(cold_files), device=device,
                                   hbm_bytes=GRPC_BLOCKS * BLOCK_BYTES
                                   + (64 << 20),
                                   prefetch=2, dtype=np.int32)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = list(loader.epoch())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            cfs.check_rungs(f"worker cold read ({mode})", allowed={"ufs"})
            d, n_stripes = fetch_delta(f0), stripes.count - st0
            if d["UfsBlocksRead"] != GRPC_BLOCKS or \
                    (n_stripes > 0) != (mode == "striped"):
                fail(f"worker cold read ({mode}): {d['UfsBlocksRead']} UFS "
                     f"reads and {n_stripes} stripes for {GRPC_BLOCKS} "
                     f"blocks; want {GRPC_BLOCKS} reads, stripes only when "
                     f"striped")
            check_fetch(f"worker cold read ({mode})", d, GRPC_BLOCKS)
            check_order(f"worker cold read ({mode})", got,
                        [SimpleNamespace(path=p) for p in cold_files], main)
            scan = scan_blocks(f"worker cold read ({mode})", got, main,
                               list(cold_files), k)
            del got
        finally:
            loader.close()
            cfs.close()
        samples = ttfb.recent(d["ttfb"])  # this turn's own
        turns.append({"mode": mode, "blocks": GRPC_BLOCKS, "s": dt,
                      "gb_per_s": GRPC_BLOCKS * BLOCK_BYTES / dt / 1e9,
                      "ms_per_block": dt * 1e3 / GRPC_BLOCKS,
                      "stripes": n_stripes,
                      "ufs_reads_per_block": d["UfsBlocksRead"]
                      / GRPC_BLOCKS,
                      "fetches": d["UfsFetchStarted"],
                      "fetch_bytes": d["UfsFetchBytes"],
                      "coalesced": d["UfsFetchCoalesced"],
                      "ttfb_p50_ms": pct(samples, 50) * 1e3,
                      "ttfb_p99_ms": pct(samples, 99) * 1e3, **scan})
    print("worker cold UFS rung through the fetcher: " + "; ".join(
        f"{t['mode']} {t['s']:.3f} s ({t['gb_per_s']:.2f} GB/s, "
        f"{t['ms_per_block']:.1f} ms a block, TTFB p50 "
        f"{t['ttfb_p50_ms']:.2f} ms p99 {t['ttfb_p99_ms']:.2f} ms, "
        f"{t['fetches']} fetches, {t['coalesced']} coalesced joins, scan "
        f"K={k} {t['scan_ms']:.2f} ms == main path == plain)"
        for t in turns), flush=True)
    return turns


def coalesce_turn(files: dict, master, worker) -> dict:
    """(2c v'): ``COALESCE_READERS`` readers, each with its own
    ``BlockStoreClient``, start together on the same ``GRPC_BLOCKS``
    fresh cold blocks (read whole, in the same order). Each reader's
    bytes must equal the files, and whatever the timing the worker reads
    each block from the UFS once: joins coalesce onto the in-flight
    fetch, later reads find the block cached."""
    import threading

    paths = list(files)[GRPC_BLOCKS:2 * GRPC_BLOCKS]
    sub = {p: files[p] for p in paths}
    readers = [WorkerFS(sub, 1 + COALESCE_CONTAINER_BASE, master)
               for _ in range(COALESCE_READERS)]
    master.know_blocks(readers[0].block_lengths())
    want = {p: np.fromfile(f, dtype=np.uint8) for p, (_, f) in sub.items()}
    errors, times = [], [0.0] * COALESCE_READERS
    start = threading.Barrier(COALESCE_READERS)

    def read(i, fs):
        try:
            start.wait(30)
            t = time.perf_counter()
            for p in paths:
                stream = fs.block_stream(p)
                try:
                    got = np.frombuffer(stream.pread(0, BLOCK_BYTES),
                                        dtype=np.uint8)
                finally:
                    stream.close()
                if not np.array_equal(got, want[p]):
                    errors.append(f"reader {i}: {p} differs from its file")
            times[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"reader {i}: {type(e).__name__}: {e}")

    f0 = fetch_counts()
    t = time.perf_counter()
    threads = [threading.Thread(target=read, args=(i, fs))
               for i, fs in enumerate(readers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    dt = time.perf_counter() - t
    rungs = {}
    for fs in readers:
        for rung, c in fs.rungs.items():
            rungs[rung] = rungs.get(rung, 0) + c
        fs.close()
    d = fetch_delta(f0)
    if errors or any(th.is_alive() for th in threads):
        fail(f"worker coalescing: {errors or 'a reader did not finish'}")
    check_fetch("worker coalescing", d, GRPC_BLOCKS)
    if not all(worker.store.has_block(readers[0].block_id(p))
               for p in paths):
        fail("worker coalescing: a block was not cached")
    out = {"readers": COALESCE_READERS, "blocks": GRPC_BLOCKS, "s": dt,
           "reader_s": times, "coalesced": d["UfsFetchCoalesced"],
           "fetches": d["UfsFetchStarted"], "rungs": rungs,
           "gb_per_s": COALESCE_READERS * GRPC_BLOCKS * BLOCK_BYTES
           / dt / 1e9}
    print(f"worker coalescing: {COALESCE_READERS} readers x {GRPC_BLOCKS} "
          f"cold blocks in {dt:.3f} s ({out['gb_per_s']:.2f} GB/s "
          f"delivered), {d['UfsFetchStarted']} fetches, "
          f"{d['UfsBlocksRead']} UFS block reads, {d['UfsFetchCoalesced']} "
          f"coalesced joins; reads by rung {rungs}; every reader's bytes "
          f"== the files", flush=True)
    return dict(out, paths=paths)


def fault_turn(device, files: dict, master, worker, paths: list,
               main: dict) -> dict:
    """(2c vii): the blocks of (v') through the SHM route with
    ``atpu.debug.fault.shm.map.error.rate`` = 1.0: every map fails, and
    the ladder serves each block from the lease rung into a loader's
    device tier, the bytes equal to the files. Then the injector is
    reset, and the same route maps every block with no fault."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.utils import faults

    sub = {p: files[p] for p in paths}
    ids = WorkerFS(sub, 1 + COALESCE_CONTAINER_BASE, master).block_lengths()
    deadline = time.monotonic() + 30
    while any(not master.get_block_info(b).locations for b in ids) and \
            time.monotonic() < deadline:
        time.sleep(WORKER_HEARTBEAT_S)  # the commits' heartbeat deltas
    conf = Configuration(load_env=False)
    conf.set(Keys.DEBUG_FAULT_SHM_MAP_ERROR_RATE, 1.0)
    failures = metrics().counter("Client.ShmMapFailures")
    out = {}
    for turn, armed in (("fault", True), ("after reset", False)):
        if armed:
            faults.injector().configure(conf)
        fs = WorkerFS(sub, 1 + COALESCE_CONTAINER_BASE, master, route="shm")
        f0 = failures.count
        injected0 = faults.injector().injected["shm_map_error"]
        hits = metrics().counter("Client.JaxHbmHits")
        loader = DeviceBlockLoader(fs, paths, device=device,
                                   hbm_bytes=len(paths) * BLOCK_BYTES
                                   + (64 << 20),
                                   prefetch=2, dtype=np.int32)
        try:
            t = time.perf_counter()
            got = list(loader.epoch())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            check_order(f"worker fault turn ({turn})", got,
                        [SimpleNamespace(path=p) for p in paths], main)
            h0 = hits.count
            again = list(loader.epoch())
            if hits.count - h0 != len(paths) or \
                    any(a is not b for a, b in zip(got, again)):
                fail(f"worker fault turn ({turn}): the device tier holds "
                     f"{hits.count - h0} of {len(paths)} blocks")
            del got, again
            injected = faults.injector().injected["shm_map_error"] \
                - injected0
        finally:
            loader.close()
            fs.close()
            if armed:
                faults.injector().reset()
        want_rung = "lease" if armed else "shm"
        fs.check_rungs(f"worker fault turn ({turn})", allowed={want_rung})
        if armed and (injected != len(paths)
                      or failures.count - f0 != len(paths)):
            fail(f"worker fault turn: {injected} injected map faults, "
                 f"{failures.count - f0} map failures counted, want "
                 f"{len(paths)} of each")
        if not armed and (injected or failures.count - f0 or
                          faults.armed()):
            fail("worker fault turn: a fault after the injector was reset")
        out[turn] = {"s": dt, "rungs": dict(fs.rungs),
                     "injected_map_faults": injected,
                     "map_failures": failures.count - f0}
    if worker.shm_store.stats()["live_leases"]:
        fail("worker fault turn: SHM leases left after the clients closed")
    print(f"worker fault turn (SHM map error rate 1.0, {len(paths)} "
          f"blocks): served by {out['fault']['rungs']} in "
          f"{out['fault']['s']:.3f} s, {out['fault']['map_failures']} map "
          f"failures counted, device tier full; after reset "
          f"{out['after reset']['rungs']} in "
          f"{out['after reset']['s']:.3f} s, no fault", flush=True)
    return out


def web_and_sink_check(worker, sink_path: str) -> dict:
    """(2c): the worker's web endpoint lists the store's blocks, and its
    JSON-lines sink has written the worker's metrics."""
    import urllib.request

    def get(route):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{worker.web_port}{route}",
                timeout=30) as r:
            return json.loads(r.read())

    info = get("/api/v1/worker/info")
    listed = get("/api/v1/worker/blocks")["blocks"]
    report = worker.store.block_report()
    want = {t: sorted(ids) for t, ids in report.items()}
    got = {t: sorted(v["sample"]) for t, v in listed.items()}
    counts = {t: v["count"] for t, v in listed.items()}
    if got != want or counts != {t: len(v) for t, v in want.items()} or \
            info.get("tiers") != list(report):
        fail(f"worker web endpoint: info tiers {info.get('tiers')}, blocks "
             f"{counts}; the store holds "
             f"{ {t: len(v) for t, v in want.items()} }")
    lines = [json.loads(ln) for ln in Path(sink_path).read_text()
             .splitlines() if ln.strip()]
    with_reads = [ln for ln in lines
                  if "Worker.UfsBlocksRead" in ln["metrics"]]
    if not with_reads:
        fail(f"worker metrics sink: {len(lines)} lines, none with "
             f"Worker.UfsBlocksRead")
    out = {"web_port": worker.web_port, "blocks_listed": counts,
           "sink_lines": len(lines),
           "sink_ufs_blocks_read": with_reads[-1]["metrics"][
               "Worker.UfsBlocksRead"]}
    print(f"worker web endpoint (port {worker.web_port}): info and blocks "
          f"list the store's {sum(counts.values())} blocks; JSON-lines "
          f"sink {len(lines)} lines, Worker.UfsBlocksRead "
          f"{out['sink_ufs_blocks_read']}", flush=True)
    return out


def pread_many_check(files: dict, master) -> dict:
    """(2c iii): one ``pread_many`` of 256 seeded small reads (at most 64
    KiB each) of the first block on the remote rung (one ``read_many``
    RPC; opened without the UFS descriptor, since a stream that may have
    to read a cold block through keeps its reads per op) and on the SHM
    rung (one native plan), each equal to the file's bytes."""
    from alluxio_tpu_torch import native
    from alluxio_tpu_torch.metrics import metrics

    path, (_, block_file) = next(iter(files.items()))
    rng = np.random.default_rng(SEED + 3)
    sizes = rng.integers(1, (64 << 10) + 1, 256)
    offsets = [int(o) for o in rng.integers(0, BLOCK_BYTES - sizes.max(),
                                            256)]
    sizes = [int(s) for s in sizes]
    data = np.fromfile(block_file, dtype=np.uint8)
    want = [data[o:o + s].tobytes() for o, s in zip(offsets, sizes)]
    m = metrics()
    out = {"ops": len(offsets), "bytes": sum(sizes)}
    for route, counter, rung in (
            ("grpc", "Client.BatchReadBatches", "remote"),
            ("shm", "Client.NativeBatches", "shm")):
        fs = WorkerFS({path: files[path]}, 1, master, route=route)
        try:
            stream = fs.block_stream(path, with_ufs=False)
            c0 = m.counter(counter).count
            t = time.perf_counter()
            got = stream.pread_many(offsets, sizes)
            dt = time.perf_counter() - t
        finally:
            fs.close()
        batches = m.counter(counter).count - c0
        if stream.rung != rung or got != want or batches != 1:
            fail(f"pread_many on the {rung} rung: served by "
                 f"{stream.rung}, bytes equal {got == want}, {batches} "
                 f"batches ({counter}); want {rung}, True, 1")
        out[rung] = {"ms": dt * 1e3, "batches": batches}
    if native.plain_calls()["plan"]:
        fail(f"pread_many: {native.plain_calls()['plan']} plans took the "
             f"plain path")
    print(f"worker pread_many ({out['ops']} ops, {out['bytes']} bytes, "
          f"equal to the file): remote rung one read_many "
          f"{out['remote']['ms']:.3f} ms, SHM rung one native plan "
          f"{out['shm']['ms']:.3f} ms", flush=True)
    return out


def worker_prefetch(device, worker, master, client, main: dict,
                    warm_fs: WorkerFS) -> dict:
    """(2c iv): the prefetch loop at the JAX defaults (a quarter of the
    budget for device-tier placements, the rest DRAM placements in the
    worker's MEM tier) over fresh block ids of the main path's files, on
    the tier as (i)-(iii) left it. After the warm-up gate a second reader
    leases what is left of (i)'s blocks (``warm_fs``) once each, timing
    the lease RPCs; that makes the pinned placements the least recently
    used blocks, so the epoch's evictions reach them first, and the pin
    veto must keep every one."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.prefetch import PrefetchService

    files = main["files"]
    n = len(files)
    # the lease route: a block the master has not located (a miss) takes
    # the UFS rung, striped at the defaults
    fs = WorkerFS(files, 1 + PREFETCH_CONTAINER_BASE, master)
    master.know_blocks(fs.block_lengths())  # persisted files' blocks
    store = worker.store
    evictions = {"count": 0, "while_pinned": 0, "pinned_victims": []}

    def on_event(event, block_id):  # runs under the store's alloc lock
        if event == "evicted":
            evictions["count"] += 1
            evictions["while_pinned"] += bool(store.prefetch_pinned_blocks)
            if block_id in store.prefetch_pinned_blocks:
                evictions["pinned_victims"].append(block_id)

    store.add_listener(on_event)
    m = metrics()
    counters = {k: m.counter(f"Client.Prefetch{k}") for k in
                ("LoadsIssued", "BlocksPinned", "HbmAdopted",
                 "HbmAdoptFailures")}
    base = {k: c.count for k, c in counters.items()}

    def worker_client(address):
        if address.key() != worker.address.key():
            fail(f"worker prefetch: asked for worker {address.key()}")
        return client

    svc = PrefetchService.from_fs(
        fs, list(files), seed=SEED, lookahead_blocks=PREFETCH_LOOKAHEAD,
        budget_bytes=PREFETCH_LOOKAHEAD * BLOCK_BYTES, hbm_fraction=0.25,
        heartbeat_interval_s=PREFETCH_HEARTBEAT_S,
        worker_client_fn=worker_client)
    failed = []
    on_load_failed = svc.scheduler.on_load_failed

    def count_failure(block_id):
        failed.append(block_id)
        on_load_failed(block_id)

    svc.scheduler.on_load_failed = count_failure
    side = torch.cuda.Stream(device=device)
    loader = None
    epochs = []
    try:
        loader = DeviceBlockLoader(fs, list(files), device=device,
                                   hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                                   prefetch=2, dtype=np.int32,
                                   prefetch_service=svc)
        t0 = time.perf_counter()
        svc.start()
        if not svc.wait_ready(PREFETCH_LOOKAHEAD, timeout_s=60.0):
            fail(f"worker prefetch: {PREFETCH_LOOKAHEAD} placements not "
                 f"ready within 60 s: {svc.stats()}")
        warm_s = time.perf_counter() - t0
        # a second reader of the warm set: one lease of each of (i)'s
        # blocks still on the worker, open and close RPCs only
        warm_ids = warm_fs.block_lengths()
        warm = [b for b in store.block_report()["MEM"] if b in warm_ids]
        pinned_at_touch = len(store.prefetch_pinned_blocks)
        t = time.perf_counter()
        for bid in warm:
            client.open_local_block(warm_fs.session_id, bid)
            client.close_local_block(warm_fs.session_id, bid)
        touch_s = time.perf_counter() - t
        for e in range(2):
            st0 = svc.stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.cuda.stream(side):
                blocks = list(loader.epoch())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            st = svc.stats()
            ep = {"epoch": e, "s": dt,
                  **{k: st[k] - st0[k] for k in ("hits", "late", "misses")}}
            epochs.append(ep)
            check_order(f"worker prefetch epoch {e}", blocks,
                        svc.oracle.epoch_sequence(e), main)
            if ep["hits"] + ep["late"] + ep["misses"] != n:
                fail(f"worker prefetch epoch {e}: hits {ep['hits']} + late "
                     f"{ep['late']} + misses {ep['misses']} != {n}")
        del blocks
        stats = svc.stats()
    finally:
        svc.close()  # unpins every block it placed
        if loader is not None:
            loader.close()
        fs.close()
    fs.check_rungs("worker prefetch", allowed={"lease", "ufs"})
    placed = {k: c.count - base[k] for k, c in counters.items()}
    left_pinned = sorted(store.prefetch_pinned_blocks)
    if placed["BlocksPinned"] < 1 or placed["LoadsIssued"] < 1:
        fail(f"worker prefetch: no DRAM placement landed in the worker's "
             f"MEM tier: {placed}")
    if failed or placed["HbmAdoptFailures"]:
        fail(f"worker prefetch: placements failed: {failed}, "
             f"{placed['HbmAdoptFailures']} device-tier adopts")
    if evictions["pinned_victims"] or left_pinned:
        fail(f"worker prefetch: pinned blocks evicted "
             f"{evictions['pinned_victims']}, pins left after close "
             f"{left_pinned}")
    if evictions["count"] == 0 or pinned_at_touch == 0:
        fail(f"worker prefetch: {evictions['count']} evictions, "
             f"{pinned_at_touch} pins when the warm set was touched: the "
             f"pin veto went untried")
    e0 = epochs[0]
    out = {"hbm_fraction": 0.25, "lookahead_blocks": PREFETCH_LOOKAHEAD,
           "budget_bytes": PREFETCH_LOOKAHEAD * BLOCK_BYTES,
           "warm_up_s": warm_s, "epochs": epochs,
           "dram_loads_issued": placed["LoadsIssued"],
           "dram_blocks_pinned": placed["BlocksPinned"],
           "hbm_adopts": placed["HbmAdopted"], "failed_placements": 0,
           "evictions": evictions["count"],
           "evictions_while_pinned": evictions["while_pinned"],
           "pinned_evicted": 0, "late_arrivals": stats["late_arrivals"],
           "pinned_at_touch": pinned_at_touch, "warm_leases": len(warm),
           "rungs": dict(fs.rungs),
           "lease_rpc_pair_ms": touch_s * 1e3 / max(1, len(warm))}
    print(f"worker prefetch (hbm_fraction 0.25): warm-up gate "
          f"{warm_s:.3f} s; epoch 0 {e0['s']:.3f} s hit/late/miss "
          f"{e0['hits']}/{e0['late']}/{e0['misses']}; epoch 1 "
          f"{epochs[1]['s']:.4f} s; {placed['LoadsIssued']} DRAM loads, "
          f"{placed['BlocksPinned']} pins, {placed['HbmAdopted']} device "
          f"adopts, no failure; {evictions['count']} evictions "
          f"({evictions['while_pinned']} while pins were held), no pinned "
          f"block evicted, no pin left", flush=True)
    return out


# -- decode -------------------------------------------------------------------
# -- 2g: a worker in its own process -----------------------------------------
class RungFS:
    """A cluster client whose block streams are counted by the rung that
    opened them (``BlockInStream.rung``) and whose first opens are timed:
    a loader opens every block through ``open_file(...).block_stream``;
    every other call goes to the ``FileSystem``."""

    def __init__(self, fs) -> None:
        self._fs = fs
        self.rungs = {}
        self.opens = 0
        self.open_s = 0.0

    def __getattr__(self, name):
        return getattr(self._fs, name)

    def open_file(self, path, **kwargs):
        return _RungFile(self, self._fs.open_file(path, **kwargs))

    def check_rungs(self, name: str, want: str) -> None:
        if set(self.rungs) != {want}:
            fail(f"{name}: blocks by rung {self.rungs}, want only {want}")


class _RungFile:
    def __init__(self, fs: RungFS, f) -> None:
        self._fs = fs
        self._f = f
        self._seen = set()

    def block_stream(self, index: int):
        t = time.perf_counter()
        stream = self._f.block_stream(index)
        if index not in self._seen:
            self._seen.add(index)
            fs = self._fs
            fs.open_s += time.perf_counter() - t
            fs.opens += 1
            fs.rungs[stream.rung] = fs.rungs.get(stream.rung, 0) + 1
        return stream

    def __getattr__(self, name):
        return getattr(self._f, name)


def start_mp_cluster(num_blocks: int) -> dict:
    """The port's ``MultiProcessCluster`` under ``/dev/shm`` (when it has
    the room): its master and one worker, each a process of its own
    (``python -m alluxio_tpu_torch.shell.main <role>``), blocks of
    ``BLOCK_BYTES``, a MEM tier through the level-0 quota template of
    ``num_blocks`` blocks plus 256 MiB and room for the records and the
    mesh's fresh shards, and its ``FileSystem``."""
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )

    tier = num_blocks * BLOCK_BYTES + (256 << 20) \
        + (DECODE_BLOCKS + 2) * BLOCK_BYTES
    base = block_dir(tier)
    cluster = MultiProcessCluster(
        os.path.join(base, "cluster"), num_workers=1, extra_conf={
            Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(BLOCK_BYTES),
            Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier)})
    t0 = time.perf_counter()
    try:
        cluster.start(timeout_s=MP_BOOT_S)
        fs = cluster.file_system()
    except BaseException:
        cluster.stop()
        shutil.rmtree(base, ignore_errors=True)
        raise
    boot_s = time.perf_counter() - t0
    pids = [p.proc.pid for p in cluster.masters + cluster.workers]
    print(f"2g: MultiProcessCluster under {base} (master at "
          f"{cluster.master_addresses}, one worker, pids {pids}, MEM tier "
          f"{tier} bytes by the quota template) up in {boot_s:.2f} s",
          flush=True)
    return {"cluster": cluster, "fs": fs, "base": base, "tier": tier,
            "boot_s": boot_s, "pids": pids}


def stop_mp_cluster(mp: dict) -> None:
    """Close the client, stop every process of the cluster, and give
    its directory back."""
    try:
        mp["fs"].close()
    finally:
        mp["cluster"].stop()
        alive = [p.proc.pid for p in mp["cluster"].masters
                 + mp["cluster"].workers if p.alive]
        shutil.rmtree(mp["base"], ignore_errors=True)
    if alive:
        fail(f"2g: processes {alive} outlived the cluster's stop")


def write_files(fs, files: dict) -> float:
    """Each block file written to the cluster at its path with
    ``write_all(MUST_CACHE)``; returns the seconds the writes took."""
    from alluxio_tpu_torch.client.streams import WriteType

    write_s = 0.0
    for path, (_, block_file) in files.items():
        arr = np.fromfile(block_file, dtype=np.uint8)
        t = time.perf_counter()
        fs.write_all(path, arr, write_type=WriteType.MUST_CACHE)
        write_s += time.perf_counter() - t
    return write_s


def mp_turn(name: str, device, fs, paths: list, main: dict,
            want: str) -> dict:
    """Epoch 1 of a fresh loader with no device tier over ``paths``
    through ``fs``: every block opened by the ``want`` rung and equal to
    its file; the epoch's time, the consumer's wait and the host ms a
    block to open a stream."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    rfs = RungFS(fs)
    loader = DeviceBlockLoader(rfs, list(paths), device=device, prefetch=2,
                               dtype=np.int32)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = list(loader.epoch())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        wait = loader.stall_report()["total_wait_s"]
    finally:
        loader.close()
    rfs.check_rungs(name, want)
    check_order(name, got, [SimpleNamespace(path=p) for p in paths], main)
    del got
    return {"route": name, "rung": want, "blocks": len(paths), "s": dt,
            "gb_per_s": len(paths) * BLOCK_BYTES / dt / 1e9,
            "consumer_wait_s": wait,
            "open_ms_per_block": rfs.open_s * 1e3 / rfs.opens}


def mp_phase(device, mp: dict, main: dict, inproc: dict, k: int) -> dict:
    """(2g): the main path through the port's ``MultiProcessCluster``,
    whose worker is a process of its own: the 64 shards written with
    ``write_all(MUST_CACHE)`` (64 commits on the worker), a loader's epoch
    1 with every block on the SHM rung, epoch 2 all device-tier hits, K
    chained ``scaled_sum`` calls equal to the main path's chain and the
    plain chain; then the route turns, each a fresh loader with no
    device tier, its route chosen by the client's keys only: the lease
    rung (``atpu.user.shm.enabled`` off), the SHM rung cold (traced: the
    lease RPC and the map of each open) and cached (the same client: no
    RPC), and ``GRPC_BLOCKS`` blocks through the remote rung
    (``atpu.user.short.circuit.enabled`` off) one stream a block, striped
    (``atpu.user.remote.read.stripe.size``, the JAX default at full
    size) and one stream again, every block on its rung and equal to its
    file; last 2d's metadata calls against the master by transport. The
    numbers print beside the in-process ones (``inproc``: the main path,
    2c's traced SHM read, 2d's metadata calls)."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.utils import tracing

    cluster, fs = mp["cluster"], mp["fs"]
    files = main["files"]
    paths = list(files)
    n = len(files)
    t_phase = time.perf_counter()
    write_s = write_files(fs, files)
    worker_port = cluster.worker_ports[0]
    located = [[[loc.address.rpc_port for loc in b.block_info.locations]
                for b in fs.fs_master.get_file_block_info_list(p)]
               for p in paths]
    if located != [[[worker_port]]] * n:
        fail(f"2g: the shards' blocks are not one each on the worker "
             f"(port {worker_port}): {located[:4]} ...")

    m = metrics()
    hits = m.counter("Client.JaxHbmHits")
    rfs = RungFS(fs)
    loader = DeviceBlockLoader(rfs, paths, device=device,
                               hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                               prefetch=2, dtype=np.int32)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = list(loader.epoch())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wait_s = loader.stall_report()["total_wait_s"]
        hits0 = hits.count
        blocks = list(loader.epoch())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if hits.count - hits0 != n or \
                any(a is not b for a, b in zip(first, blocks)):
            fail(f"2g epoch 2: {hits.count - hits0} device-tier hits, "
                 f"want {n}")
        del first
        rfs.check_rungs("2g epoch 1", "shm")
        check_order("2g epoch 1", blocks,
                    [SimpleNamespace(path=p) for p in paths], main)
        x = torch.cat(blocks)
        del blocks
        rk.launches = 0
        acc, scan_ms = timed(lambda: chain(rk.scaled_sum, x, k))
        launches = rk.launches
        got = int(acc)
    finally:
        loader.close()
    plain = int(chain(rk.scaled_sum_reference, x, k))
    del x
    if launches != k:
        fail(f"2g launched scaled_sum {launches} times, want {k}")
    if not got == main["chain"] == plain:
        fail(f"2g scan: kernel chain {got}, main path's chain "
             f"{main['chain']}, plain chain {plain}")

    def client(**keys):
        conf = Configuration(load_env=False)
        for key, value in keys.items():
            conf.set(getattr(Keys, key), value)
        return cluster.file_system(conf)

    # the route turns, epoch 1 each, with no device tier
    turns = []
    lease_fs, shm_fs = client(USER_SHM_ENABLED=False), client()
    tracing.set_tracing_enabled(True)
    try:
        turns.append(mp_turn("lease", device, lease_fs, paths, main,
                             "lease"))
        wall0 = time.time() * 1e3
        turns.append(mp_turn("SHM cold", device, shm_fs, paths, main,
                             "shm"))
        cold = shm_phases(wall0)
        wall0 = time.time() * 1e3
        turns.append(mp_turn("SHM cached", device, shm_fs, paths, main,
                             "shm"))
        cached = shm_phases(wall0)
    finally:
        tracing.set_tracing_enabled(False)
        lease_fs.close()
        shm_fs.close()
    if [len(cold["lease_wait"]), len(cold["shm_map"])] != [n, n] or \
            cached["lease_wait"] or cached["shm_map"]:
        fail(f"2g SHM turns: {len(cold['lease_wait'])} lease RPCs and "
             f"{len(cold['shm_map'])} maps traced cold, "
             f"{len(cached['lease_wait'])} and {len(cached['shm_map'])} "
             f"cached; want {n}, {n}, then none")
    streamed = m.counter("Client.JaxStreamedBlocks")
    stripes = m.counter("Client.RemoteReadStripes")
    remote = []
    grpc_paths = paths[:GRPC_BLOCKS]
    for mode, stripe in (("single", 0), ("striped", REMOTE_STRIPE_BYTES),
                         ("single", 0)):
        rfs_client = client(USER_SHORT_CIRCUIT_ENABLED=False,
                            USER_REMOTE_READ_STRIPE_SIZE=stripe)
        s0, st0 = streamed.count, stripes.count
        try:
            turn = mp_turn(f"remote {mode}", device, rfs_client, grpc_paths,
                           main, "remote")
        finally:
            rfs_client.close()
        n_stripes = stripes.count - st0
        if streamed.count - s0 != GRPC_BLOCKS or \
                (n_stripes > 0) != (mode == "striped"):
            fail(f"2g remote rung ({mode}): {streamed.count - s0} streamed "
                 f"blocks, {n_stripes} stripes")
        remote.append(dict(turn, mode=mode, stripe_bytes=stripe,
                           stripes=n_stripes))
    meta = transport_latencies("2g", cluster.master_addresses,
                               cluster.base)

    total = n * BLOCK_BYTES
    out = {"boot_s": mp["boot_s"], "tier_bytes": mp["tier"],
           "base": mp["base"], "processes": len(mp["pids"]),
           "blocks": n, "block_bytes": BLOCK_BYTES,
           "cold_write_s": write_s, "cold_write_gb_per_s": total / write_s
           / 1e9, "commits": n, "epoch1_s": t1 - t0,
           "epoch1_gb_per_s": total / (t1 - t0) / 1e9,
           "consumer_wait_s": wait_s, "epoch2_s": t2 - t1,
           "device_tier_hits": n, "rungs": dict(rfs.rungs),
           "open_ms_per_block": rfs.open_s * 1e3 / rfs.opens,
           "scan_ms": scan_ms, "launches": launches, "chain": got,
           "route_turns": turns,
           "shm_cold_open": {"lease_wait_ms": spread(cold["lease_wait"]),
                             "shm_map_ms": spread(cold["shm_map"])},
           "remote": remote,
           "metadata_ms": {t: meta[t] for t in TRANSPORTS},
           "in_process": inproc, "s": time.perf_counter() - t_phase}
    lw, sm = out["shm_cold_open"]["lease_wait_ms"], \
        out["shm_cold_open"]["shm_map_ms"]
    ip = inproc
    print(f"2g (worker in its own process; in-process in brackets): cold "
          f"write {n} x {BLOCK_BYTES >> 20} MiB {write_s:.3f} s "
          f"[{ip['cold_write_s']:.3f} s], {n} commits; epoch 1 "
          f"{t1 - t0:.3f} s, consumer waits {wait_s:.3f} s "
          f"[{ip['epoch1_s']:.3f} s, waits {ip['consumer_wait_s']:.3f} s], "
          f"every block on the SHM rung; epoch 2 {t2 - t1:.4f} s, {n} hits; "
          f"scan K={k} {scan_ms:.2f} ms, acc {got} == main path == plain, "
          f"launches {launches}", flush=True)
    print("2g route turns (epoch 1, no device tier): " + ", ".join(
        f"{t['route']} {t['s']:.3f} s ({t['gb_per_s']:.2f} GB/s, consumer "
        f"waits {t['consumer_wait_s']:.3f} s, open "
        f"{t['open_ms_per_block']:.3f} ms a block)"
        for t in turns + remote), flush=True)
    lat = "; ".join(
        f"{t} " + ", ".join(
            f"{op} {v['p50_ms']:.3f} / {v['p99_ms']:.3f} ms "
            f"[{ip['metadata_ms'][t][op]['p50_ms']:.3f} / "
            f"{ip['metadata_ms'][t][op]['p99_ms']:.3f}]"
            for op, v in meta[t].items())
        for t in TRANSPORTS)
    print(f"2g SHM cold open: lease RPC p50 {lw['p50']:.3f} ms, p99 "
          f"{lw['p99']:.3f} ms [{ip['lease_wait_ms']['p50']:.3f}, "
          f"{ip['lease_wait_ms']['p99']:.3f} ms]; map p50 {sm['p50']:.3f} "
          f"ms, p99 {sm['p99']:.3f} ms [{ip['shm_map_ms']['p50']:.3f}, "
          f"{ip['shm_map_ms']['p99']:.3f} ms]; metadata p50 / p99 "
          f"({MASTER_FILES} files as in 2d): {lat}; remote "
          f"rung one stream {remote[0]['gb_per_s']:.2f} and "
          f"{remote[2]['gb_per_s']:.2f} GB/s, striped "
          f"{remote[1]['gb_per_s']:.2f} GB/s; phase {out['s']:.1f} s",
          flush=True)
    return out


# -- 2h: the stress CLI, the stressbench job, the master on LSM, the suite ----
#: the port's stress CLI, run as a child process
STRESS_CLI = [sys.executable, "-m", "alluxio_tpu_torch.stress"]
#: 2h a's and 2h b's cut (PERF.md section 4): each bench measures this
#: many seconds, not the CLI's 5 (2h d's suite runs the same benches at
#: their own durations), so that the script stays near 900 s
STRESS_DURATION_S = 2
#: 2h a's worker bench corpus: 32 x 64 MiB, the main path's 2 GiB
STRESS_SHARD_MB = 64
STRESS_SHARDS = 32
#: 2h a's five CLI rows: (name, the bench's arguments), each run against
#: the live cluster (``--master``) and then in-process
STRESS_ROWS = (
    ("worker-random", ["worker", "--mode", "random", "--threads", "8"]),
    ("worker-sequential", ["worker", "--mode", "sequential",
                           "--threads", "4"]),
    ("master-GetStatus", ["master", "--op", "GetStatus", "--threads", "8"]),
    ("master-CreateFile", ["master", "--op", "CreateFile",
                           "--threads", "8"]),
    ("master-ListStatus", ["master", "--op", "ListStatus", "--threads", "8",
                           "--fixed-count", "100"]),
)
#: the namespace each CLI bench writes under
STRESS_PATHS = ("/stress-worker", "/stress-master")
STRESS_JOB_WORKERS = 2
#: 2h b's two stressbench jobs: bench -> options (the worker bench's
#: shards at its defaults, 4 x 64 MiB a task)
STRESS_JOBS = {"worker": {"mode": "random", "duration_s": STRESS_DURATION_S},
               "master": {"op": "GetStatus",
                          "duration_s": STRESS_DURATION_S}}
STRESS_CHILD_TIMEOUT_S = 300
SUITE_TIMEOUT_S = 800
def stress_env() -> dict:
    """The environment of a stress child: the repository on its path,
    whatever its working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def stress_row(name: str, argv: list, cwd: str,
               master: "str | None" = None) -> dict:
    """One CLI bench in a child process: its JSON line, which must have
    no error and a positive ``ops_per_s``."""
    args = list(argv) + ["--duration", str(STRESS_DURATION_S)]
    if argv[0] == "worker":
        args += ["--shard-mb", str(STRESS_SHARD_MB),
                 "--num-shards", str(STRESS_SHARDS)]
    if master is not None:
        args += ["--master", master]
    where = "out of process" if master else "in process"
    t = time.perf_counter()
    proc = subprocess.run(STRESS_CLI + args, capture_output=True, text=True,
                          timeout=STRESS_CHILD_TIMEOUT_S, cwd=cwd,
                          env=stress_env())
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"2h a: {name} ({where}) exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    row = json.loads(lines[-1])
    if row["errors"] != 0 or not row["metrics"].get("ops_per_s", 0) > 0:
        fail(f"2h a: {name} ({where}): {lines[-1]}")
    row["wall_s"] = time.perf_counter() - t
    return row


def wait_empty(fs, timeout_s: float = 60.0) -> None:
    """Wait until the cluster's workers hold no block."""
    deadline = time.monotonic() + timeout_s
    while any(w.block_count for w in fs.block_master.get_worker_infos()):
        if time.monotonic() > deadline:
            fail("2h: the worker still holds blocks of deleted files")
        time.sleep(0.1)


def stress_cli_phase(mp: dict, workdir: str) -> dict:
    """(2h a): the stress CLI against 2g's live cluster, once its corpus
    is gone: each of ``STRESS_ROWS`` in a child process with ``--master``
    (the bench's own client of the cluster), its namespace deleted after
    it, then the same rows in-process (the bench's own LocalCluster)."""
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Configuration

    cluster, fs = mp["cluster"], mp["fs"]
    t_phase = time.perf_counter()
    for info in fs.list_status("/"):
        fs.delete(info.path, recursive=True)
    wait_empty(fs)
    address = cluster.master_addresses
    # the CLI's attached client is built as this one is: with no
    # environment it knows no fast-path directory
    probe = FileSystem(address, conf=Configuration(load_env=False))
    try:
        transport = probe.fs_master.transport
    finally:
        probe.close()
    rows = {}
    for name, argv in STRESS_ROWS:
        rows[name] = {"out_of_process": stress_row(name, argv, workdir,
                                                   address)}
        for path in STRESS_PATHS:
            if fs.exists(path):
                fs.delete(path, recursive=True)
    wait_empty(fs)
    for name, argv in STRESS_ROWS:
        rows[name]["in_process"] = stress_row(name, argv, workdir)
    print(f"2h a: the stress CLI against 2g's cluster ({address}; the "
          f"attached client's metadata rides {transport}), each row "
          f"{STRESS_DURATION_S} s, in-process in brackets:", flush=True)
    for name, r in rows.items():
        o, i = r["out_of_process"]["metrics"], r["in_process"]["metrics"]
        mb = (f", {o['mb_per_s']:.1f} MB/s [{i['mb_per_s']:.1f}]"
              if "mb_per_s" in o else "")
        print(f"  {name}: {o['ops_per_s']:.1f} ops/s "
              f"[{i['ops_per_s']:.1f}]{mb}, p50 {o['p50_us']:.1f} us "
              f"[{i['p50_us']:.1f}], p99 {o['p99_us']:.1f} us "
              f"[{i['p99_us']:.1f}]", flush=True)
    return {"master": address, "metadata_transport": transport,
            "rows": rows, "s": time.perf_counter() - t_phase}


def stressbench_phase(mp: dict) -> dict:
    """(2h b): a job master and ``STRESS_JOB_WORKERS`` job workers, each a
    process of its own with the cluster's environment, run one
    ``stressbench`` job of the worker bench (random, 5 s, its default 4 x
    64 MiB shards a task) and then one of the master bench (GetStatus,
    5 s): each task runs in a job worker through its own client, and each
    join must count every task and no error. No job role outlives the
    phase."""
    from alluxio_tpu_torch.job.wire import Status
    from alluxio_tpu_torch.minicluster.multi_process import (
        ManagedProcess, free_port,
    )
    from alluxio_tpu_torch.rpc.job_service import JobMasterClient

    cluster = mp["cluster"]
    t_phase = time.perf_counter()
    jport = free_port()
    env = {**cluster._common_env(),
           "ATPU_MASTER_RPC_ADDRESSES": cluster.master_addresses,
           "ATPU_JOB_MASTER_HOSTNAME": "localhost",
           "ATPU_JOB_MASTER_RPC_PORT": str(jport),
           "ATPU_JOB_WORKER_HEARTBEAT_INTERVAL": "100ms"}
    logs = os.path.join(cluster.base, "logs")
    roles = [ManagedProcess("job-master", env,
                            os.path.join(logs, "job-master.out"))] + [
        ManagedProcess("job-worker", env,
                       os.path.join(logs, f"job-worker{i}.out"))
        for i in range(STRESS_JOB_WORKERS)]
    results = {}
    try:
        roles[0].start()
        jc = JobMasterClient(f"localhost:{jport}")
        deadline = time.monotonic() + MP_BOOT_S
        while True:
            try:
                plans = jc.list_plan_types()
                break
            except Exception:  # noqa: BLE001 - not serving yet
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        if "stressbench" not in plans:
            fail(f"2h b: the job master's plans {plans} lack stressbench")
        for role in roles[1:]:
            role.start()
        while len(jc.list_workers()) < STRESS_JOB_WORKERS:
            if time.monotonic() > deadline:
                fail(f"2h b: {len(jc.list_workers())} job workers "
                     f"registered, want {STRESS_JOB_WORKERS}")
            time.sleep(0.2)
        for bench, options in STRESS_JOBS.items():
            t = time.perf_counter()
            info = jc.wait_for_job(jc.run({
                "type": "stressbench", "bench": bench,
                "options": dict(options)}), timeout_s=STRESS_CHILD_TIMEOUT_S)
            agg = info.result or {}
            if info.status != Status.COMPLETED or \
                    agg.get("tasks") != STRESS_JOB_WORKERS or \
                    agg.get("errors") != 0 or \
                    not agg.get("metrics", {}).get("ops_per_s", 0) > 0:
                fail(f"2h b: stressbench {bench}: {info.status} "
                     f"{info.error_message} {agg}")
            results[bench] = dict(agg, s=time.perf_counter() - t)
    finally:
        for role in reversed(roles):
            role.stop()
    alive = [r.proc.pid for r in roles if r.alive]
    if alive:
        fail(f"2h b: job role processes {alive} outlived their stop")
    for bench, agg in results.items():
        m = agg["metrics"]
        mb = f", {m['mb_per_s']:.1f} MB/s" if "mb_per_s" in m else ""
        print(f"2h b: stressbench {bench} over {agg['tasks']} job workers "
              f"(each a process): {m['ops_per_s']:.1f} ops/s{mb} summed, "
              f"worst p50 {m['p50_us']:.1f} us, p99 {m['p99_us']:.1f} us, "
              f"errors {agg['errors']}, job {agg['s']:.1f} s", flush=True)
    return {"jobs": results, "job_workers": STRESS_JOB_WORKERS,
            "processes_left": 0, "s": time.perf_counter() - t_phase}


def listing(address: str) -> list:
    """Every entry under ``/meta`` (path, folder, length), by path."""
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    client = FsMasterClient(address, fastpath=False)
    try:
        return sorted((i.path, i.folder, i.length)
                      for i in client.list_status("/meta", recursive=True))
    finally:
        client.close()


def replay_seconds(log_path: str, banners: int,
                   timeout_s: float = 30.0) -> float:
    """The journal replay the master's ``banners``-th serving banner in
    its log reports."""
    deadline = time.monotonic() + timeout_s
    while True:
        with open(log_path, errors="replace") as f:
            # the banner's printed line (the log record repeats it)
            got = re.findall(r"^alluxio-tpu master serving .* \(journal "
                             r"replay ([0-9.]+) s\)$", f.read(), re.M)
        if len(got) >= banners:
            return float(got[banners - 1])
        if time.monotonic() > deadline:
            fail(f"2h c: the master printed {len(got)} banners, want "
                 f"{banners}")
        time.sleep(0.1)


def lsm_master_phase(heap_ms: dict) -> dict:
    """(2h c): a second ``MultiProcessCluster`` whose master keeps its
    namespace in the LSM store (``atpu.master.metastore`` LSM, its
    directory in the cluster's, the JAX defaults otherwise): 2d's
    metadata workload by transport, beside 2g's on HEAP; then the master
    restarts on the same journal and metastore directory, and the 2 000
    files must list as before. The replay time and the store's counters
    are printed."""
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient

    t_phase = time.perf_counter()
    base = block_dir(512 << 20)
    cdir = os.path.join(base, "cluster")
    cluster = MultiProcessCluster(cdir, num_workers=1, extra_conf={
        Keys.MASTER_METASTORE.name: "LSM",
        Keys.MASTER_METASTORE_DIR.name: os.path.join(cdir, "metastore")})
    log = os.path.join(cdir, "logs", "master0.out")
    try:
        cluster.start(timeout_s=MP_BOOT_S)
        address = cluster.master_addresses
        first_replay = replay_seconds(log, 1)
        meta = transport_latencies("2h c", address, cluster.base)
        before = listing(address)
        stats_before = MetaMasterClient(address).get_metastore_info()[
            "stats"]
        if stats_before.get("kind") != "CACHING:LSM":
            fail(f"2h c: the master's store is {stats_before}")
        cluster.masters[0].stop()
        t = time.perf_counter()
        cluster.start_master(0)
        cluster.wait_for_primary(MP_BOOT_S)
        restart_s = time.perf_counter() - t
        replay_s = replay_seconds(log, 2)
        after = listing(address)
        stats = MetaMasterClient(address).get_metastore_info()["stats"]
    finally:
        cluster.stop()
        alive = [p.proc.pid for p in cluster.masters + cluster.workers
                 if p.alive]
        shutil.rmtree(base, ignore_errors=True)
    if alive:
        fail(f"2h c: processes {alive} outlived the cluster's stop")
    files = sum(1 for _, folder, _ in before if not folder)
    if files != MASTER_FILES or after != before:
        fail(f"2h c: {files} files listed before the restart, want "
             f"{MASTER_FILES}; after it the listing "
             f"{'differs' if after != before else 'is the same'}")
    lat = "; ".join(
        f"{t} " + ", ".join(
            f"{op} {v['p50_ms']:.3f} / {v['p99_ms']:.3f} ms "
            f"[{heap_ms[t][op]['p50_ms']:.3f} / "
            f"{heap_ms[t][op]['p99_ms']:.3f}]"
            for op, v in meta[t].items())
        for t in TRANSPORTS)
    print(f"2h c: master on LSM (2g's HEAP master in brackets), p50 / p99 "
          f"of {MASTER_FILES} files: {lat}", flush=True)
    print(f"2h c: restart on the same journal and metastore: serving "
          f"again in {restart_s:.3f} s, journal replay {replay_s:.3f} s "
          f"(first boot {first_replay:.3f} s); {len(after)} entries list "
          f"as before; store {stats['kind']}: flushes "
          f"{stats['flushes']}, compactions {stats['compactions']}, runs "
          f"{stats['runs']}, inodes {stats['inodes']} (before the restart "
          f"flushes {stats_before['flushes']}, compactions "
          f"{stats_before['compactions']}, runs {stats_before['runs']})",
          flush=True)
    return {"metadata_ms": {t: meta[t] for t in TRANSPORTS},
            "heap_metadata_ms": heap_ms, "entries": len(after),
            "restart_s": restart_s, "replay_s": replay_s,
            "first_replay_s": first_replay, "store": stats,
            "store_before_restart": stats_before,
            "s": time.perf_counter() - t_phase}


def gate_miss(row: dict) -> "str | None":
    """Why a suite row failed, when its speed gate alone failed it (the
    row's bytes, counts and lookups all right); None otherwise."""
    m, p = row.get("metrics", {}), row.get("params", {})
    if "error" in m:
        return None
    bench = row["bench"]
    if bench in ("obs-tracing-overhead", "obs-profile-overhead",
                 "health-ingest-overhead"):
        return (f"overhead_pct {m.get('overhead_pct')} over the "
                f"{p.get('max_overhead_pct')} % budget") \
            if m.get("overhead_ok") is False else None
    if bench == "obs-critical-path":
        # too few traces is a fault; too little attributed is the gate
        ok = m.get("traces_analyzed", 0) >= p["reads"] // 2 and \
            m.get("attributed_pct", 0.0) < p["min_attributed_pct"]
        return (f"attributed_pct {m.get('attributed_pct')} under the "
                f"{p['min_attributed_pct']} % gate") if ok else None
    if bench == "selfheal-remediation":
        missed = [k for k in ("latency_ok", "overhead_ok")
                  if m.get(k) is False]
        return (f"{', '.join(missed)} false (detect_to_act_s "
                f"{m.get('detect_to_act_s')} against "
                f"{m.get('latency_budget_s')} s, overhead_pct "
                f"{m.get('overhead_pct')} against "
                f"{p.get('max_overhead_pct')} %)") if missed else None
    if bench in ("metadata-striped", "metadata-journal-batch",
                 "metadata-hot-dir", "metadata-cached-getstatus"):
        ok = m.get("speedup", 0.0) < p["min_speedup"]
        key = "speedup"
    elif bench == "metadata-lsm-capacity":
        # HEAP not running out, or LSM not finishing, is the gate; LSM
        # finishing its build with an edge or a lookup missing is not
        ok = m.get("lsm_ok") or not m.get("lsm_build_s")
        return (f"HEAP out of memory {m.get('heap_oom')} (built "
                f"{m.get('heap_built_before_oom')} inodes), LSM finished "
                f"{m.get('lsm_ok')}, under {m.get('cap_mb')} MiB") \
            if ok else None
    elif bench == "smallread-batch":
        ok = m.get("mismatches") == 0
        key = "speedup"
    elif bench == "smallread-native-fastpath":
        ok = m.get("mismatches") == 0 and m.get("native_available") and \
            m.get("shm_stream") and m.get("native_exec_ran")
        key = "speedup"
    elif bench == "ufs-cold-read":
        ok = m.get("speedup_c4", 0.0) < p["min_speedup"]
        key = "speedup_c4"
    elif bench == "remote-warm-read":
        ok = m.get("speedup", 0.0) < p["min_speedup"] or \
            m.get("hedge_wins") == 0
        key = "speedup"
    elif bench == "table-column-projection":
        ok = m.get("projection_speedup", 0.0) < p["min_speedup"]
        key = "projection_speedup"
    elif bench == "table-projection-pushdown":
        ok = m.get("byte_identical") == 1 and \
            m.get("speedup", 0.0) < p["min_speedup"]
        key = "speedup"
    else:
        return None
    return (f"{key} {m.get(key)} under the gate "
            f"(min_speedup {p.get('min_speedup')})") if ok else None


def suite_phase(workdir: str) -> dict:
    """(2d of 2h): ``python -m alluxio_tpu_torch.stress suite`` as a child
    process, its lines written into ``workdir``: it must exit 0, or 1
    with every failed row a gate miss (``gate_miss``); then ``stress
    report`` renders them into ``workdir``, and the page must name every
    row."""
    import html

    from alluxio_tpu_torch.stress.__main__ import SUITE

    t_phase = time.perf_counter()
    lines_path = os.path.join(workdir, "stress-suite.jsonl")
    log_path = os.path.join(workdir, "stress-suite.log")
    with open(lines_path, "w") as out, open(log_path, "w") as err:
        proc = subprocess.run(STRESS_CLI + ["suite"], stdout=out,
                              stderr=err, cwd=workdir, env=stress_env(),
                              timeout=SUITE_TIMEOUT_S)
    suite_s = time.perf_counter() - t_phase
    with open(lines_path) as f:
        rows = [json.loads(line) for line in f if line.startswith("{")]
    if len(rows) != 1 + len(SUITE):
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"2h d: the suite gave {len(rows)} rows, want "
             f"{1 + len(SUITE)} (exit {proc.returncode}): {tail}")
    failed, misses = [], {}
    for (name, _), row in zip((("host-calibration", None),) + SUITE, rows):
        if row["errors"] == 0:
            continue
        why = gate_miss(row)
        if why is None:
            failed.append((name, row))
        else:
            misses[name] = why
    if failed or proc.returncode not in ((1,) if misses else (0,)):
        fail(f"2h d: the suite exited {proc.returncode}; failed rows "
             f"{json.dumps(failed)[:3000]}")
    html_path = os.path.join(workdir, "stress-report.html")
    rep = subprocess.run(STRESS_CLI + ["report", "--input", lines_path,
                                       "--out", html_path],
                         capture_output=True, text=True, timeout=120,
                         cwd=workdir, env=stress_env())
    if rep.returncode != 0:
        fail(f"2h d: stress report exited {rep.returncode}: {rep.stderr}")
    with open(html_path) as f:
        page = f.read()
    unnamed = [r["bench"] for r in rows
               if html.escape(r["bench"]) not in page]
    if unnamed:
        fail(f"2h d: the report does not name {unnamed}")
    print(f"2h d: stress suite, {len(rows)} rows in {suite_s:.1f} s "
          f"(exit {proc.returncode}), report {len(page)} bytes naming "
          f"every row:", flush=True)
    for (name, _), row in zip((("host-calibration", None),) + SUITE, rows):
        m = row["metrics"]
        shown = {k: v for k, v in m.items()
                 if not isinstance(v, (dict, str))}
        gate = f" GATE MISSED: {misses[name]}" if name in misses else ""
        print(f"  {name} ({row['duration_s']:.1f} s, errors "
              f"{row['errors']}){gate}: {json.dumps(shown)}", flush=True)
    return {"rows": rows, "exit": proc.returncode, "gate_misses": misses,
            "s": suite_s, "report_bytes": len(page)}


# -- 2i: the observability loop -----------------------------------------------
#: 2i's cuts of the health and heartbeat keys (PERF.md section 4): at the
#: JAX defaults (a 10 s evaluation, a 60 s stall window, 30 s to fire, 60 s
#: to resolve, 60 s of probation, 10 s heartbeats) the loop would hold the
#: phase for minutes
OBS_KEYS = {
    "atpu.master.health.eval.interval": "500ms",
    "atpu.master.health.stall.window": "3s",
    "atpu.master.health.fire.after": "2s",
    "atpu.master.health.resolve.after": "3s",
    "atpu.master.remediation.probation": "1s",
    "atpu.worker.metrics.heartbeat.interval": "250ms",
    "atpu.user.metrics.heartbeat.interval": "250ms",
}
OBS_RESOLVE_DEADLINE_S = 60.0
OBS_OVERLAY_DEADLINE_S = 30.0
#: the prefetch budget the client boots with (the JAX default); the
#: retune doubles it
OBS_PREFETCH_BUDGET = 256 << 20
#: the critical path's share the obs bench gates (``obs-critical-path``)
OBS_ATTRIBUTED_GATE = 90.0


class OverlayWatch:
    """Samples, every few ms on a thread of its own, the client's
    ``Client.ConfOverlayApplied`` count and the prefetch scheduler's
    budget, so the moment the client applied (and withdrew) the
    master's overlay is known on the wall clock the master stamps."""

    def __init__(self, scheduler) -> None:
        import threading

        from alluxio_tpu_torch.metrics import metrics

        self._counter = metrics().counter("Client.ConfOverlayApplied")
        self._scheduler = scheduler
        self.samples = [self.sample()]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="smoke-overlay-watch")
        self._thread.start()

    def sample(self) -> tuple:
        return (time.time(), self._counter.count, self._scheduler._budget)

    def _loop(self) -> None:
        while not self._stop.wait(0.005):
            s = self.sample()
            if s[1:] != self.samples[-1][1:]:
                self.samples.append(s)

    def first(self, pred) -> "float | None":
        return next((t for t, n, b in self.samples if pred(n, b)), None)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(5)


def web_json(port: int, route: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v1/master/{route}",
            timeout=30) as r:
        return json.loads(r.read())


def obs_epoch(loader, keep: bool) -> tuple:
    """One epoch: each block through the consumer's step (one
    ``scaled_sum``, read back); returns the blocks (when ``keep``), the
    steps' results, the epoch's seconds and the consumer's wait."""
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    blocks, results = [], []
    wait0 = loader.stall_report()["total_wait_s"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for block in loader.epoch():
        results.append(int(rk.scaled_sum(block, 1)))
        if keep:
            blocks.append(block)
    torch.cuda.synchronize()
    return blocks, results, time.perf_counter() - t, \
        loader.stall_report()["total_wait_s"] - wait0


def observability_phase(device, main: dict, k: int) -> dict:
    """(2i): the master's observability loop fed by the card's loader:
    the input-bound fraction of a cold epoch fires the input-stall alert,
    the remediation engine pushes a prefetch-budget overlay that the
    client applies, and device-tier epochs resolve the alert and withdraw
    the overlay."""
    import socket

    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Configuration, Keys, Templates
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster, free_port,
    )
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.prefetch import PrefetchService
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient
    from alluxio_tpu_torch.stress.cluster import wait_cold
    from alluxio_tpu_torch.utils import tracing
    from alluxio_tpu_torch.utils.profiler import profiler

    files = main["files"]
    paths = list(files)
    n = len(paths)
    t_phase = time.perf_counter()
    tier = n * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + n * BLOCK_BYTES)
    web = free_port()
    extra = {Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(BLOCK_BYTES),
             Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
             **OBS_KEYS,
             "atpu.master.remediation.enabled": "true",
             "atpu.master.remediation.dry.run": "false",
             "atpu.master.web.enabled": "true",
             "atpu.master.web.port": str(web),
             "atpu.trace.enabled": "true"}
    print(f"2i: observability keys cut for the phase: {json.dumps(OBS_KEYS)}"
          f"; remediation on (not dry run), web on port {web}, tracing "
          f"on", flush=True)
    cluster = MultiProcessCluster(os.path.join(base, "cluster"),
                                  num_workers=1, extra_conf=extra)
    conf = Configuration(load_env=False)
    for key, value in (("atpu.trace.enabled", True),
                       ("atpu.profile.enabled", True),
                       ("atpu.user.metrics.collection.enabled", True),
                       ("atpu.user.metrics.heartbeat.interval",
                        OBS_KEYS["atpu.user.metrics.heartbeat.interval"])):
        conf.set(key, value)
    mp = {"cluster": cluster, "base": base}
    svc = loader = watch = fs2 = None
    keys = Configuration(OBS_KEYS, load_env=False)
    threshold = keys.get_float(Keys.MASTER_HEALTH_STALL_THRESHOLD)
    # the selfheal bench's bound: fire_after + 2 x eval_interval
    budget_bound_s = keys.get_duration_s(Keys.MASTER_HEALTH_FIRE_AFTER) \
        + 2 * keys.get_duration_s(Keys.MASTER_HEALTH_EVAL_INTERVAL)
    try:
        cluster.start(timeout_s=MP_BOOT_S)
        fs = mp["fs"] = cluster.file_system(conf)
        meta = MetaMasterClient(cluster.master_addresses,
                                retry_duration_s=30.0)
        source = f"client-{socket.gethostname()}-{id(fs):x}"
        pids = [p.proc.pid for p in cluster.masters + cluster.workers]
        print(f"2i: MultiProcessCluster under {base} (pids {pids}) up in "
              f"{time.perf_counter() - t_phase:.2f} s; the client ships as "
              f"{source}", flush=True)

        # (a) the cold corpus: persisted THROUGH, then freed
        from alluxio_tpu_torch.client.streams import WriteType

        t = time.perf_counter()
        for path in paths:
            fs.write_all(path, np.fromfile(files[path][1], dtype=np.uint8),
                         write_type=WriteType.THROUGH)
        write_s = time.perf_counter() - t
        wait_cold(fs, fs.block_master, paths, timeout_s=120.0)
        cold_s = time.perf_counter() - t - write_s
        print(f"2i (a): {n} x {BLOCK_BYTES >> 20} MiB written THROUGH in "
              f"{write_s:.2f} s, every block cold {cold_s:.2f} s later",
              flush=True)

        # (b) the stall epoch, every block through the worker's cold fetch
        svc = PrefetchService.from_fs(fs, paths, seed=SEED,
                                      budget_bytes=OBS_PREFETCH_BUDGET)
        boot_budget = svc.scheduler._budget
        loader = DeviceBlockLoader(fs, paths, device=device,
                                   hbm_bytes=n * BLOCK_BYTES + (64 << 20),
                                   prefetch=2, dtype=np.int32,
                                   prefetch_service=svc)
        hits = metrics().counter("Client.JaxHbmHits")
        watch = OverlayWatch(svc.scheduler)
        applied0 = watch.samples[0][1]
        rk.launches = 0
        t_stall = time.time()
        blocks, results, stall_s, stall_wait = obs_epoch(loader,
                                                         keep=True)
        t_stall_end = time.time()
        order = [ref.path for ref in svc.oracle.epoch_sequence(0)]
        deadline = time.monotonic() + OBS_OVERLAY_DEADLINE_S
        while watch.first(lambda c, b: c > applied0) is None:
            if time.monotonic() > deadline:
                fail(f"2i (b): no overlay reached the client within "
                     f"{OBS_OVERLAY_DEADLINE_S} s of the stall epoch: "
                     f"alerts {meta.get_health()['alerts']}, the fraction "
                     f"{meta.get_metrics_history('Client.InputBoundFraction')}"
                     [:3000])
            time.sleep(0.05)
        t_applied = watch.first(lambda c, b: c > applied0)
        budget_pushed = svc.scheduler._budget
        if budget_pushed == boot_budget:
            fail(f"2i (b): the overlay left the scheduler's budget at "
                 f"{boot_budget}")
        # the same alerts over RPC and over the web server, while firing
        for _ in range(5):
            rpc = meta.get_health(evaluate=False)
            via_web = web_json(web, "health")
            alerts = sorted((a["rule"], a["subject"])
                            for a in rpc["alerts"])
            if alerts == sorted((a["rule"], a["subject"])
                                for a in via_web["alerts"]):
                break
        else:
            fail(f"2i (b): get_health names {alerts}, the web route "
                 f"{via_web['alerts']}")
        if ("input-stall-sustained", source) not in alerts:
            fail(f"2i (b): input-stall-sustained is not firing for "
                 f"{source}: {alerts}")
        gbps = n * BLOCK_BYTES / stall_s / 1e9
        print(f"2i (b): stall epoch {stall_s:.3f} s ({gbps:.2f} GB/s), the "
              f"consumer waits "
              f"{stall_wait:.3f} s; the overlay reached the client "
              f"{t_applied - t_stall_end:+.3f} s after the epoch, budget "
              f"{boot_budget} -> {budget_pushed}; alerts over RPC = web: "
              f"{alerts}", flush=True)

        # (c) device-tier epochs until the alert resolves and the overlay
        # is withdrawn
        t_resolve = time.time()
        epochs = 0
        hit_s = hit_wait = 0.0
        deadline = time.monotonic() + OBS_RESOLVE_DEADLINE_S
        while not (svc.scheduler._budget == boot_budget
                   and watch.first(lambda c, b: c > applied0 + 1)):
            if time.monotonic() > deadline:
                fail(f"2i (c): no withdrawal within "
                     f"{OBS_RESOLVE_DEADLINE_S} s ({epochs} device-tier "
                     f"epochs): {json.dumps(meta.get_health())[:3000]}")
            h0 = hits.count
            last, again, epoch_s, wait_s = obs_epoch(loader, keep=True)
            epochs += 1
            hit_s += epoch_s
            hit_wait += wait_s
            if hits.count - h0 != n:
                fail(f"2i (c): epoch {epochs}: {hits.count - h0} "
                     f"device-tier hits, want {n}")
            if sorted(again) != sorted(results):
                fail(f"2i (c): epoch {epochs}'s step results differ from "
                     f"the stall epoch's")
            time.sleep(0.2)
        t_withdrawn = watch.first(lambda c, b: c > applied0 + 1)
        resolve_s = t_withdrawn - t_resolve
        # the chain over the resident set, in file order
        resident = dict(zip(order, blocks))
        x = torch.cat([resident[p] for p in paths])
        got = int(chain(rk.scaled_sum, x, k))
        launches = rk.launches
        # the consumer's wait on a device-tier hit (the producer's
        # hand-off) beside its whole step a block
        hit_us = {"wait": hit_wait / (epochs * n) * 1e6,
                  "step": hit_s / (epochs * n) * 1e6}
        print(f"2i (c): {epochs} device-tier epochs, the alert resolved "
              f"and the overlay withdrawn {resolve_s:.3f} s after the "
              f"first, budget back at {svc.scheduler._budget}; a hit "
              f"block's wait {hit_us['wait']:.1f} us of a "
              f"{hit_us['step']:.1f} us step", flush=True)

        # (d) the holds, outside the timed windows
        plain = int(chain(rk.scaled_sum_reference, x, k))
        if not got == main["chain"] == plain:
            fail(f"2i (d): chain {got}, main path's {main['chain']}, "
                 f"plain {plain}")
        del x
        for path, block, res in zip(order, blocks, results):
            host = torch.from_numpy(np.fromfile(files[path][1],
                                                dtype=np.int32))
            if not torch.equal(block.cpu(), host):
                fail(f"2i (d): the block of {path} differs from its file")
            want = int(rk.scaled_sum_reference(block, 1))
            if res != want:
                fail(f"2i (d): {path}'s step {res} != plain {want}")
        if {id(b) for b in last} != {id(b) for b in blocks}:
            fail("2i (d): a device-tier epoch did not return the resident "
                 "pages")
        health = meta.get_health()
        audit = health["remediation"]["audit"]
        executed = [a for a in audit if a["action"] == "retune"
                    and a["outcome"] == "executed"
                    and a["rule"] == "input-stall-sustained"]
        reverted = [a for a in audit if a["action"] == "revert"
                    and a["outcome"] == "executed"]
        fired = [a for a in health["recently_resolved"]
                 if a["rule"] == "input-stall-sustained"
                 and a["subject"] == source]
        if not (executed and reverted and fired):
            fail(f"2i (d): retune {executed}, revert {reverted}, resolved "
                 f"alert {fired}")
        series = meta.get_metrics_history(
            "Client.InputBoundFraction", source=source)["series"]
        pts = series[0]["points"] if series else []
        in_stall = [v for ts, v in pts if t_stall <= ts <= t_stall_end]
        in_resolve = [v for ts, v in pts if ts > t_resolve]
        if not (in_stall and in_resolve and max(in_stall) > threshold
                and min(in_resolve) <= threshold):
            fail(f"2i (d): the history's fraction series holds {len(pts)} "
                 f"points, {len(in_stall)} in the stall epoch and "
                 f"{len(in_resolve)} after it: {pts[-40:]}")
        first_stalled = next(ts for ts, v in pts if v > threshold)
        # the rule averages the window: its first violating evaluation
        # (the alert's ``since``) comes once the window's mean crosses
        since = fired[0]["since"]
        timeline = {"first_violation_s": since - first_stalled,
                    "alert_fired_s": fired[0]["fired_at"] - first_stalled,
                    "action_s": executed[0]["at"] - first_stalled,
                    "client_applied_s": t_applied - first_stalled,
                    "resolved_s": fired[0]["resolved_at"] - first_stalled,
                    "withdrawn_s": t_withdrawn - first_stalled}
        bound = {
            "action_from_violation_s": executed[0]["at"] - since,
            "client_from_violation_s": t_applied - since}

        def verdict(x):
            return "met" if x <= budget_bound_s else "missed"

        print(f"2i (d): every block equals its file, every step the plain "
              f"version's, the chain {got} == main path == plain; from the "
              f"first stalled sample: the rule's first violating "
              f"evaluation {timeline['first_violation_s']:.3f} s, alert "
              f"fired {timeline['alert_fired_s']:.3f} s, retune executed "
              f"{timeline['action_s']:.3f} s "
              f"({verdict(timeline['action_s'])}), overlay applied in the "
              f"client {timeline['client_applied_s']:.3f} s "
              f"({verdict(timeline['client_applied_s'])}), resolved "
              f"{timeline['resolved_s']:.3f} s, withdrawn "
              f"{timeline['withdrawn_s']:.3f} s; from the first violating "
              f"evaluation: retune {bound['action_from_violation_s']:.3f} "
              f"s ({verdict(bound['action_from_violation_s'])}), client "
              f"{bound['client_from_violation_s']:.3f} s "
              f"({verdict(bound['client_from_violation_s'])}), against the "
              f"selfheal bench's bound {budget_bound_s} s; the history "
              f"holds {len(in_stall)} stall-epoch and {len(in_resolve)} "
              f"later samples of the fraction (max {max(in_stall):.3f}, "
              f"last {in_resolve[-1]:.3f})", flush=True)
        loader.close()
        loader = None
        svc.close()
        svc = None
        del blocks, last, resident

        # (e) one traced remote read through the worker's process: the
        # client's striped read is the trace's root, its stripes' worker
        # spans its children
        conf2 = conf.copy()
        conf2.set(Keys.USER_SHORT_CIRCUIT_ENABLED, False)
        conf2.set(Keys.USER_METRICS_COLLECTION_ENABLED, False)
        conf2.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, BLOCK_BYTES // 8)
        fs2 = cluster.file_system(conf2)
        with fs2.open_file(paths[0]) as f:
            t_read = time.time() * 1000.0
            data = f.pread(0, BLOCK_BYTES)
        if np.frombuffer(data, dtype=np.uint8).tobytes() != \
                np.fromfile(files[paths[0]][1], dtype=np.uint8).tobytes():
            fail("2i (e): the traced read's bytes differ from the file")
        deadline = time.monotonic() + 30.0
        while True:
            reads = [sp for sp in meta.get_trace(
                prefix="atpu.client.remote_read", limit=4000)["spans"]
                if sp["start_ms"] >= t_read]
            spans = meta.get_trace(trace_id=reads[-1]["trace_id"],
                                   limit=4000)["spans"] if reads else []
            sources = {sp.get("source", "") for sp in spans}
            if any(x.startswith("worker-") for x in sources) and \
                    any(x.startswith("client-") for x in sources):
                break
            if time.monotonic() > deadline:
                fail(f"2i (e): the traced read's spans come from "
                     f"{sources} only")
            time.sleep(0.1)
        tid = reads[-1]["trace_id"]
        cp = meta.get_trace_profile(trace_id=tid)["critical_path"]
        attributed = cp["attributed_pct"]
        obs_miss = None if attributed >= OBS_ATTRIBUTED_GATE else (
            f"attributed_pct {attributed} under the "
            f"{OBS_ATTRIBUTED_GATE} % obs gate")
        print(f"2i (e): one traced {BLOCK_BYTES >> 20} MiB remote read in "
              f"{BLOCK_BYTES // 8 >> 20} MiB stripes: trace {tid}, "
              f"{len(spans)} spans from {sorted(sources)}; critical path "
              f"wall {cp['wall_ms']} ms, attributed {attributed} %"
              f"{' GATE MISSED: ' + obs_miss if obs_miss else ''}; "
              f"segments {json.dumps(cp['segments'])}", flush=True)

        # (f) the client's profile at the master
        flame = None
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            flame = web_json(web, f"profile?source={source}")["flame"]
            if flame and any("torch_io.py:" in key
                             for key in flame["stacks"]):
                break
            time.sleep(0.25)
        else:
            fail(f"2i (f): the master's profile of {source} holds no "
                 f"loader frame: {json.dumps(flame)[:2000]}")
        producer = sum(c for key, c in flame["stacks"].items()
                       if "torch_io.py:producer" in key)
        print(f"2i (f): the master's profile of the client: "
              f"{flame['samples']} samples, {len(flame['stacks'])} stacks, "
              f"{producer} in the loader's producer", flush=True)
    finally:
        if watch is not None:
            watch.stop()
        if loader is not None:
            loader.close()
        if svc is not None:
            svc.close()
        if fs2 is not None:
            fs2.close()
        tracing.set_tracing_enabled(False)
        profiler().stop()
        if "fs" in mp:
            stop_mp_cluster(mp)
        else:
            cluster.stop()
            shutil.rmtree(base, ignore_errors=True)
    out = {"blocks": n, "block_bytes": BLOCK_BYTES, "keys": OBS_KEYS,
           "write_s": write_s,
           "cold_s": cold_s, "stall_epoch_s": stall_s,
           "stall_consumer_wait_s": stall_wait,
           "boot_budget": boot_budget, "pushed_budget": budget_pushed,
           "resolve_epochs": epochs, "resolve_s": resolve_s,
           "hit_block_us": hit_us,
           "timeline_s": timeline, "bound_s": budget_bound_s,
           "from_violation_s": bound,
           "fraction_max": max(in_stall), "fraction_last": in_resolve[-1],
           "alerts": alerts, "trace_spans": len(spans),
           "trace_sources": sorted(sources),
           "critical_path": {"wall_ms": cp["wall_ms"],
                             "attributed_pct": attributed,
                             "segments": cp["segments"]},
           "gate_miss": obs_miss,
           "profile_samples": flame["samples"],
           "profile_producer_samples": producer,
           "launches": launches, "chain": got,
           "s": time.perf_counter() - t_phase}
    print(f"2i: {out['s']:.1f} s, scaled_sum launched {launches} times",
          flush=True)
    return out


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


def decode_phase(device, fs, files: dict, num_blocks: int,
                 block_bytes: int) -> None:
    import torch

    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    rec_bytes = image_record_bytes(H, W, C)
    per_block = block_bytes // rec_bytes
    loader = DeviceBlockLoader(fs, list(files), device=device,
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


def profile_steps(loader, step, batch: int, n_steps: int, state,
                  trace_dir: str):
    """``n_steps`` more steps under the port's ``device_trace`` (a
    ``torch.profiler`` capture, written as a Chrome trace into
    ``trace_dir``): kernel launches per step and the share of the window
    in which the card was busy (the union of its kernel and copy
    intervals over the window); the trace file must hold the kernels."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from alluxio_tpu_torch.client.torch_io import batched_device_iterator
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)
    from alluxio_tpu_torch.utils.tracing import device_trace

    batches = itertools.islice(batched_device_iterator(
        loader, record_bytes=image_record_bytes(H, W, C),
        batch_size=batch), n_steps)
    torch.cuda.synchronize()
    with device_trace(trace_dir) as trace:
        for recs in batches:
            with record_function("atpu.decode"):
                imgs, labels = decode_image_records(recs, height=H,
                                                    width=W, channels=C)
            state, _ = step(state, imgs, labels)
        torch.cuda.synchronize()
    prof = trace.profile
    with open(trace.path) as f:
        traced = json.load(f).get("traceEvents", [])
    trace_kernels = sum(1 for e in traced if e.get("cat") == "kernel")
    os.remove(trace.path)
    events = list(prof.events())
    # the named regions also appear on the device timeline, spanning the
    # kernels inside them: they are neither launches nor busy time
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("atpu.")]
    if not dev:
        return state, None
    if not trace_kernels:
        fail(f"device_trace: the profiler saw {len(dev)} device events, "
             f"the Chrome trace file holds no kernel")
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
        "trace_kernel_events": trace_kernels,
        "host_ms_per_step": host_ms,
        "device_busy_us_per_step": busy / n_steps,
        "window_us_per_step": window / n_steps,
        "busy_share": busy / window if window > 0 else None,
        "top": [(a.key, a.count / n_steps,
                 a.self_device_time_total / n_steps) for a in top]}


def train_phase(device, workdir: str, fs, files: dict) -> dict:
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
    loader = DeviceBlockLoader(fs, list(files), device=device,
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
        traces = os.path.join(workdir, "traces")
        (model, opt), vprof = profile_steps(loader, vit, VIT_BATCH,
                                            PROFILE_STEPS, (model, opt),
                                            traces)
        _, lprof = profile_steps(loader, linear, BATCH, PROFILE_STEPS,
                                 (params, ()), traces)
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
                  f"{prof['trace_kernel_events']} kernels in the "
                  f"device_trace Chrome trace; host ms/step "
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


def data_plane_check(device, mesh, workdir: str, fs, files: dict) -> dict:
    """(a): the main path's shards through ``MeshBlockCache``, read from
    the cluster behind ``fs``; the turnover's two fresh shards are
    written there first."""
    import torch

    from alluxio_tpu_torch.parallel.ici_store import MeshBlockCache

    views = [np.memmap(path, np.uint8, "r") for _, path in files.values()]
    n = len(views)
    cache = MeshBlockCache(mesh, block_bytes=BLOCK_BYTES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = cache.load_global(fs, list(files), report=False)
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
    write_files(fs, {p: new[p] for p in rows.values()})
    ptr = cached.data_ptr()
    cached = cache.turnover(cached, fs,
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


def train_batches(device, fs, files: dict, n_batches: int) -> list:
    """The first ``n_batches`` ViT batches of the train phase, as tokens
    and labels on the card."""
    from alluxio_tpu_torch.client.torch_io import (DeviceBlockLoader,
                                                   batched_device_iterator)
    from alluxio_tpu_torch.models.transformer import images_to_tokens
    from alluxio_tpu_torch.ops.decode import (decode_image_records,
                                              image_record_bytes)

    loader = DeviceBlockLoader(fs, list(files), device=device, hbm_bytes=0)
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


def mesh_phase(device, workdir: str, fs, shard_files: dict,
               records: dict) -> dict:
    """The mesh layer over an NCCL group of one rank on this card, its
    shards and records read from the cluster behind ``fs``."""
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
               "data_plane": data_plane_check(device, mesh, workdir, fs,
                                              shard_files)}
        cfg = TransformerConfig(
            vocab_or_patch_dim=PATCH * PATCH * C, n_classes=N_CLASSES,
            max_len=(H // PATCH) * (W // PATCH), **VIT_WIDTHS)
        batches = train_batches(device, fs, records, MESH_STEPS)
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
    # the block files, the cluster's MEM tier, the records, the page cache
    workdir = block_dir(NUM_BLOCKS * BLOCK_BYTES
                        + (NUM_BLOCKS * BLOCK_BYTES + (256 << 20))
                        + DECODE_BLOCKS * BLOCK_BYTES + PAGE_CACHE_BYTES)
    main = mp = None
    try:
        main = main_path(device, workdir, NUM_BLOCKS, BLOCK_BYTES, K)
        shard_files = main["files"]
        prefetch = prefetch_phase(device, main, K)
        master = master_phase(device, main, K)
        suite = {"random_4k": suite_random_4k(device, main)}
        # the table read path runs no kernel of the port (JAX's config #4
        # reaches no Pallas kernel): its count is read all the same
        from alluxio_tpu_torch.ops import reduce_kernel as rk
        rk.launches = 0
        suite["projection"] = suite_projection(device, main)
        table_launches = rk.launches
        # the cluster's MEM tier leaves /dev/shm before 2e and 2c build
        # their own
        stop_cluster(main)
        suite["prefetch"] = suite_prefetch(device, K)
        rk.launches = 0
        suite["projection_real"] = suite_projection_real(device)
        suite["pushdown"] = suite_pushdown()
        table_launches += rk.launches
        suite["table_launches"] = table_launches
        suite["write_eviction"] = suite_write_eviction(main)
        rk.launches = 0
        clairvoyant = clairvoyant_phase(device)
        clairvoyant["launches"] = rk.launches
        print(f"table path: scaled_sum launched {table_launches} times, "
              f"clairvoyant path {clairvoyant['launches']} (neither has a "
              f"kernel of its own)", flush=True)
        page_cache = page_cache_phase(device, workdir, main)
        worker = worker_phase(device, workdir, main, K)
        # 2g: the main path again, its worker a process of its own; the
        # cluster then serves decode, train and mesh
        mp = start_mp_cluster(NUM_BLOCKS)
        multi = mp_phase(device, mp, main, {
            "cold_write_s": main["cold_write_s"],
            "epoch1_s": main["epoch1_s"],
            "consumer_wait_s": main["consumer_wait_s"],
            "lease_wait_ms": worker["shm_read"]["lease_wait_ms"],
            "shm_map_ms": worker["shm_read"]["shm_map_ms"],
            "metadata_ms": {t: master[t] for t in TRANSPORTS}}, K)
        del main["blocks"]
        files = record_files(workdir, DECODE_BLOCKS, BLOCK_BYTES)
        write_files(mp["fs"], files)
        decode_phase(device, mp["fs"], files, DECODE_BLOCKS, BLOCK_BYTES)
        # the train path runs no kernel of the port (the JAX e2e path
        # reaches no Pallas kernel): its count is read all the same
        rk.launches = 0
        train = train_phase(device, workdir, mp["fs"], files)
        train["kernel_launches"] = {"scaled_sum": rk.launches}
        print(f"train path: scaled_sum launched {rk.launches} times (the "
              f"path has no kernel of its own)", flush=True)
        rk.launches = 0
        mesh = mesh_phase(device, workdir, mp["fs"], shard_files, files)
        mesh["kernel_launches"] = {"scaled_sum": rk.launches}
        # 2h: the stress CLI and the stressbench job on 2g's cluster, then
        # the master on LSM and the suite on clusters of their own; the
        # path has no kernel of its own, and its count is read all the same
        t_stress = time.perf_counter()
        rk.launches = 0
        stress = {"cli": stress_cli_phase(mp, workdir),
                  "jobs": stressbench_phase(mp)}
        stop_mp_cluster(mp)
        mp = None
        stress["lsm"] = lsm_master_phase(multi["metadata_ms"])
        stress["suite"] = suite_phase(workdir)
        stress["launches"] = rk.launches
        stress["s"] = time.perf_counter() - t_stress
        print(f"stress path: scaled_sum launched {rk.launches} times (the "
              f"path has no kernel of its own); 2h {stress['s']:.1f} s",
              flush=True)
        # 2i: the observability loop on a process cluster of its own
        observability = observability_phase(device, main, K)
    finally:
        try:
            if mp is not None:
                stop_mp_cluster(mp)
        finally:
            if main is not None:
                stop_cluster(main)
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"main": {
        "cold_write_s": main["cold_write_s"],
        "cold_write_gb_per_s": NUM_BLOCKS * BLOCK_BYTES
        / main["cold_write_s"] / 1e9,
        "epoch1_s": main["epoch1_s"], "block_opens": main["opens"],
        "shm_leases": main["shm_leases"]}}), flush=True)
    print(json.dumps({"prefetch": prefetch}), flush=True)
    print(json.dumps({"master": master}), flush=True)
    print(json.dumps({"page_cache": page_cache}), flush=True)
    print(json.dumps({"worker": worker}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"suite": suite}), flush=True)
    print(json.dumps({"clairvoyant": clairvoyant}), flush=True)
    print(json.dumps({"multi_process": multi}), flush=True)
    print(json.dumps({"stress": stress}), flush=True)
    print(json.dumps({"observability": observability}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "scaled_sum", "route": "cuda",
        "source": "alluxio_tpu_torch/ops/csrc/reduce_kernel.cu",
        "replaces": "alluxio_tpu/ops/reduce_kernel.py:51",
        "launches": main["launches"],
        # each path's own run, its count set to 0 just before it
        "launches_by_path": {
            "main": main["launches"],
            "prefetch": prefetch["scan_launches"],
            "master": master["scan_launches"],
            "suite": suite["prefetch"]["launches"],
            "table": suite["table_launches"],
            "clairvoyant": clairvoyant["launches"],
            "page_cache": page_cache["scan_launches"],
            "worker": worker["launches"],
            "worker_shm": worker["shm_read"]["scan_launches"],
            "worker_cold": worker["cold_launches"],
            "worker_qos": worker["qos"]["launches"],
            "multi_process": multi["launches"],
            "train": train["kernel_launches"]["scaled_sum"],
            "mesh": mesh["kernel_launches"]["scaled_sum"],
            "stress": stress["launches"],
            "observability": observability["launches"]},
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
