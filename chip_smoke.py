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
   store's flushes, compactions and runs print; (d), after 2k: ``python
   -m alluxio_tpu_torch.stress suite`` as a child process (its rows cut
   as ``SUITE_CUTS`` says and the pause between rows as ``SUITE_GAP_S``,
   each cut printed) over every row but the six of ``SUITE_TAKEN``,
   whose benches another phase already ran with the same options (five
   of 2h a's in-process rows and 2k (f)'s ``stress ha``): their lines
   are taken from those runs, each printed with its phase. The child's
   lines go into the work directory: it must exit 0, or 1 with each
   failed row failed by its speed gate alone (``gate_miss``: a crash, a
   wrong byte or count fails the run), every row and gate printed;
   ``stress report`` renders all the suite's rows, in its order, into
   the work directory, and the page must name every row.
2l. the operator's shells, on 2g's cluster after 2h b and before it
   stops: every step is a child ``python -m alluxio_tpu_torch.shell.main
   --master ... --job-master ...``, timed, its exit code checked. The
   cluster's roles carry ``shell_cluster_conf`` (a job master's port, at
   which the launched master attaches its persistence scheduler and
   replication checker; the host's name as locality; the web server; a
   login token), and a job master and a job worker start for the phase.
   (a) 16 seeded 32 MiB shards (512 MiB) in a local directory go in by
   ``fs copyFromLocal`` (ASYNC_THROUGH, the default); ``fs ls`` and
   ``fs du -s`` must show 16 files and 512 MiB, ``fs checksum`` each
   file's ``hashlib.md5``, and every file must reach PERSISTED (``fs ls``
   and ``fs stat`` confirm). (b) Epoch 1 of a loader over ``/shell``:
   every block on the SHM rung, each block's ``scaled_sum`` the plain
   version's and numpy's over its file, the chain numpy's. (c) ``fs
   free``, then ``fsadmin report capacity`` must show the worker's used
   bytes fallen by at least 512 MiB; ``fs distributedLoad`` must
   complete and ``job ls`` show it; epoch 2 on the SHM rung with epoch
   1's sums. (d) ``fsadmin report stall`` one client metrics heartbeat
   after the epochs: its total wait, less the one before them, must be
   the loaders' own consumer wait; ``fsadmin trace --on``, a traced
   epoch of 4 blocks, then ``fsadmin report readpath`` must have
   analyzed a trace; ``fsadmin report summary``, ``doctor`` and
   ``getConf`` exit 0. (e) ``validateConf`` on the roles' configuration
   exits 0; ``runOperation`` creates 200 files over 4 threads; the
   master's ``/api/v1/master/config`` lists every key of the registry,
   the login token masked.
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
2j. the master's guards, after 2i: a ``MultiProcessCluster`` of its own
   (its master and one worker, each a process, in ``/dev/shm``) with RPC
   admission on at the JAX defaults and the detection, sync, cleanup and
   health keys cut (``GUARD_KEYS``, each printed with its default). (a)
   32 of the main path's shards, 16 MUST_CACHE and 16 CACHE_THROUGH, and
   one loader epoch onto the card, every block's ``scaled_sum`` the plain
   version's; the worker's process stopped (``SIGSTOP``) until the master
   has marked exactly the 16 MUST_CACHE files ``LOST`` (never a persisted
   one), then resumed until it has re-registered and all 16 are
   ``NOT_PERSISTED`` again (each time printed); a second epoch gives
   every block the first's sum. (b) A persisted ``/sync`` directory made
   a sync point; 16 seeded 32 MiB files dropped into its UFS directory
   from outside (``os.replace``) must be listed at their lengths (the
   seconds printed), read cold onto the card with each block's sum its
   file's; 4 deleted in the UFS must leave the listing; ``stop_sync``
   must leave no sync point. (c) The loader's own principal runs an
   epoch of (a)'s shards with a 20 Hz ``get_status`` probe, alone, beside
   a child process of another principal flooding ``get_status`` from 8
   threads, and alone again: the epoch, the consumer's wait and the
   probe's p50/p99 of each turn, the flood's calls, the shed count by
   principal, the audit lines with ``allowed=false`` and the writer's
   dropped counts, and the tenant-overload alert's state; the victim must
   never be shed, the flood must be, and the audited plus the dropped
   denials must equal the shed count. (d) An aged and a fresh persist
   temp in the root UFS: the aged one must go within two cleanup ticks,
   the fresh one must stay; no role process may outlive the stop.
2k. master HA, after 2j: a ``MultiProcessCluster`` of its own, three HA
   masters on EMBEDDED journals (the JAX election timeouts, 300-600 ms)
   and one worker (a MEM tier of 48 x 32 MiB + 256 MiB), each a process,
   with the scheduled backup, the masters' web servers and standby reads
   on, and the health evaluation and backup interval cut (``HA_KEYS``,
   each printed with its default). (a) The seconds to the first leader;
   32 of the main path's shards written CACHE_THROUGH through the primary
   and epoch 1 onto the card, one ``scaled_sum`` a block against its plain
   version, then the ``K`` chain over the loaded blocks equal to the plain
   chain and to the chain over the same files. (b) A fresh client's
   loader (each file's block list crosses the master) beside a writer
   child creating small files at 50 a second, each acknowledgement
   recorded in a ``WriteLedger``; after 8 consumed blocks the primary is
   SIGKILLed: the seconds until ``get_masters`` names a new leader, to the
   writer's first acknowledged create and until the worker has
   re-registered, the loader's longest gap and epoch 2 against epoch 1,
   each block's rung and how many left the SHM rung while the new leader
   knew no locations; every acknowledged create must be on the new
   leader. (c) 1000 ``get_status`` calls a side, alternated, through a
   client with standby reads on (both survivors listed; it reads the
   standby) and a strong one (the primary), p50/p99 of each;
   ``Client.StandbyReads`` must move, and stamped standby listings must
   hold every acknowledged create the stamp covers. (d)
   ``master-quorum-degraded`` must fire; the killed master restarted, the
   seconds until it has applied the leader's sequence, the ``/masters``
   route's rows printed; the rule must resolve. (e) A scheduled backup
   covering the writer's creates, taken while a third epoch runs, seeds a
   LOCAL master (``atpu.master.journal.init.from.backup``) that must list
   every shard and every acknowledged create, as the leader does; after
   the cluster's stop (no role process may outlive it) a copy of a
   master's journal goes embedded -> local -> embedded and both migrated
   masters must list the same. (f) ``stress ha`` at the JAX defaults: its
   MTTR against the gate of two election timeouts plus the rank stagger
   (a miss is recorded, not a failure).

2n. the UFS connectors, last: a fake S3 server (``tests/testutils/
   fake_s3.py``, loaded by path in a child process). (a) 16 seeded int32
   shards of 32 MiB put into its bucket through the port's
   ``S3UnderFileSystem`` (multipart, SigV4), the rate printed; (b) a
   ``MultiProcessCluster`` (one worker, a MEM tier of 16 x 32 MiB +
   256 MiB, the worker's metrics heartbeat at 200 ms) mounts
   ``s3://bkt/data`` at ``/s3`` with the endpoint and keys as mount
   properties and lists the 16 files with their lengths; (c) a
   ``DeviceBlockLoader`` with a device tier reads them cold: the worker's
   fetch counters (as the master aggregates them) must show 16 fetches,
   16 UFS block reads, every byte once, no fallback and no failure, and
   each block's ``scaled_sum`` must equal the plain version and numpy's
   sum of the bucket's bytes; the epoch's seconds and GB/s beside 2c's
   local cold rung; (d) a second epoch: 16 device-tier hits, no UFS
   read; (e) a Parquet file of 1 Mi rows written through
   ``arrow_file_system``, read back through it and through
   ``AlluxioTpuFileSystem``, one column summed on the card against
   numpy. The s3 scheme must be registered: a missing connector fails
   the phase.
2o. the serving surfaces, last, on a ``MultiProcessCluster`` of their own
   whose roles ship their records to a log server that ``python -m
   alluxio_tpu_torch.shell.main logserver`` launched; the proxy and the
   FUSE mount are children of the same shell (``proxy``, ``fuse``), as
   an operator starts them. (a) 16 seeded int32 shards of 32 MiB
   written MUST_CACHE under ``/s3/corpus``; (b) FUSE, by
   ``SERVE_FUSE_ROUTE`` (chosen once from ``tools/fuse_probe.py`` on the
   card's host, which has no ``libfuse.so.2``: ``FuseFs``'s
   open/read/release in process, 128 KiB reads, and the ``fuse`` child
   must refuse with exit 1; "kernel": ``os.listdir`` and ``readinto``
   through the child's mount): the listing equals ``list_status``, each
   shard by path into a pinned host buffer, onto the card and scanned
   by ``scaled_sum`` (== plain == numpy's sum of the file's bytes), a
   seeded 32 MiB file copied in reads back equal through ``FileSystem``;
   the epoch's seconds, GB/s and consumer wait beside the main path's
   epoch 1; (c) the proxy: ListBuckets and ListObjectsV2 equal the
   listing, each shard in 8 MiB ranged GETs through the port's
   ``S3Client`` into a pinned buffer, onto the card and scanned as in
   (b); a 4-part multipart PUT reads back equal; one REST ``get-status``
   equals ``get_status``; (d) Hive: a Parquet table of 1 Mi seeded rows
   written CACHE_THROUGH under the mount ``/warehouse``, a fake metastore
   (``tests/testutils/fake_hms.py``, loaded by path in a child) naming
   it at its UFS URI; ``validateHms`` through the shell exits 0, ``attachdb
   hive`` through the table master lists it at ``/warehouse/events``, and
   three columns through the planned reader go to the card (each int32
   column's ``scaled_sum`` == plain == numpy); (e) the log server's files
   hold the master's, the worker's, the proxy's and the FUSE child's
   records; every role stops, none is left behind, and no mount is left.
2p. deployment, last: the cluster the port's YARN path stands up. (a) A
   fake ResourceManager (``tests/testutils/fake_yarn.py``, loaded by
   path in a child, its hosts ``localhost`` and ``127.0.0.1``) and
   ``python -m alluxio_tpu_torch.yarn submit --workers 1 -C ...`` (the
   roles' ports and directories under a work directory of their own,
   the host's name as locality); the application ACCEPTED. (b) ``python
   -m alluxio_tpu_torch.yarn.am`` as a child in its own process group:
   through ``SubprocessLauncher`` it starts the master and one worker
   (``env ATPU_... python -m alluxio_tpu_torch.shell.main master|worker``,
   ``python`` a shim under ``build/`` that runs this interpreter); the
   master must answer and the worker register. (c) A job master and a
   job worker launched through the shell; the launched master must log
   its checkers attached. (d) A fake Kubernetes API server
   (``tests/testutils/fake_k8s.py`` in a child, its CRD constants the
   port's operator's), one ``Dataset`` CR (a read-only mount of a local
   directory of 16 seeded 32 MiB shards, ``replicas: 1``, Eager) and
   ``python -m alluxio_tpu_torch.operator.controller --interval 0.5``
   as a child until the CR is Bound with ``fileCount`` 16 and
   ``cachedPercent`` 100. (e) One loader epoch over the mount onto the
   card, one block a file at the master's default block size, every
   block on the SHM rung, each ``scaled_sum`` the plain version's and
   numpy's sum of the UFS file; its GB/s and consumer wait beside the
   main path's epoch 1. (f) ``replicas: 0`` (every ``replication_min``
   0), then the CR deleted: the operator frees and unmounts (the
   worker's used bytes must fall by the corpus) and strips its
   finalizer (the CR must go). (g) ``yarn kill`` leaves the application
   KILLED; the AM's process group and the job roles stop, none left.

2q. surface, right after the train phase, on 2g's cluster: the train
   phase's bf16/AdamW ViT state saved with ``save_train_state(
   write_type=)`` MUST_CACHE and CACHE_THROUGH (each reloaded onto the
   card bit for bit, the CACHE_THROUGH files PERSISTED with equal UFS
   bytes, the MUST_CACHE files not persisted, one finite step from each
   reloaded state), then one of the main path's cached blocks through
   the striped remote read with tracing on at sample rate 1: the read's
   trace id must be an exemplar on a ``Client.ReadLatency`` bucket of
   the client's exposition and a span of the tracer, and ``scaled_sum``
   over the block on the card must equal its plain version.

2r. launchers, right after 2q: a cluster of its own in a work directory
   of its own (its site file with free ports, its log and pid
   directories), stood up and taken down by the port's scripts under
   ``bin/``. (a) ``bin/alluxio-tpu-torch-start.sh local``: the master
   must answer on the site file's port and the worker register; (b)
   ``bin/alluxio-tpu-torch fs copyFromLocal`` of 16 seeded 32 MiB shards
   and ``fsadmin report``, each a child interpreter; (c) two loader
   epochs over the shards onto the card with a device tier of them all,
   epoch 1 on the SHM rung, every block's ``scaled_sum`` the plain
   version's and numpy's sum of its local file, epoch 2 16 of 16
   device-tier hits; (d) the port's examples with ``--master`` as
   children on the card: ``torch_basic_operations`` and
   ``torch_multi_mount`` end in ``done.``, and
   ``torch_training_pipeline``'s per-epoch losses are within
   ``LAUNCH_LOSS_RTOL`` of the same example run in process with
   ``--device cpu``; (e) ``bin/alluxio-tpu-torch-mount.sh Check`` reports
   the site file's MEM tier; (f) ``bin/alluxio-tpu-torch-stop.sh all``:
   no role process is left.

It prints the card's name and power limit, whether pyarrow imports,
one ``{"main": {...}}``
line, one ``{"prefetch": {...}}`` line, one ``{"master": {...}}`` line,
one ``{"page_cache": {...}}`` line, one ``{"worker": {...}}``
line, one ``{"train": {...}}``
line, one ``{"mesh": {...}}`` line, one ``{"suite": {...}}`` line, one
``{"clairvoyant": {...}}`` line, one ``{"multi_process": {...}}`` line,
one ``{"stress": {...}}`` line, one ``{"observability": {...}}`` line,
one ``{"guards": {...}}`` line, one ``{"ha": {...}}`` line, one
``{"shell": {...}}`` line, one ``{"s3": {...}}`` line, one
``{"serving": {...}}`` line, one ``{"deployment": {...}}`` line, one
``{"surface": {...}}`` line, one ``{"launchers": {...}}`` line, one
``{"phase_s": {...}}`` line with every phase's seconds (2r's by step
too), one ``{"kernels": [...]}`` line,
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
#: 2e #3's traced rerun loads this fraction of the files (a cut, since
#: the script ran past its time on a slow host: PERF.md section 4)
SUITE_TRACED_DIVISOR = 4
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
#: ring attention's dq, dk and dv against autograd through
#: reference_attention are held to the same bounds: float32 within
#: RING_ATOL, bf16 within RING_BF16_TOL of each tensor's largest
#: |gradient| (both compute in float32 and round once to bf16)
PIPE_SHAPE = (8, 1024, 256)
#: (f) the sequence-parallel ViT loss and gradients against the plain
#: loss_fn on the same weights, both bf16: the ring merges attention in
#: another order, so a bf16 result may round apart and the rounding
#: compounds through the layers; held as the first ViT step is, each
#: gradient leaf within 2**-5 of its largest magnitude and the loss
#: within 1e-3
SEQ_TOL = FIRST_STEP_TOL
SEQ_LOSS_ATOL = FIRST_STEP_LOSS_ATOL

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


#: every phase's seconds, in the order the phases ran (printed on one
#: line at the end)
PHASE_S: dict = {}
#: the card's name and power limit as ``nvidia-smi`` prints them, set by
#: ``setup()``
CARD = ""


def phase(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds added to ``PHASE_S[name]``."""
    t = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
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

    # the traced run: the same config at a quarter of the files (a cut,
    # PERF.md section 4), every span kept in the ring
    traced_files = max(1, files // SUITE_TRACED_DIVISOR)
    print(f"suite #3: cut: the traced run loads {traced_files} of the "
          f"{files} files", flush=True)
    t1 = time.perf_counter()
    tracing.tracer().clear()
    try:
        traced = tpu_suite.config3_prefetch(
            device, file_bytes=file_bytes, num_files=traced_files,
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
                    "files": traced_files,
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
    print(f"suite #3 traced run ({traced_files} files, worker metrics "
          f"heartbeat held off): load "
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
    ``num_blocks`` blocks plus 256 MiB and room for the records, the
    mesh's fresh shards and 2l's corpus, the keys 2l needs
    (``shell_cluster_conf``), and its ``FileSystem``."""
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster, free_port,
    )

    tier = num_blocks * BLOCK_BYTES + (256 << 20) \
        + (DECODE_BLOCKS + 2) * BLOCK_BYTES + SHELL_SHARDS * BLOCK_BYTES
    # the UFS copy of 2l's persisted corpus lives beside the tier
    base = block_dir(tier + SHELL_SHARDS * BLOCK_BYTES)
    job_port = free_port()
    cluster = MultiProcessCluster(
        os.path.join(base, "cluster"), num_workers=1, extra_conf={
            Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(BLOCK_BYTES),
            Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
            **shell_cluster_conf(job_port)})
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
            "boot_s": boot_s, "pids": pids, "job_port": job_port}


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
#: the same cut, ``SUITE_CUTS``), so that the script stays under 925 s
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


# -- 2l: the operator's shells ------------------------------------------------
#: 2l's corpus: 16 of the main path's 32 MiB shards (512 MiB), made from
#: SEED in a local directory and copied in by ``fs copyFromLocal``
SHELL_SHARDS = 16
#: the blocks of 2l (d)'s traced epoch
SHELL_TRACE_BLOCKS = 4
#: 2l's cut of the client metrics heartbeat (the JAX default is 10 s), so
#: that the stall report is read one interval after the epochs
SHELL_METRICS_HEARTBEAT = "500ms"
#: ``runOperation``'s operation, count and threads in 2l (e)
SHELL_RUNOP = ("CreateFile", 200, 4)
#: a login token in the roles' configuration, which ``/config`` masks
SHELL_TOKEN = "2l-token-not-for-display"
SHELL_CHILD_TIMEOUT_S = 300.0
SHELL_PERSIST_S = 120.0
#: the report's stalled total against the loaders' own wait: the
#: report prints milliseconds, each sample is counted in whole us
SHELL_STALL_TOL_S = 0.002
_UNITS = {"B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
          "TB": 1 << 40, "PB": 1 << 50}


def shell_cluster_conf(job_port: int) -> dict:
    """The keys 2l needs of the process cluster's roles: the job master's
    port (where a launched master attaches its persistence scheduler and
    replication checker, once a job master serves there), the host's name
    as the workers' locality (the load plan pairs a job worker, named by
    the host, with a block worker), the master's web server (its
    ``/config``) and a login token (masked there)."""
    import socket

    return {"atpu.job.master.rpc.port": str(job_port),
            "atpu.locality.identity": f"host={socket.gethostname()}",
            "atpu.master.web.enabled": "true",
            "atpu.security.login.token": SHELL_TOKEN}


def wrap32(v: int) -> int:
    return ((int(v) + (1 << 31)) % (1 << 32)) - (1 << 31)


def shell_corpus(directory: str, n: int, block_bytes: int) -> dict:
    """``n`` seeded int32 shards of ``block_bytes`` in ``directory``:
    {namespace path: (local file, numpy's int32-wraparound sum)}."""
    os.makedirs(directory, exist_ok=True)
    files = {}
    for i in range(n):
        arr = np.random.default_rng(SEED + 16_000 + i).integers(
            -2**31, 2**31 - 1, size=block_bytes // 4, dtype=np.int32)
        local = os.path.join(directory, f"shard-{i:02d}.bin")
        arr.tofile(local)
        files[f"/shell/shard-{i:02d}.bin"] = (
            local, wrap32(arr.sum(dtype=np.int64)))
    return files


def shell_run(sh: dict, name: str, argv: list, want: int = 0) -> str:
    """One shell step: ``python -m alluxio_tpu_torch.shell.main`` as a
    child against the cluster, timed under ``name``; fails the run unless
    it exits ``want``. Returns its stdout."""
    cmd = [sys.executable, "-m", "alluxio_tpu_torch.shell.main",
           "--master", sh["master"], "--job-master", sh["job_master"],
           "-D", f"atpu.master.fastpath.dir={sh['fastpath_dir']}", *argv]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=SHELL_CHILD_TIMEOUT_S, env=stress_env(),
                          cwd=sh["cwd"])
    sh["steps"][name] = sh["steps"].get(name, 0.0) \
        + time.perf_counter() - t
    if proc.returncode != want:
        fail(f"2l: {' '.join(argv)} exited {proc.returncode} (want "
             f"{want}): {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc.stdout


def human_bytes(text: str) -> "tuple[float, float]":
    """A ``human_size`` string as (bytes, the half unit it was rounded
    to)."""
    m = re.fullmatch(r"([\d.]+)([KMGTP]?B)", text)
    if not m:
        fail(f"2l: {text!r} is not a size")
    unit = _UNITS[m.group(2)]
    return float(m.group(1)) * unit, 0.005 * unit if unit > 1 else 0.0


def worker_used(report: str) -> "tuple[float, float]":
    """The MEM tier's used bytes in ``fsadmin report capacity`` (one
    worker)."""
    rows = re.findall(r"\bMEM\s+(\S+)\s+(\S+)", report)
    if len(rows) != 1:
        fail(f"2l: report capacity shows {len(rows)} MEM rows: {report}")
    return human_bytes(rows[0][1])


def stall_total(report: str) -> float:
    """``fsadmin report stall``'s total wait (0 when it has none)."""
    if "no input-stall samples" in report:
        return 0.0
    m = re.search(r"of ([\d.]+)s total wait", report)
    if not m:
        fail(f"2l: report stall gave no total: {report}")
    return float(m.group(1))


def shell_epoch(name: str, device, fs, files: dict, paths: list) -> dict:
    """One loader epoch (no device tier) over ``paths`` onto ``device``:
    every block on the SHM rung, each block's ``scaled_sum`` held against
    the plain version and against numpy's sum of its file."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    rfs = RungFS(fs)
    loader = DeviceBlockLoader(rfs, list(paths), device=device, prefetch=2,
                               dtype=np.int32)
    sums = {}
    try:
        _sync_device(device)
        t = time.perf_counter()
        for path, block in zip(paths, loader.epoch()):
            x = rk.pad_to_kernel_shape(block)
            got = int(rk.scaled_sum(x, 1))
            want = int(rk.scaled_sum_reference(x, 1))
            if got != want or got != files[path][1]:
                fail(f"2l {name}: {path}'s scaled_sum {got}, plain "
                     f"{want}, numpy {files[path][1]}")
            sums[path] = got
        _sync_device(device)
        epoch_s = time.perf_counter() - t
        wait_s = loader.stall_report()["total_wait_s"]
    finally:
        loader.close()
    if list(sums) != list(paths):
        fail(f"2l {name}: the epoch gave {len(sums)} of {len(paths)} "
             f"blocks")
    rfs.check_rungs(f"2l {name}", "shm")
    return {"sums": sums, "s": epoch_s, "wait_s": wait_s,
            "chain": wrap32(sum(sums.values()))}


def shell_context(cluster, job_port: int, cwd: str) -> dict:
    return {"master": cluster.master_addresses,
            "job_master": f"localhost:{job_port}",
            "fastpath_dir": cluster.base, "cwd": cwd, "steps": {}}


def shell_client(cluster):
    """The loaders' client: the cluster's, shipping its metrics to the
    master every ``SHELL_METRICS_HEARTBEAT``."""
    from alluxio_tpu_torch.conf import Configuration, Keys

    conf = Configuration(load_env=False)
    conf.set(Keys.USER_METRICS_COLLECTION_ENABLED, True)
    conf.set(Keys.USER_METRICS_HEARTBEAT_INTERVAL, SHELL_METRICS_HEARTBEAT)
    return cluster.file_system(conf)


def start_job_roles(cluster, job_port: int) -> list:
    """A job master at ``job_port`` and a job worker, each a process of
    its own with the cluster's environment, both registered."""
    from alluxio_tpu_torch.minicluster.multi_process import ManagedProcess
    from alluxio_tpu_torch.rpc.job_service import JobMasterClient

    env = {**cluster._common_env(),
           "ATPU_MASTER_RPC_ADDRESSES": cluster.master_addresses,
           "ATPU_JOB_MASTER_HOSTNAME": "localhost",
           "ATPU_JOB_MASTER_RPC_PORT": str(job_port),
           "ATPU_JOB_WORKER_HEARTBEAT_INTERVAL": "100ms"}
    logs = os.path.join(cluster.base, "logs")
    roles = [ManagedProcess(role, env, os.path.join(logs, f"2l-{role}.out"))
             for role in ("job-master", "job-worker")]
    for role in roles:
        role.start()
    jc = JobMasterClient(f"localhost:{job_port}", retry_duration_s=1.0)
    deadline = time.monotonic() + MP_BOOT_S
    while True:
        try:
            if jc.list_workers():
                return roles
        except Exception:  # noqa: BLE001 - not serving yet
            pass
        if time.monotonic() > deadline:
            stop_job_roles(roles)
            fail("2l: the job master and worker did not come up")
        time.sleep(0.2)


def stop_job_roles(roles: list) -> None:
    for role in reversed(roles):
        role.stop()
    alive = [r.proc.pid for r in roles if r.alive]
    if alive:
        fail(f"2l: job role processes {alive} outlived their stop")


def shell_drill(device, sh: dict, fs, files: dict, corpus_dir: str,
                block_bytes: int) -> dict:
    """2l (a)-(c): the corpus in through the shell, persisted, epoch 1,
    freed, loaded back by the job service, epoch 2."""
    n, paths = len(files), list(files)
    # (a) the corpus in, checked and persisted
    shell_run(sh, "copyFromLocal", ["fs", "copyFromLocal", corpus_dir,
                                    "/shell"])
    t_written = time.perf_counter()
    copy_s = sh["steps"]["copyFromLocal"]
    persisted_s = None
    deadline = time.monotonic() + SHELL_PERSIST_S
    while persisted_s is None:
        states = {p: fs.get_status(p).persistence_state for p in paths}
        if set(states.values()) == {"PERSISTED"}:
            persisted_s = time.perf_counter() - t_written
        elif time.monotonic() > deadline:
            fail(f"2l (a): not every file PERSISTED in {SHELL_PERSIST_S} "
                 f"s: {states}")
        else:
            time.sleep(0.1)
    listing_rows = [line.split() for line in shell_run(
        sh, "ls", ["fs", "ls", "/shell"]).splitlines() if "/shell/" in line]
    if sorted(r[-1] for r in listing_rows) != paths or \
            {r[4] for r in listing_rows} != {"PERSISTED"}:
        fail(f"2l (a): fs ls shows {listing_rows}")
    stat = shell_run(sh, "stat", ["fs", "stat", paths[-1]])
    if "persistence_state: PERSISTED" not in stat:
        fail(f"2l (a): fs stat {paths[-1]}: {stat}")
    du = shell_run(sh, "du", ["fs", "du", "-s", "/shell"]).split()
    if du != [str(n * block_bytes), "/shell"]:
        fail(f"2l (a): fs du -s /shell shows {du}")
    import hashlib

    sums_md5 = dict(re.findall(r"md5sum of (\S+): ([0-9a-f]{32})",
                               shell_run(sh, "checksum",
                                         ["fs", "checksum", *paths])))
    for path, (local, _) in files.items():
        with open(local, "rb") as f:
            want = hashlib.md5(f.read()).hexdigest()
        if sums_md5.get(path) != want:
            fail(f"2l (a): fs checksum {path} {sums_md5.get(path)}, the "
                 f"local file's md5 {want}")
    # (b) epoch 1
    epoch1 = shell_epoch("(b) epoch 1", device, fs, files, paths)
    if epoch1["chain"] != wrap32(sum(v for _, v in files.values())):
        fail(f"2l (b): the chain {epoch1['chain']} is not numpy's")
    # (c) freed, then loaded back by the job service
    used0, tol0 = worker_used(shell_run(
        sh, "report capacity", ["fsadmin", "report", "capacity"]))
    shell_run(sh, "free", ["fs", "free", "/shell"])
    deadline = time.monotonic() + SHELL_PERSIST_S
    while any(fs.get_status(p).in_memory_percentage for p in paths):
        if time.monotonic() > deadline:
            fail("2l (c): the freed blocks stayed on the worker")
        time.sleep(0.1)
    used1, tol1 = worker_used(shell_run(
        sh, "report capacity", ["fsadmin", "report", "capacity"]))
    if used0 - used1 < n * block_bytes - tol0 - tol1:
        fail(f"2l (c): the worker's used bytes fell {used0 - used1:.0f}, "
             f"want >= {n * block_bytes}")
    load = shell_run(sh, "distributedLoad", ["fs", "distributedLoad",
                                             "/shell"])
    job = re.search(r"Job (\d+) COMPLETED", load)
    if not job:
        fail(f"2l (c): distributedLoad: {load}")
    jobs = shell_run(sh, "job ls", ["job", "ls"])
    if not re.search(rf"^{job.group(1)}\s+load\s+COMPLETED", jobs,
                     re.MULTILINE):
        fail(f"2l (c): job ls does not show load {job.group(1)} "
             f"COMPLETED: {jobs}")
    epoch2 = shell_epoch("(c) epoch 2", device, fs, files, paths)
    if epoch2["sums"] != epoch1["sums"]:
        fail("2l (c): epoch 2's sums are not epoch 1's")
    return {"copy_s": copy_s,
            "copy_gb_per_s": n * block_bytes / copy_s / 1e9,
            "persisted_s": persisted_s,
            "free_s": sh["steps"]["free"],
            "used_drop_bytes": used0 - used1,
            "distributed_load_s": sh["steps"]["distributedLoad"],
            "epoch1": epoch1, "epoch2": epoch2}


def wait_heartbeat() -> None:
    time.sleep(3 * float(SHELL_METRICS_HEARTBEAT.rstrip("ms")) / 1e3)


def shell_phase(device, mp: dict, workdir: str) -> dict:
    """(2l): the operator's shells as child processes against 2g's cluster
    (which carries ``shell_cluster_conf``), with a job master and a job
    worker of their own, around two epochs of the H100 loader over the
    corpus they wrote. No job role outlives the phase."""
    import urllib.request

    from alluxio_tpu_torch.conf.property_key import REGISTRY, Template
    from alluxio_tpu_torch.utils.tracing import set_tracing_enabled

    from alluxio_tpu_torch.conf import Keys

    print(f"2l: cut the client metrics heartbeat {SHELL_METRICS_HEARTBEAT}"
          f" (the default {Keys.USER_METRICS_HEARTBEAT_INTERVAL.default})",
          flush=True)
    t_phase = time.perf_counter()
    cluster = mp["cluster"]
    corpus_dir = os.path.join(workdir, "shell-corpus")
    files = shell_corpus(corpus_dir, SHELL_SHARDS, BLOCK_BYTES)
    sh = shell_context(cluster, mp["job_port"], workdir)
    roles = start_job_roles(cluster, mp["job_port"])
    fs = shell_client(cluster)
    try:
        wait_heartbeat()
        stall0 = stall_total(shell_run(sh, "report stall",
                                       ["fsadmin", "report", "stall"]))
        drill = shell_drill(device, sh, fs, files, corpus_dir, BLOCK_BYTES)
        # (d) the loaders' reports
        wait_heartbeat()
        stall_out = shell_run(sh, "report stall",
                              ["fsadmin", "report", "stall"])
        stall_s = stall_total(stall_out) - stall0
        loader_s = drill["epoch1"]["wait_s"] + drill["epoch2"]["wait_s"]
        if abs(stall_s - loader_s) > SHELL_STALL_TOL_S or \
                "Verdict: top bottleneck" not in stall_out:
            fail(f"2l (d): the stall report's wait {stall_s:.6f} s, the "
                 f"loaders' {loader_s:.6f} s: {stall_out}")
        shell_run(sh, "trace", ["fsadmin", "trace", "--on"])
        set_tracing_enabled(True)
        try:
            traced = shell_epoch("(d) traced epoch", device, fs, files,
                                 list(files)[:SHELL_TRACE_BLOCKS])
            wait_heartbeat()
        finally:
            set_tracing_enabled(False)
        readpath = shell_run(sh, "report readpath",
                             ["fsadmin", "report", "readpath"])
        shell_run(sh, "trace", ["fsadmin", "trace", "--off"])
        analyzed = re.search(r"\((\d+) traces analyzed\)", readpath)
        if not analyzed or int(analyzed.group(1)) < 1:
            fail(f"2l (d): report readpath analyzed no trace: {readpath}")
        shell_run(sh, "report summary", ["fsadmin", "report", "summary"])
        shell_run(sh, "doctor", ["fsadmin", "doctor"])
        shell_run(sh, "getConf", ["fsadmin", "getConf"])
        # (e) the remaining tools
        site = os.path.join(workdir, "shell-site.properties")
        with open(site, "w") as f:
            for key, value in cluster._extra.items():
                f.write(f"{key}={value}\n")
        shell_run(sh, "validateConf", ["validateConf", "--site", site])
        op, count, threads = SHELL_RUNOP
        runop = shell_run(sh, "runOperation", [
            "runOperation", "-op", op, "-n", str(count), "-t", str(threads),
            "-d", "/shell-runop"])
        rate = re.search(rf"{op}: {count}/{count} ok in [\d.]+s "
                         rf"\(([\d.]+) op/s\)", runop)
        if not rate:
            fail(f"2l (e): runOperation: {runop}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{cluster.master_web_ports[0]}"
                f"/api/v1/master/config", timeout=30) as r:
            config = json.loads(r.read())["config"]
        named = {k for k in REGISTRY.all_keys() if Template.match(k) is None}
        if not named <= set(config) or \
                config["atpu.security.login.token"]["value"] != "******" \
                or SHELL_TOKEN in json.dumps(config):
            fail(f"2l (e): /config lacks {sorted(named - set(config))[:5]} "
                 f"or shows the token")
    finally:
        fs.close()
        stop_job_roles(roles)
        shutil.rmtree(corpus_dir, ignore_errors=True)
    out = {"steps_s": sh["steps"], "copy_s": drill["copy_s"],
           "copy_gb_per_s": drill["copy_gb_per_s"],
           "persisted_s": drill["persisted_s"], "free_s": drill["free_s"],
           "used_drop_bytes": drill["used_drop_bytes"],
           "distributed_load_s": drill["distributed_load_s"],
           "epoch1_s": drill["epoch1"]["s"], "epoch2_s": drill["epoch2"]["s"],
           "traced_epoch_s": traced["s"],
           "stall_report_s": stall_s, "loader_wait_s": loader_s,
           "traces_analyzed": int(analyzed.group(1)),
           "runop_ops_per_s": float(rate.group(1)),
           "config_keys": len(config), "s": time.perf_counter() - t_phase}
    print(f"2l: copyFromLocal {SHELL_SHARDS} x {BLOCK_BYTES >> 20} MiB in "
          f"{out['copy_s']:.3f} s ({out['copy_gb_per_s']:.3f} GB/s), every "
          f"file PERSISTED {out['persisted_s']:.3f} s after; epoch 1 "
          f"{out['epoch1_s']:.3f} s, free {out['free_s']:.3f} s (used "
          f"-{out['used_drop_bytes'] / 2**20:.1f} MiB), distributedLoad "
          f"{out['distributed_load_s']:.3f} s, epoch 2 {out['epoch2_s']:.3f}"
          f" s; report stall {stall_s:.6f} s against the loaders' "
          f"{loader_s:.6f} s; {out['traces_analyzed']} traces analyzed; "
          f"runOperation {out['runop_ops_per_s']} op/s; /config "
          f"{len(config)} keys; 2l {out['s']:.1f} s", flush=True)
    print("2l steps (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sh["steps"].items()), flush=True)
    return out


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
    elif bench == "qos-two-tenant":
        # the victim's degradation is the gate; an inert limiter or an
        # unbounded bucket map is a fault
        ok = m.get("admission_shed", 0) > 0 and \
            m.get("admission_buckets_tracked", 0) <= \
            m.get("admission_buckets_cap", 0) and \
            m.get("victim_degradation_qos_x", 0.0) > \
            p["max_degradation_x"]
        return (f"victim_degradation_qos_x "
                f"{m.get('victim_degradation_qos_x')} over the "
                f"{p['max_degradation_x']}x gate") if ok else None
    elif bench == "ha-failover":
        # the MTTR budget alone is the gate: a lost acknowledged write, a
        # stale standby read or a writer error is a fault
        ok = m.get("mttr_ok") is False and m.get("mttr_s") is not None \
            and m.get("lost_acked") == 0 \
            and m.get("staleness_violations") == 0 and row["errors"] == 1
        return (f"mttr_s {m.get('mttr_s')} over the "
                f"{p.get('mttr_budget_s')} s budget") if ok else None
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


#: 2h d's cuts of the suite's rows (PERF.md section 4), each printed: the
#: script ran past its time on a slow host. The capacity row cannot show
#: its gate at the suite's own size either (HEAP fits 1 000 000 inodes).
#: The two fixture counts (files a thread) set most of their rows' wall:
#: 23-47 s each on the card's host for 2 s of measurement
SUITE_CUTS = {
    "metadata-lsm-capacity": {"--inodes": "100000"},
    "master-ListStatus-large": {"--duration": "2", "--fixed-count": "2000"},
    "master-DeleteFile": {"--duration": "2", "--fixed-count": "500"},
}
#: 2h d's rows that another phase of this script already ran with the
#: same bench and options (PERF.md section 4): suite row -> (the phase,
#: its row). 2h d does not run them again; it takes their lines, and the
#: report renders them with the rest
SUITE_TAKEN = {
    "worker-sequential": ("2h a", "worker-sequential"),
    "worker-random-4k": ("2h a", "worker-random"),
    "master-CreateFile": ("2h a", "master-CreateFile"),
    "master-GetStatus": ("2h a", "master-GetStatus"),
    "master-ListStatus": ("2h a", "master-ListStatus"),
    "ha-failover": ("2k (f)", "ha"),
}
#: 2h d's cut of the suite's pause between two rows (its 4 s let a row's
#: teardown drain on a one-core host; the card's host has eight cores):
#: 30 gaps of 4 s were 120 s of PR 15's 422.6 s suite
SUITE_GAP_S = 1.0
#: ``stress suite`` over the rows given as JSON in its first argument,
#: with the pause between rows its second; each row's child, and the
#: ``os.sync`` before it, timed on stderr (``[suite-wall] <what> <s>``)
SUITE_CHILD = (
    "import json, os, subprocess, sys, time\n"
    "import alluxio_tpu_torch.stress.__main__ as cli\n"
    "cli.SUITE = tuple((n, a) for n, a in json.loads(sys.argv[1]))\n"
    "cli.SUITE_GAP_S = float(sys.argv[2])\n"
    "def timed(what, fn):\n"
    "    def call(*a, **kw):\n"
    "        t = time.perf_counter()\n"
    "        try:\n"
    "            return fn(*a, **kw)\n"
    "        finally:\n"
    "            print(f'[suite-wall] {what(a)} '\n"
    "                  f'{time.perf_counter() - t:.3f}', file=sys.stderr,\n"
    "                  flush=True)\n"
    "    return call\n"
    "subprocess.run = timed(lambda a: 'child', subprocess.run)\n"
    "os.sync = timed(lambda a: 'sync', os.sync)\n"
    "sys.exit(cli.main(['suite']))\n")
#: a ``[suite-wall]`` line of the suite child's stderr
SUITE_WALL = re.compile(r"^\[suite-wall\] (child|sync) ([0-9.]+)$")


def host_load(before: "dict | None" = None) -> dict:
    """This process's threads, resident GiB and CPU seconds, and the
    host's available GiB; with ``before``, the CPU seconds this process
    spent since it (printed: a process that burns CPU while the suite's
    children run slows them)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) << 10
    out = {"threads": len(os.listdir("/proc/self/task")),
           "rss_gib": ru.ru_maxrss / (1 << 20),
           "cpu_s": ru.ru_utime + ru.ru_stime,
           "host_available_gib": avail / (1 << 30),
           "t": time.perf_counter()}
    if before is not None:
        out["cpu_s_since"] = out["cpu_s"] - before["cpu_s"]
        out["wall_s_since"] = out["t"] - before["t"]
        print(f"2h d: this process held {before['threads']} threads (peak "
              f"RSS {before['rss_gib']:.1f} GiB; the host had "
              f"{before['host_available_gib']:.1f} GiB available) and used "
              f"{out['cpu_s_since']:.1f} s of CPU in the "
              f"{out['wall_s_since']:.1f} s the suite ran", flush=True)
    return out


def cut_suite() -> tuple:
    """The CLI's ``SUITE`` with ``SUITE_CUTS`` applied, each cut printed
    beside the row's own value, and the pause between rows; the rows of
    ``SUITE_TAKEN`` are left out, each printed with the phase whose line
    stands in for it."""
    from alluxio_tpu_torch.stress import __main__ as cli
    from alluxio_tpu_torch.stress.__main__ import SUITE

    print(f"2h d: cut the pause between rows {SUITE_GAP_S} s (the suite's "
          f"{cli.SUITE_GAP_S} s)", flush=True)
    rows = []
    for name, argv in SUITE:
        argv = list(argv)
        if name in SUITE_TAKEN:
            where, row = SUITE_TAKEN[name]
            print(f"2h d: take {name} from {where}'s {row} row (not run "
                  f"again; the suite's {' '.join(argv)})", flush=True)
            continue
        for opt, value in SUITE_CUTS.get(name, {}).items():
            i = argv.index(opt) + 1
            print(f"2h d: cut {name} {opt} {value} (the suite's "
                  f"{argv[i]})", flush=True)
            argv[i] = value
        rows.append((name, argv))
    return tuple(rows)


def suite_phase(workdir: str, taken: dict) -> dict:
    """(2d of 2h): ``python -m alluxio_tpu_torch.stress suite`` as a child
    process over the rows no other phase ran, its lines written into
    ``workdir``: it must exit 0, or 1 with every failed row a gate miss
    (``gate_miss``). ``taken`` holds the lines of the ``SUITE_TAKEN``
    rows from the phases that ran them; every row of the CLI's suite,
    in its order, goes into the lines that ``stress report`` renders into
    ``workdir``, and the page must name every row."""
    import html

    from alluxio_tpu_torch.stress.__main__ import SUITE as FULL

    SUITE = cut_suite()
    t_phase = time.perf_counter()
    lines_path = os.path.join(workdir, "stress-suite.jsonl")
    log_path = os.path.join(workdir, "stress-suite.log")
    with open(lines_path, "w") as out, open(log_path, "w") as err:
        proc = subprocess.run([sys.executable, "-c", SUITE_CHILD,
                               json.dumps(SUITE), str(SUITE_GAP_S)],
                              stdout=out,
                              stderr=err, cwd=workdir, env=stress_env(),
                              timeout=SUITE_TIMEOUT_S)
    suite_s = time.perf_counter() - t_phase
    with open(log_path) as f:
        walls = [m.groups() for m in map(SUITE_WALL.match, f) if m]
    child_walls = [float(v) for w, v in walls if w == "child"]
    child_s = sum(child_walls)
    sync_s = sum(float(v) for w, v in walls if w == "sync")
    with open(lines_path) as f:
        rows = [json.loads(line) for line in f if line.startswith("{")]
    if len(rows) != 1 + len(SUITE):
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"2h d: the suite gave {len(rows)} rows, want "
             f"{1 + len(SUITE)} (exit {proc.returncode}): {tail}")
    ran = dict(zip((name for name, _ in SUITE), rows[1:]))
    missing = sorted(set(SUITE_TAKEN) - set(taken))
    if missing:
        fail(f"2h d: no line from another phase for {missing}")
    SUITE = tuple((name, argv) for name, argv in FULL)
    rows = rows[:1] + [ran[name] if name in ran else taken[name]
                       for name, _ in SUITE]
    with open(lines_path, "w") as out:
        out.writelines(json.dumps(row) + "\n" for row in rows)
    failed, misses = [], {}
    for (name, _), row in zip((("host-calibration", None),) + SUITE, rows):
        if row["errors"] == 0:
            continue
        why = gate_miss(row)
        if why is None:
            failed.append((name, row))
        else:
            misses[name] = why
    # the child's exit code speaks for the rows it ran
    child_missed = any(name in ran for name in misses)
    if failed or proc.returncode not in ((1,) if child_missed else (0,)):
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
    print(f"2h d: the suite child's rows took {child_s:.1f} s in their "
          f"own children (wall, boots included) and {sync_s:.1f} s in "
          f"os.sync before them; by row: "
          + ", ".join(f"{name} {v:.1f}" for name, v
                      in zip(ran, child_walls)), flush=True)
    print(f"2h d: stress suite, {len(rows)} rows in {suite_s:.1f} s "
          f"(exit {proc.returncode}), report {len(page)} bytes naming "
          f"every row:", flush=True)
    for (name, _), row in zip((("host-calibration", None),) + SUITE, rows):
        m = row["metrics"]
        shown = {k: v for k, v in m.items()
                 if not isinstance(v, (dict, str))}
        gate = f" GATE MISSED: {misses[name]}" if name in misses else ""
        where = f", from {SUITE_TAKEN[name][0]}" \
            if name in SUITE_TAKEN else ""
        print(f"  {name} ({row['duration_s']:.1f} s, errors "
              f"{row['errors']}{where}){gate}: {json.dumps(shown)}",
              flush=True)
    drill = dict(zip((name for name, _ in SUITE), rows[1:]))[
        "prefetch-fault-drill"]
    detection_wait_s = drill["metrics"]["detection_wait_s"]
    print(f"2h d: prefetch-fault-drill: detection_wait_s "
          f"{detection_wait_s:.3f} s from the kill (the drill waits for "
          f"its load job, then for the master to drop the killed worker), "
          f"the row {drill['duration_s']:.1f} s", flush=True)
    return {"rows": rows, "exit": proc.returncode, "gate_misses": misses,
            "s": suite_s, "child_s": child_s, "sync_s": sync_s,
            "report_bytes": len(page),
            "fault_drill_detection_wait_s": detection_wait_s,
            "taken": {name: where for name, (where, _) in
                      SUITE_TAKEN.items()}}


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


# -- 2j: the master's guards ---------------------------------------------------
#: the cuts of 2j, each printed beside its default; admission runs at the
#: JAX defaults (200 calls/s, a burst of 400, a principal)
GUARD_KEYS = {
    "atpu.master.lost.files.detection.interval": "500ms",
    "atpu.master.lost.worker.detection.interval": "500ms",
    "atpu.master.worker.timeout": "2s",
    "atpu.master.activesync.interval": "500ms",
    "atpu.master.ufs.cleanup.interval": "1s",
    "atpu.master.persistence.temp.ttl": "5s",
    "atpu.master.health.eval.interval": "500ms",
    # a live worker beats eight times within the timeout, so only the
    # stopped one is declared lost
    "atpu.worker.block.heartbeat.interval": "250ms",
}
GUARD_SHARDS = 32        # (a): 16 MUST_CACHE + 16 CACHE_THROUGH, 1 GiB
GUARD_SYNC_FILES = 16    # (b): dropped into the sync point's UFS directory
GUARD_SYNC_DELETED = 4
GUARD_PROBE_HZ = 20      # (c): the victim's get_status probe
GUARD_FLOOD_THREADS = 8
GUARD_FLOOD_PRINCIPAL = "flood-tenant"
GUARD_DEADLINE_S = 60.0
GUARD_ALERT_WAIT_S = 3.0
#: (c)'s flooding tenant: a child process that calls get_status from
#: several threads, under a principal of its own, on the same transport a
#: client on the master's host takes (the fast path), until a stop file
#: appears; it prints its counts as one JSON line
FLOOD_CHILD = r"""
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
from alluxio_tpu_torch.rpc.clients import FsMasterClient
from alluxio_tpu_torch.utils.exceptions import ResourceExhaustedError
address, fast_dir, path, stop, principal = sys.argv[2:7]
threads = int(sys.argv[7])
counts = [[0, 0, 0] for _ in range(threads)]
started = threading.Barrier(threads + 1)
def flood(i):
    c = FsMasterClient(address, metadata=(("atpu-user", principal),),
                       retry_duration_s=0.0, fastpath_dir=fast_dir)
    c.exists("/")
    started.wait()
    while not os.path.exists(stop):
        try:
            c.get_status(path)
            counts[i][0] += 1
        except ResourceExhaustedError:
            counts[i][1] += 1
        except Exception:
            counts[i][2] += 1
    transport[i] = c.transport
transport = [None] * threads
ts = [threading.Thread(target=flood, args=(i,)) for i in range(threads)]
for t in ts:
    t.start()
started.wait()
print("ready", flush=True)
t0 = time.perf_counter()
for t in ts:
    t.join()
print(json.dumps({"admitted": sum(c[0] for c in counts),
                  "shed": sum(c[1] for c in counts),
                  "errors": sum(c[2] for c in counts),
                  "s": time.perf_counter() - t0,
                  "transports": sorted(set(transport))}), flush=True)
"""


def start_guard_cluster(base: str, block_bytes: int, tier: int):
    """A ``MultiProcessCluster`` (its master and one worker, each a
    process) with admission on and 2j's cuts, blocks of ``block_bytes``
    and a MEM tier of ``tier`` bytes; each cut is printed with its
    default."""
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.conf.property_key import REGISTRY
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )

    for key, value in GUARD_KEYS.items():
        print(f"2j: cut {key} = {value} (default "
              f"{REGISTRY.get(key).default})", flush=True)
    extra = {Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(block_bytes),
             Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
             Keys.MASTER_RPC_ADMISSION_ENABLED.name: "true",
             **GUARD_KEYS}
    cluster = MultiProcessCluster(os.path.join(base, "cluster"),
                                  num_workers=1, extra_conf=extra)
    cluster.start(timeout_s=MP_BOOT_S)
    return cluster


def _sync_device(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()


def guard_epoch(device, fs, paths: list) -> dict:
    """One loader epoch (no device tier: every block crosses from the
    worker) onto ``device``: each block's ``scaled_sum`` held against
    ``scaled_sum_reference`` of the same block. Returns the sums by path,
    the epoch's seconds and the consumer's wait."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    loader = DeviceBlockLoader(fs, paths, device=device, prefetch=2,
                               dtype=np.int32)
    sums = []
    try:
        wait0 = loader.stall_report()["total_wait_s"]
        _sync_device(device)
        t = time.perf_counter()
        for path, block in zip(paths, loader.epoch()):
            # a no-op view at the main path's block size; zeros (neutral
            # to the sum) pad a smaller block to the kernel's multiple
            x = rk.pad_to_kernel_shape(block)
            got = int(rk.scaled_sum(x, 1))
            want = int(rk.scaled_sum_reference(x, 1))
            if got != want:
                fail(f"2j: {path}'s scaled_sum {got} != plain {want}")
            sums.append(got)
        _sync_device(device)
        epoch_s = time.perf_counter() - t
        wait_s = loader.stall_report()["total_wait_s"] - wait0
    finally:
        loader.close()
    if len(sums) != len(paths):
        fail(f"2j: the epoch gave {len(sums)} blocks for {len(paths)} "
             f"files")
    return {"sums": dict(zip(paths, sums)), "s": epoch_s, "wait_s": wait_s}


def _states(fsc, directory: str) -> dict:
    return {i.path: i.persistence_state
            for i in fsc.list_status(directory)}


def lost_file_drill(device, cluster, files: dict, must: list,
                    through: list) -> dict:
    """(2j a) ``must`` written MUST_CACHE and ``through`` CACHE_THROUGH
    from their block files; one epoch onto ``device``; the worker's
    process stopped (``SIGSTOP``) until the master has marked exactly the
    MUST_CACHE files ``LOST``, then resumed (``SIGCONT``) until it has
    re-registered and every file is back; a second epoch must give each
    block the first epoch's sum."""
    import signal

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.rpc.clients import BlockMasterClient

    fs = cluster.file_system()
    fsc = cluster.fs_client()
    bmc = BlockMasterClient(cluster.master_addresses)
    directory = os.path.dirname(must[0])
    paths = must + through
    t = time.perf_counter()
    for path in paths:
        fs.write_all(path, np.fromfile(files[path], dtype=np.uint8),
                     write_type=WriteType.MUST_CACHE if path in must
                     else WriteType.CACHE_THROUGH)
    write_s = time.perf_counter() - t
    states = _states(fsc, directory)
    want = {p: "NOT_PERSISTED" if p in must else "PERSISTED" for p in paths}
    if states != want:
        fail(f"2j (a): written states {states}")
    first = guard_epoch(device, fs, paths)
    fs.close()
    worker = cluster.workers[0]
    worker.kill(signal.SIGSTOP)
    t_stop = time.perf_counter()
    lost_worker_s = None
    try:
        while True:
            states = _states(fsc, directory)
            if lost_worker_s is None and not bmc.get_worker_infos():
                lost_worker_s = time.perf_counter() - t_stop
            lost = sorted(p for p, s in states.items() if s == "LOST")
            if any(states[p] != "PERSISTED" for p in through):
                fail(f"2j (a): a persisted file left PERSISTED: {states}")
            if lost == sorted(must):
                break
            if time.perf_counter() - t_stop > GUARD_DEADLINE_S:
                fail(f"2j (a): {len(lost)} of {len(must)} files LOST "
                     f"{GUARD_DEADLINE_S} s after the worker stopped")
            time.sleep(0.05)
        lost_s = time.perf_counter() - t_stop
    finally:
        worker.kill(signal.SIGCONT)
    t_cont = time.perf_counter()
    registered_s = None
    while True:
        if registered_s is None and bmc.get_worker_infos():
            registered_s = time.perf_counter() - t_cont
        states = _states(fsc, directory)
        if registered_s is not None and states == want:
            break
        if time.perf_counter() - t_cont > GUARD_DEADLINE_S:
            fail(f"2j (a): not recovered {GUARD_DEADLINE_S} s after the "
                 f"worker resumed: {states}")
        time.sleep(0.05)
    recovered_s = time.perf_counter() - t_cont
    fs = cluster.file_system()
    try:
        second = guard_epoch(device, fs, paths)
    finally:
        fs.close()
    if second["sums"] != first["sums"]:
        fail("2j (a): the second epoch's sums differ from the first's")
    return {"files": len(paths), "must_cache": len(must),
            "cache_through": len(through), "write_s": write_s,
            "epoch1_s": first["s"], "epoch2_s": second["s"],
            "lost_worker_s": lost_worker_s, "lost_s": lost_s,
            "registered_s": registered_s, "recovered_s": recovered_s,
            "sums": first["sums"]}


def _log_lines(path: str, needle: str) -> int:
    with open(path, "rb") as f:
        return sum(needle.encode() in line for line in f)


def sync_drill(device, cluster, base: str, block_bytes: int,
               n_files: int, n_deleted: int) -> dict:
    """(2j b) a persisted ``/sync`` directory made a sync point; seeded
    files dropped into its UFS directory from outside the cluster (each
    written beside it and moved in with ``os.replace``) must appear in the
    listing at their lengths, read cold through the worker onto
    ``device`` with each block's ``scaled_sum`` equal to the plain
    version's over the file's bytes; deleted ones must leave it."""
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    fsc = cluster.fs_client()
    root = fsc.get_mount_points()[0].ufs_uri
    ufs_dir = os.path.join(root, "sync")
    os.makedirs(ufs_dir)
    info = fsc.get_status("/sync", sync_interval_ms=0)
    if not (info.folder and info.persisted):
        fail(f"2j (b): /sync is not a persisted directory: {info}")
    fsc.start_sync("/sync")
    if fsc.get_sync_path_list() != ["/sync"]:
        fail(f"2j (b): sync points {fsc.get_sync_path_list()}")
    # a directory's first listing loads its UFS children once; list it
    # before the drop, so that only the sync point's ticks can show the
    # dropped files
    if fsc.list_status("/sync"):
        fail("2j (b): /sync is not empty before the drop")
    staging = os.path.join(base, "staging")
    os.makedirs(staging)
    rng = np.random.default_rng(SEED + 14)
    datas = {}
    for i in range(n_files):
        name = f"drop-{i:02d}.bin"
        data = rng.integers(-2**31, 2**31 - 1, size=block_bytes // 4,
                            dtype=np.int32)
        data.tofile(os.path.join(staging, name))
        datas[f"/sync/{name}"] = data
    for path in datas:
        name = os.path.basename(path)
        os.replace(os.path.join(staging, name), os.path.join(ufs_dir, name))
    t_drop = time.perf_counter()
    want = sorted((os.path.basename(p), block_bytes) for p in datas)
    while sorted((i.name, i.length)
                 for i in fsc.list_status("/sync")) != want:
        if time.perf_counter() - t_drop > GUARD_DEADLINE_S:
            fail(f"2j (b): the sync point lists "
                 f"{[i.name for i in fsc.list_status('/sync')]}")
        time.sleep(0.02)
    visible_s = time.perf_counter() - t_drop
    fs = cluster.file_system()
    try:
        epoch = guard_epoch(device, fs, sorted(datas))
    finally:
        fs.close()
    for path, got in epoch["sums"].items():
        want_sum = int(rk.scaled_sum_reference(
            torch.from_numpy(datas[path]), 1))
        if got != want_sum:
            fail(f"2j (b): {path}'s block sums {got}, its file's bytes "
                 f"{want_sum}")
    gone = sorted(datas)[:n_deleted]
    for path in gone:
        os.remove(os.path.join(ufs_dir, os.path.basename(path)))
    t_del = time.perf_counter()
    while {i.path for i in fsc.list_status("/sync")} & set(gone):
        if time.perf_counter() - t_del > GUARD_DEADLINE_S:
            fail("2j (b): deleted files still listed")
        time.sleep(0.02)
    deleted_s = time.perf_counter() - t_del
    fsc.stop_sync("/sync")
    points = fsc.get_sync_path_list()
    if points:
        fail(f"2j (b): sync points after stop_sync: {points}")
    return {"files": n_files, "visible_s": visible_s,
            "cold_epoch_s": epoch["s"], "cold_wait_s": epoch["wait_s"],
            "cold_gb_per_s": n_files * block_bytes / epoch["s"] / 1e9,
            "deleted": n_deleted, "deleted_s": deleted_s}


class _Probe:
    """The victim's probe: ``get_status`` at ``GUARD_PROBE_HZ`` on a
    thread of its own, under the victim's principal, with no retry (a
    shed surfaces)."""

    def __init__(self, cluster, path: str) -> None:
        import threading

        from alluxio_tpu_torch.rpc.clients import FsMasterClient
        from alluxio_tpu_torch.utils.exceptions import ResourceExhaustedError

        self._client = FsMasterClient(cluster.master_addresses,
                                      retry_duration_s=0.0,
                                      fastpath_dir=cluster.base)
        self._path = path
        self._shed_error = ResourceExhaustedError
        self.ms, self.shed = [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="smoke-guard-probe")
        self._thread.start()

    def _loop(self) -> None:
        period = 1.0 / GUARD_PROBE_HZ
        while not self._stop.wait(period):
            t = time.perf_counter()
            try:
                self._client.get_status(self._path)
                self.ms.append((time.perf_counter() - t) * 1000.0)
            except self._shed_error:
                self.shed += 1

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(10)
        self._client.close()
        ms = sorted(self.ms)
        return {"calls": len(ms), "shed": self.shed,
                "p50_ms": pct(ms, 50), "p99_ms": pct(ms, 99)}


def admission_drill(device, cluster, paths: list, sums: dict,
                    principal: str) -> dict:
    """(2j c) the victim (the loader's own principal) runs an epoch with
    its probe alone, beside a flooding tenant's child process, and alone
    again; the victim is never shed, the flood is, and every shed call is
    audited or counted as dropped by the audit writer."""
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient

    meta = MetaMasterClient(cluster.master_addresses, retry_duration_s=30.0)
    stop_file = os.path.join(cluster.base, "flood.stop")
    turns, flood, alert, flood_s = [], None, None, 0.0
    for turn in ("alone", "flood", "alone again"):
        child = None
        if turn == "flood":
            child = subprocess.Popen(
                [sys.executable, "-c", FLOOD_CHILD, str(ROOT),
                 cluster.master_addresses, cluster.base, paths[0],
                 stop_file, GUARD_FLOOD_PRINCIPAL,
                 str(GUARD_FLOOD_THREADS)],
                stdout=subprocess.PIPE, text=True)
            if child.stdout.readline().strip() != "ready":
                child.kill()
                fail("2j (c): the flood child did not start")
            t_flood = time.perf_counter()
        try:
            probe = _Probe(cluster, paths[0])
            fs = cluster.file_system()
            try:
                epoch = guard_epoch(device, fs, paths)
            finally:
                fs.close()
                p = probe.stop()
            if child is not None:
                # the rule rates sheds between evaluations at least 1 s
                # apart: its state is read on the health ticks while the
                # flood goes on, up to GUARD_ALERT_WAIT_S into the flood
                while True:
                    health = meta.get_health(evaluate=False)
                    alert = next(
                        ([kind, a["subject"]]
                         for kind in ("alerts", "pending")
                         for a in health[kind]
                         if a["rule"] == "tenant-over-share"), None)
                    flood_s = time.perf_counter() - t_flood
                    if alert or flood_s > GUARD_ALERT_WAIT_S:
                        break
                    time.sleep(0.1)
        finally:
            if child is not None:
                with open(stop_file, "w"):
                    pass
                out, _ = child.communicate(timeout=60)
                flood = json.loads(out.strip().splitlines()[-1])
        if epoch["sums"] != sums:
            fail(f"2j (c): the {turn} epoch's sums differ from (a)'s")
        turns.append({"turn": turn, "epoch_s": epoch["s"],
                      "wait_s": epoch["wait_s"], "probe": p})
        print(f"2j (c): victim {turn}: epoch {epoch['s']:.3f} s, the "
              f"consumer waits {epoch['wait_s']:.3f} s, probe "
              f"{p['calls']} calls p50 {p['p50_ms']:.3f} ms p99 "
              f"{p['p99_ms']:.3f} ms, {p['shed']} shed", flush=True)
    qos = meta.get_qos()["admission"]
    shed_by = {r["principal"]: r["shed"] for r in qos["principals"]}
    admitted_by = {r["principal"]: r["admitted"] for r in qos["principals"]}
    shed = qos["shed_total"]
    if shed_by.get(principal, 0) or any(t["probe"]["shed"] for t in turns):
        fail(f"2j (c): the victim {principal!r} was shed: {shed_by}")
    if not shed_by.get(GUARD_FLOOD_PRINCIPAL) or not flood["shed"]:
        fail(f"2j (c): the flood was never shed: {shed_by}, {flood}")
    # the writer drains after the flood: every shed call is audited with
    # allowed=false or counted among its dropped denials
    log = os.path.join(cluster.base, "logs", "master0.out")
    deadline = time.monotonic() + GUARD_DEADLINE_S
    while True:
        audited = _log_lines(log, "allowed=false")
        m = meta.get_metrics()
        dropped = int(m.get("Master.AuditLogDropped", 0))
        dropped_denied = int(m.get("Master.AuditLogDroppedDenied", 0))
        if audited + dropped_denied == shed:
            break
        if time.monotonic() > deadline:
            fail(f"2j (c): {audited} audited + {dropped_denied} dropped "
                 f"denials != {shed} shed")
        time.sleep(0.2)
    print(f"2j (c): the flood ({GUARD_FLOOD_THREADS} threads over "
          f"{flood['transports']}) made {flood['admitted']} admitted and "
          f"{flood['shed']} shed calls ({flood['errors']} errors) in "
          f"{flood['s']:.2f} s; shed by principal {shed_by}, admitted "
          f"{admitted_by}; audit: {audited} lines allowed=false + "
          f"{dropped_denied} dropped denials = {shed} shed (the writer "
          f"dropped {dropped} entries in all); tenant-over-share "
          f"{alert[0] + ' for ' + alert[1] if alert else 'not raised'} "
          f"{flood_s:.2f} s into the flood", flush=True)
    return {"turns": turns, "flood": flood, "shed_by_principal": shed_by,
            "admitted_by_principal": admitted_by, "shed_total": shed,
            "audited": audited, "audit_dropped": dropped,
            "audit_dropped_denied": dropped_denied,
            "tenant_alert": alert, "tenant_alert_read_s": flood_s}


def sweep_drill(cluster) -> dict:
    """(2j d) an aged persist temp and a fresh one planted in the root
    UFS: the aged one must go within two cleanup ticks, the fresh one
    must stay."""
    from alluxio_tpu_torch.conf import Configuration

    keys = Configuration(GUARD_KEYS, load_env=False)
    tick = keys.get_duration_s("atpu.master.ufs.cleanup.interval")
    ttl = keys.get_duration_s("atpu.master.persistence.temp.ttl")
    root = cluster.fs_client().get_mount_points()[0].ufs_uri
    aged = os.path.join(root, ".atpu_persist.aged.0000aaaa")
    fresh = os.path.join(root, ".atpu_persist.fresh.0000ffff")
    log = os.path.join(cluster.base, "logs", "master0.out")
    needle = "UfsCleaner removed abandoned persist temp"
    removed0 = _log_lines(log, needle)
    for path in (aged, fresh):
        with open(path, "wb") as f:
            f.write(b"temp")
    old = time.time() - 10 * ttl
    os.utime(aged, (old, old))
    t = time.perf_counter()
    while os.path.exists(aged):
        if time.perf_counter() - t > 2 * tick + 0.5:
            fail(f"2j (d): the aged temp outlived two {tick} s cleanup "
                 f"ticks")
        time.sleep(0.01)
    gone_s = time.perf_counter() - t
    time.sleep(tick + 0.2)  # one more tick: the fresh temp stays
    if not os.path.exists(fresh):
        fail("2j (d): the cleaner removed a fresh temp")
    removed = _log_lines(log, needle) - removed0
    print(f"2j (d): the aged temp went {gone_s:.3f} s after it was "
          f"planted (ticks of {tick} s, TTL {ttl} s), the fresh one "
          f"stayed; the cleaner logged {removed} removal(s)", flush=True)
    return {"aged_gone_s": gone_s, "fresh_kept": True, "removed": removed,
            "tick_s": tick, "ttl_s": ttl}


def guards_phase(device, main: dict) -> dict:
    """(2j) the master's guards on a process cluster of its own, against
    the card's loader: a lost file and its recovery, active sync, RPC
    admission and audit under a flood, and the UFS temp sweep."""
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.security.user import get_os_user

    t_phase = time.perf_counter()
    paths = list(main["files"])[:GUARD_SHARDS]
    half = GUARD_SHARDS // 2
    files = {f"/guards/{'m' if i < half else 't'}-{i:02d}":
             main["files"][p][1] for i, p in enumerate(paths)}
    names = list(files)
    tier = (GUARD_SHARDS + GUARD_SYNC_FILES) * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + (GUARD_SHARDS + GUARD_SYNC_FILES)
                     * BLOCK_BYTES)
    print(f"2j: admission on at the defaults (rate 200/s, burst 400 a "
          f"principal); a MultiProcessCluster under {base}", flush=True)
    rk.launches = 0
    cluster = start_guard_cluster(base, BLOCK_BYTES, tier)
    try:
        lost = lost_file_drill(device, cluster, files, names[:half],
                               names[half:])
        print(f"2j (a): {half} MUST_CACHE + {half} CACHE_THROUGH x "
              f"{BLOCK_BYTES >> 20} MiB written in {lost['write_s']:.2f} "
              f"s, epoch 1 {lost['epoch1_s']:.3f} s; the worker stopped: "
              f"dropped by the master {lost['lost_worker_s']:.3f} s later, "
              f"exactly the {half} MUST_CACHE files LOST "
              f"{lost['lost_s']:.3f} s later, none of the persisted; "
              f"resumed: re-registered {lost['registered_s']:.3f} s, every "
              f"file back {lost['recovered_s']:.3f} s later; epoch 2 "
              f"{lost['epoch2_s']:.3f} s, every block's sum the first "
              f"epoch's", flush=True)
        sync = sync_drill(device, cluster, base, BLOCK_BYTES,
                          GUARD_SYNC_FILES, GUARD_SYNC_DELETED)
        print(f"2j (b): {sync['files']} x {BLOCK_BYTES >> 20} MiB dropped "
              f"into the sync point's UFS directory, all listed "
              f"{sync['visible_s']:.3f} s after the last; read cold onto "
              f"the card in {sync['cold_epoch_s']:.3f} s "
              f"({sync['cold_gb_per_s']:.2f} GB/s), every block's sum its "
              f"file's; {sync['deleted']} deleted in the UFS left the "
              f"listing {sync['deleted_s']:.3f} s later; stop_sync left "
              f"no sync point", flush=True)
        adm = admission_drill(device, cluster, names, lost["sums"],
                              get_os_user())
        sweep = sweep_drill(cluster)
    finally:
        cluster.stop()
        alive = [p.proc.pid for p in cluster.masters + cluster.workers
                 if p.alive]
        shutil.rmtree(base, ignore_errors=True)
    if alive:
        fail(f"2j: processes {alive} outlived the cluster's stop")
    del lost["sums"]
    out = {"keys": GUARD_KEYS, "block_bytes": BLOCK_BYTES, "lost": lost,
           "sync": sync, "admission": adm, "sweep": sweep,
           "launches": rk.launches, "s": time.perf_counter() - t_phase}
    print(f"2j: {out['s']:.1f} s, scaled_sum launched {rk.launches} "
          f"times", flush=True)
    return out


# -- 2k: master HA --------------------------------------------------------------
#: 2k's cuts, each printed beside its default (PERF.md section 4): at the
#: JAX defaults the health rule would evaluate every 10 s and wait 30 s to
#: fire and 60 s to resolve, and the first scheduled backup would come a
#: day later. The election timeouts (300-600 ms), the Raft heartbeat
#: (100 ms), the standby tail and registry intervals (1 s) stay the JAX
#: defaults
HA_KEYS = {
    "atpu.master.health.eval.interval": "500ms",
    "atpu.master.health.fire.after": "0s",
    "atpu.master.health.resolve.after": "0s",
    "atpu.master.daily.backup.interval": "2s",
}
#: what 2k switches on (none is a cut): the scheduled backup, the masters'
#: web servers (their ``/masters`` route), and the masters' standby reads
#: (the JAX default, named so it shows)
HA_SETTINGS = {
    "atpu.master.daily.backup.enabled": "true",
    "atpu.master.web.enabled": "true",
    "atpu.master.ha.standby.reads.enabled": "true",
}
HA_MASTERS = 3
HA_SHARDS = 32           # (a): 1 GiB CACHE_THROUGH through the primary
HA_KILL_AFTER = 8        # (b): consumed blocks before the primary's SIGKILL
HA_WRITE_HZ = 50         # (b): the writer child's creates a second
HA_READS = 1000          # (c): get_status calls a side
HA_STALE_PROBES = 20     # (c): stamped standby listings against the ledger
HA_DEADLINE_S = 60.0
HA_BENCH_TIMEOUT_S = 180
#: (b)'s writer: a child process that creates small files under a
#: directory at ``HA_WRITE_HZ`` through the failover client (the full
#: master list, the JAX ``ha`` bench's retry settings), every fifth one
#: stamped with the primary's md_version after its ack, until a stop file
#: appears; one line an acknowledged create: path, wall-clock ack time,
#: stamp (or -1)
HA_WRITER_CHILD = r"""
import sys, os, time
sys.path.insert(0, sys.argv[1])
from alluxio_tpu_torch.rpc.clients import FsMasterClient
from alluxio_tpu_torch.utils.exceptions import FileAlreadyExistsError
addresses, directory, stop, out_path, hz = sys.argv[2:7]
period = 1.0 / float(hz)
c = FsMasterClient(addresses, retry_duration_s=60.0, max_sleep_s=0.5,
                   fastpath=False)
c.create_directory(directory, recursive=True, allow_exists=True)
with open(out_path, "w") as out:
    print("ready", flush=True)
    i, t0 = 0, time.monotonic()
    while not os.path.exists(stop):
        path = f"{directory}/w{i:06d}"
        try:
            c.create_directory(path)
        except FileAlreadyExistsError:
            # the create reached the quorum, its reply died with the
            # killed primary, and the client's retry found it on the new
            # leader: the leader acknowledges it (the verification holds
            # it to the same rule as every other)
            print(f"create {path} retried onto the new leader",
                  file=sys.stderr, flush=True)
        t_ack = time.time()
        stamp = -1
        if i % 5 == 0:
            _, v = c.get_status(path, want_version=True)
            stamp = -1 if v is None else int(v)
        out.write(f"{path} {t_ack!r} {stamp}\n")
        out.flush()
        i += 1
        time.sleep(max(0.0, t0 + i * period - time.monotonic()))
"""


class _RungFS:
    """The loader's file system, recording the rung that opened each
    block (``BlockInStream.rung``)."""

    def __init__(self, fs) -> None:
        self._fs = fs
        self.rungs: dict = {}

    def get_status(self, path):
        return self._fs.get_status(path)

    def open_file(self, path, **kw):
        f = self._fs.open_file(path, **kw)
        inner = f.block_stream

        def block_stream(index):
            stream = inner(index)
            self.rungs[path] = getattr(stream, "rung", None)
            return stream

        f.block_stream = block_stream
        return f


def ha_epoch(device, fs, paths: list, on_block=None,
             keep: bool = False) -> dict:
    """One loader epoch (no device tier) onto ``device`` through a fresh
    loader over ``fs``: each block's ``scaled_sum`` held against
    ``scaled_sum_reference``; the consume time and the rung of every
    block; ``on_block(n)`` after the n-th consumed block."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    rfs = _RungFS(fs)
    loader = DeviceBlockLoader(rfs, paths, device=device, prefetch=2,
                               dtype=np.int32)
    sums, times, blocks = [], [], []
    try:
        wait0 = loader.stall_report()["total_wait_s"]
        _sync_device(device)
        t = time.perf_counter()
        for path, block in zip(paths, loader.epoch()):
            x = rk.pad_to_kernel_shape(block)
            got = int(rk.scaled_sum(x, 1))
            want = int(rk.scaled_sum_reference(x, 1))
            if got != want:
                fail(f"2k: {path}'s scaled_sum {got} != plain {want}")
            sums.append(got)
            times.append(time.perf_counter())
            if keep:
                blocks.append(block)
            if on_block is not None:
                on_block(len(sums))
        _sync_device(device)
        epoch_s = time.perf_counter() - t
        wait_s = loader.stall_report()["total_wait_s"] - wait0
    finally:
        loader.close()
    if len(sums) != len(paths):
        fail(f"2k: the epoch gave {len(sums)} blocks for {len(paths)} "
             f"files")
    gaps = [b - a for a, b in zip([t] + times[:-1], times)]
    return {"sums": dict(zip(paths, sums)), "s": epoch_s, "wait_s": wait_s,
            "times": times, "max_gap_s": max(gaps),
            "rungs": [rfs.rungs.get(p) for p in paths], "blocks": blocks}


def start_ha_cluster(base: str, block_bytes: int, tier: int):
    """A ``MultiProcessCluster`` of ``HA_MASTERS`` masters on EMBEDDED
    journals and one worker, each a process, with 2k's cuts and settings;
    returns it and the seconds to its first leader."""
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.conf.property_key import REGISTRY
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )

    for key, value in HA_KEYS.items():
        print(f"2k: cut {key} = {value} (default "
              f"{REGISTRY.get(key).default})", flush=True)
    for key, value in HA_SETTINGS.items():
        print(f"2k: set {key} = {value} (default "
              f"{REGISTRY.get(key).default})", flush=True)
    extra = {Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(block_bytes),
             Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
             Keys.MASTER_BACKUP_DIR.name: os.path.join(base, "backups"),
             **HA_KEYS, **HA_SETTINGS}
    cluster = MultiProcessCluster(
        os.path.join(base, "c"), num_masters=HA_MASTERS, num_workers=1,
        journal_type="EMBEDDED", extra_conf=extra)
    t = time.perf_counter()
    try:
        for i in range(HA_MASTERS):
            cluster.start_master(i)
        cluster.wait_for_primary(MP_BOOT_S)
        leader_s = time.perf_counter() - t
        cluster.start_worker(0)
        cluster.wait_for_workers(1, MP_BOOT_S)
    except BaseException:
        cluster.stop()
        raise
    return cluster, leader_s


def _masters_view(address: str) -> dict:
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient

    return MetaMasterClient(address, fastpath=False,
                            retry_duration_s=0.5).get_masters()


def _own_sequence(address: str) -> "int | None":
    """The applied journal sequence ``address`` reports for itself."""
    try:
        rows = _masters_view(address)["masters"]
    except Exception:  # noqa: BLE001 - not serving yet
        return None
    return next((r.get("sequence") for r in rows
                 if r["address"] == address), None)


def _read_acks(path: str) -> list:
    with open(path) as f:
        rows = [line.split() for line in f if line.count(" ") == 2]
    return [(p, float(t), int(s)) for p, t, s in rows]


def _listing(fsc, directory: str) -> list:
    return sorted(i.path for i in fsc.list_status(directory,
                                                  recursive=True))


class _FailoverWatch:
    """From the primary's kill: the seconds until ``get_masters`` on a
    survivor names a new leader, and until the worker has re-registered
    with it (the leader lists a live worker)."""

    def __init__(self, cluster, dead: int) -> None:
        import threading

        self._cluster = cluster
        self._dead = f"localhost:{cluster.master_ports[dead]}"
        self._survivors = [f"localhost:{p}" for i, p in
                           enumerate(cluster.master_ports) if i != dead]
        self.t_kill = time.perf_counter()
        self.leader = None
        self.leader_s = self.registered_s = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="smoke-ha-watch")
        self._thread.start()

    def _loop(self) -> None:
        from alluxio_tpu_torch.rpc.clients import BlockMasterClient

        while not self._stop.is_set() and self.registered_s is None:
            now = time.perf_counter()
            if now - self.t_kill > HA_DEADLINE_S:
                return
            if self.leader is None:
                for addr in self._survivors:
                    try:
                        leader = _masters_view(addr).get("leader")
                    except Exception:  # noqa: BLE001 - mid-election
                        continue
                    if leader and leader != self._dead:
                        self.leader = leader
                        self.leader_s = time.perf_counter() - self.t_kill
                        break
            else:
                try:
                    infos = BlockMasterClient(
                        self.leader, fastpath=False,
                        retry_duration_s=0.2).get_worker_infos()
                except Exception:  # noqa: BLE001 - not serving yet
                    infos = []
                if infos:
                    self.registered_s = time.perf_counter() - self.t_kill
            time.sleep(0.01)

    def wait(self) -> None:
        self._thread.join(HA_DEADLINE_S + 5)
        if self.leader_s is None or self.registered_s is None:
            fail(f"2k (b): {HA_DEADLINE_S} s after the kill: leader named "
                 f"after {self.leader_s} s, worker re-registered after "
                 f"{self.registered_s} s")


def _quorum_alert(meta) -> "str | None":
    """Where ``master-quorum-degraded`` stands on the leader: firing,
    pending, resolved or None."""
    h = meta.get_health(evaluate=False)
    for kind in ("alerts", "pending", "recently_resolved"):
        if any(a["rule"] == "master-quorum-degraded" for a in h[kind]):
            return kind
    return None


def _await_quorum_alert(meta, want: tuple, what: str) -> float:
    t = time.perf_counter()
    while True:
        state = _quorum_alert(meta)
        if state in want:
            return time.perf_counter() - t
        if time.perf_counter() - t > HA_DEADLINE_S:
            fail(f"2k (d): master-quorum-degraded {state!r} "
                 f"{HA_DEADLINE_S} s after {what}")
        time.sleep(0.2)


def _restore_listing(journal_type: str, folder: str, ufs: str,
                     directory: str, **conf) -> list:
    """A master in this process on ``folder`` (its own port, no fast
    path, no web server), the listing of ``directory`` under it, then
    stopped."""
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.master.process import MasterProcess
    from alluxio_tpu_torch.minicluster.multi_process import free_port
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    c = Configuration(load_env=False)
    c.set(Keys.HOME, folder)
    c.set(Keys.MASTER_JOURNAL_TYPE, journal_type)
    c.set(Keys.MASTER_JOURNAL_FOLDER, folder)
    c.set(Keys.MASTER_RPC_PORT, free_port())
    c.set(Keys.MASTER_FASTPATH_ENABLED, False)
    c.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
    for k, v in conf.items():
        c.set(k, v)
    m = MasterProcess(c, root_ufs_uri=ufs)
    m.start()
    try:
        return _listing(FsMasterClient(m.address, fastpath=False),
                        directory)
    finally:
        m.stop()


def failover_drill(device, cluster, files: dict, kill_after: int,
                   workdir: str, keep: bool = False) -> dict:
    """(2k a-b) ``files`` (namespace path -> block file) written
    CACHE_THROUGH through the primary and one epoch onto ``device``; then
    a fresh client's epoch beside a writer child, the primary SIGKILLed
    after ``kill_after`` consumed blocks; every acknowledged create must
    be on the new leader and epoch 2's sums epoch 1's."""
    import signal

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.minicluster import WriteLedger
    from alluxio_tpu_torch.rpc.clients import FsMasterClient

    paths = list(files)
    primary = cluster.primary_index(MP_BOOT_S)
    fs = cluster.file_system()
    t = time.perf_counter()
    for path in paths:
        fs.write_all(path, np.fromfile(files[path], dtype=np.uint8),
                     write_type=WriteType.CACHE_THROUGH)
    write_s = time.perf_counter() - t
    first = ha_epoch(device, fs, paths, keep=keep)
    fs.close()
    stop_file = os.path.join(workdir, "writer.stop")
    acks_path = os.path.join(workdir, "writer.acks")
    writer = subprocess.Popen(
        [sys.executable, "-c", HA_WRITER_CHILD, str(ROOT),
         cluster.master_addresses, "/ha/acks", stop_file, acks_path,
         str(HA_WRITE_HZ)],
        stdout=subprocess.PIPE, text=True, env=stress_env())
    try:
        if writer.stdout.readline().strip() != "ready":
            fail("2k (b): the writer child did not start")
        watch = []

        def kill_primary(n: int) -> None:
            if n == kill_after:
                watch.append(_FailoverWatch(cluster, primary))
                cluster.masters[primary].kill(signal.SIGKILL)

        fs = cluster.file_system()
        second = ha_epoch(device, fs, paths, on_block=kill_primary)
        fs.close()
        w = watch[0]
        w.wait()
        # the writer's first create acknowledged after the kill
        t_kill_wall = time.time() - (time.perf_counter() - w.t_kill)
        deadline = time.perf_counter() + HA_DEADLINE_S
        while True:
            after = [a for a in _read_acks(acks_path) if a[1] > t_kill_wall]
            if after:
                break
            if time.perf_counter() > deadline or writer.poll() is not None:
                fail(f"2k (b): no create acknowledged after the kill "
                     f"(writer exit {writer.poll()})")
            time.sleep(0.05)
        first_ack_s = after[0][1] - t_kill_wall
        open(stop_file, "w").close()
        writer.wait(timeout=HA_DEADLINE_S)
        if writer.returncode != 0:
            fail(f"2k (b): the writer exited {writer.returncode}")
    finally:
        if writer.poll() is None:
            writer.kill()
            writer.wait(timeout=10)
    acks = _read_acks(acks_path)
    ledger = WriteLedger()
    for path, _t, stamp in acks:
        ledger.record(path, None if stamp < 0 else stamp)
    if second["sums"] != first["sums"]:
        fail("2k (b): epoch 2's sums differ from epoch 1's")
    t_kill, t_reg = w.t_kill, w.t_kill + w.registered_s
    off_shm = [(r, round(c - t_kill, 3)) for r, c in
               zip(second["rungs"], second["times"])
               if t_kill <= c <= t_reg and r != "shm"]
    survivors = [f"localhost:{p}" for i, p in
                 enumerate(cluster.master_ports) if i != primary]
    lost = ledger.verify_durable(FsMasterClient(
        w.leader, fastpath=False, retry_duration_s=HA_DEADLINE_S))
    if lost:
        fail(f"2k (b): {len(lost)} acknowledged creates missing on the "
             f"new leader: {lost[:5]}")
    return {"primary": primary, "write_s": write_s, "first": first,
            "second": second, "watch": w, "first_ack_s": first_ack_s,
            "acks": acks, "ledger": ledger, "off_shm": off_shm,
            "leader": w.leader,
            "standby": next(a for a in survivors if a != w.leader)}


def ha_phase(device, main: dict) -> dict:
    """(2k) master HA on a process cluster of its own, against the card's
    loader: three masters on EMBEDDED journals, the primary killed in the
    middle of an epoch beside a writer, standby reads, the rejoin, a
    scheduled backup restored into a LOCAL master, a journal migration
    round trip, and the CLI's ``ha`` bench."""
    import threading
    import urllib.request

    import torch

    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.journal import migrate
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster.multi_process import free_port
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.clients import (
        FsMasterClient, MetaMasterClient,
    )

    t_phase = time.perf_counter()
    shards = list(main["files"])[:HA_SHARDS]
    files = {f"/ha/s-{i:02d}": main["files"][p][1]
             for i, p in enumerate(shards)}
    paths = list(files)
    tier = 48 * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + HA_SHARDS * BLOCK_BYTES)
    print(f"2k: {HA_MASTERS} masters on EMBEDDED journals, the JAX "
          f"election timeouts (300-600 ms, heartbeat 100 ms); one worker, "
          f"MEM tier {tier >> 20} MiB; a MultiProcessCluster under {base}",
          flush=True)
    rk.launches = 0
    cluster, leader_s = start_ha_cluster(base, BLOCK_BYTES, tier)
    try:
        drill = failover_drill(device, cluster, files, HA_KILL_AFTER, base,
                               keep=True)
        primary, first, second = drill["primary"], drill["first"], \
            drill["second"]
        w, acks, ledger = drill["watch"], drill["acks"], drill["ledger"]
        leader, standby = drill["leader"], drill["standby"]
        x = torch.cat(first.pop("blocks"))
        l0 = rk.launches
        got = int(chain(rk.scaled_sum, x, K))
        chain_launches = rk.launches - l0
        plain = int(chain(rk.scaled_sum_reference, x, K))
        host = torch.cat([torch.from_numpy(np.fromfile(
            files[p], dtype=np.int32)) for p in paths]).to(device)
        want = int(chain(rk.scaled_sum_reference, host, K))
        del x, host
        if chain_launches != K or not got == plain == want:
            fail(f"2k (a): {chain_launches} chain launches (want {K}), "
                 f"kernel chain {got}, plain {plain}, the files' {want}")
        print(f"2k (a): first leader {leader_s:.3f} s after the masters "
              f"started (m{primary}); {HA_SHARDS} x {BLOCK_BYTES >> 20} MiB "
              f"CACHE_THROUGH in {drill['write_s']:.2f} s; epoch 1 "
              f"{first['s']:.3f} s (consumer wait {first['wait_s']:.3f} s, "
              f"rungs {sorted(set(first['rungs']))}); the K={K} chain "
              f"{got} equal to the plain chain and the files'", flush=True)
        print(f"2k (b): m{primary} SIGKILLed after {HA_KILL_AFTER} consumed "
              f"blocks; from the kill: get_masters named {leader} after "
              f"{w.leader_s:.3f} s, the writer's first acknowledged create "
              f"{drill['first_ack_s']:.3f} s, the worker re-registered "
              f"{w.registered_s:.3f} s; the loader's longest gap between "
              f"blocks {second['max_gap_s']:.3f} s (epoch 1 "
              f"{first['max_gap_s']:.3f} s), epoch 2 {second['s']:.3f} s "
              f"against epoch 1 {first['s']:.3f} s; blocks by rung "
              f"{ {r: second['rungs'].count(r) for r in set(second['rungs'])} }; "
              f"{len(drill['off_shm'])} blocks left the SHM rung while the "
              f"new leader knew no locations {drill['off_shm']}; "
              f"{len(acks)} creates acknowledged at {HA_WRITE_HZ}/s, all on "
              f"the new leader", flush=True)

        # (c) standby reads against the two survivors
        reads = metrics().counter("Client.StandbyReads")
        reads0 = reads.count
        routed = FsMasterClient(f"{leader},{standby}", standby_reads=True,
                                fastpath=False)
        strong = FsMasterClient(leader, fastpath=False)
        for c in (routed, strong):
            c.get_status(paths[0])  # warm-up, untimed
        side = {"standby": [], "primary": []}
        for i in range(HA_READS):
            for name, c in (("standby", routed), ("primary", strong)):
                t = time.perf_counter()
                c.get_status(paths[i % len(paths)])
                side[name].append((time.perf_counter() - t) * 1000.0)
        standby_reads = reads.count - reads0
        if standby_reads <= 0:
            fail("2k (c): Client.StandbyReads did not move")
        violations = 0
        for _ in range(HA_STALE_PROBES):
            infos, stamp = routed.list_status("/ha/acks", want_version=True)
            violations += len(ledger.staleness_violations(
                [i.path for i in infos], stamp))
        if violations:
            fail(f"2k (c): {violations} standby listings staler than their "
                 f"md_version")
        lat = {k: {"p50_ms": pct(sorted(v), 50), "p99_ms": pct(sorted(v), 99)}
               for k, v in side.items()}
        print(f"2k (c): {HA_READS} get_status a side over gRPC, alternated: "
              f"standby {standby} p50 {lat['standby']['p50_ms']:.3f} ms p99 "
              f"{lat['standby']['p99_ms']:.3f} ms, primary {leader} p50 "
              f"{lat['primary']['p50_ms']:.3f} ms p99 "
              f"{lat['primary']['p99_ms']:.3f} ms; Client.StandbyReads "
              f"+{standby_reads}; {HA_STALE_PROBES} stamped standby "
              f"listings, no staleness violation", flush=True)

        # (d) the rejoin; the quorum rule fires, then resolves
        meta = MetaMasterClient(leader, fastpath=False)
        fired_s = _await_quorum_alert(meta, ("alerts",), "the kill")
        target = _own_sequence(leader)
        t = time.perf_counter()
        cluster.start_master(primary)
        killed = f"localhost:{cluster.master_ports[primary]}"
        while True:
            seq = _own_sequence(killed)
            if seq is not None and seq >= target:
                break
            if time.perf_counter() - t > HA_DEADLINE_S:
                fail(f"2k (d): the restarted master applied {seq} of "
                     f"{target} within {HA_DEADLINE_S} s")
            time.sleep(0.05)
        t_rejoined = time.perf_counter()
        rejoin_s = t_rejoined - t
        web = cluster.master_web_ports[cluster.master_ports.index(
            int(leader.rsplit(":", 1)[1]))]
        with urllib.request.urlopen(
                f"http://localhost:{web}/api/v1/master/masters",
                timeout=10) as r:
            rows = json.loads(r.read())["masters"]
        print(f"2k (d): master-quorum-degraded firing {fired_s:.3f} s after "
              f"(c); m{primary} restarted and applied the leader's sequence "
              f"{target} in {rejoin_s:.3f} s; /masters rows:", flush=True)
        for row in rows:
            print(f"  {json.dumps(row, sort_keys=True)}", flush=True)
        if sorted(r["address"] for r in rows) != \
                sorted(f"localhost:{p}" for p in cluster.master_ports):
            fail(f"2k (d): /masters rows {rows}")

        # (e) a scheduled backup while the loader runs, restored into a
        # LOCAL master; then the migration round trip on a stopped copy
        backups = os.path.join(base, "backups")
        want_seq = _own_sequence(leader)
        landed = {}

        def await_backup() -> None:
            # copied out at once: the heartbeat's retention prunes the
            # oldest backups every interval
            t0 = time.perf_counter()
            kept = os.path.join(base, "restore.bak")
            while time.perf_counter() - t0 < HA_DEADLINE_S:
                for name in os.listdir(backups):
                    m = re.match(r"^atpu-backup-\d{8}-\d{6}-(\d+)"
                                 r"(?:\.\d+)?\.bak$", name)
                    if not m or int(m.group(1)) < want_seq:
                        continue
                    try:
                        shutil.copyfile(os.path.join(backups, name), kept)
                    except FileNotFoundError:
                        continue
                    landed.update(path=kept, name=name,
                                  s=time.perf_counter() - t0)
                    return
                time.sleep(0.05)

        waiter = threading.Thread(target=await_backup, daemon=True)
        waiter.start()
        fs = cluster.file_system()
        third = ha_epoch(device, fs, paths)
        fs.close()
        waiter.join(HA_DEADLINE_S + 5)
        if "path" not in landed or third["sums"] != first["sums"]:
            fail(f"2k (e): backup {landed}, epoch 3 sums equal "
                 f"{third['sums'] == first['sums']}")
        expect = set(paths) | {p for p, _t, _s in acks}
        live = _listing(FsMasterClient(leader, fastpath=False), "/ha")
        ufs = os.path.join(cluster.base, "underFSStorage")
        restored = _restore_listing(
            "LOCAL", os.path.join(base, "restore"), ufs, "/ha",
            **{Keys.MASTER_JOURNAL_INIT_FROM_BACKUP.name: landed["path"]})
        if not expect <= set(restored) or restored != live:
            fail(f"2k (e): the backup's master lists {len(restored)} paths, "
                 f"the leader {len(live)}, missing "
                 f"{sorted(expect - set(restored))[:5]}")
        _await_quorum_alert(meta, ("recently_resolved",), "the rejoin")
        resolved_s = time.perf_counter() - t_rejoined
    finally:
        cluster.stop()
        alive = [p.proc.pid for p in cluster.masters + cluster.workers
                 if p.alive]
    if alive:
        shutil.rmtree(base, ignore_errors=True)
        fail(f"2k: processes {alive} outlived the cluster's stop")
    try:
        copy = os.path.join(base, "copy")
        shutil.copytree(os.path.join(cluster.base, f"journal-m{primary}"),
                        copy)
        local = os.path.join(base, "migrated-local")
        down = migrate.embedded_to_local(copy, local)
        local_listing = _restore_listing("LOCAL", local, ufs, "/ha")
        raft = os.path.join(base, "migrated-raft")
        addr = f"127.0.0.1:{free_port()}"
        up = migrate.local_to_embedded(local, raft, [addr])
        raft_listing = _restore_listing(
            "EMBEDDED", raft, ufs, "/ha",
            **{Keys.MASTER_EMBEDDED_JOURNAL_ADDRESS.name: addr,
               Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES.name: addr})
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if not local_listing == raft_listing == live:
        fail(f"2k (e): the migrated listings differ ({len(local_listing)} "
             f"LOCAL, {len(raft_listing)} EMBEDDED, {len(live)} live)")
    print(f"2k (e): a scheduled backup covering the writer's creates was "
          f"on disk {landed['s']:.3f} s after epoch 3 started ({third['s']:.3f}"
          f" s, every sum epoch 1's); a LOCAL master "
          f"seeded from it lists all {len(restored)} paths (every shard "
          f"and all {len(acks)} acknowledged creates); "
          f"master-quorum-degraded seen resolved {resolved_s:.3f} s after "
          f"the rejoin; embedded->local ({down['entries']} entries past a "
          f"checkpoint at {down['checkpoint_seq']}) -> embedded "
          f"({up['entries']} entries) on a stopped copy of m{primary}'s "
          f"journal: both masters list the same {len(raft_listing)} paths",
          flush=True)

    # (f) the CLI's ha bench at the JAX defaults
    proc = subprocess.run(STRESS_CLI + ["ha"], capture_output=True,
                          text=True, timeout=HA_BENCH_TIMEOUT_S,
                          env=stress_env())
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("{")]
    if not lines:
        fail(f"2k (f): the ha bench printed no row (exit "
             f"{proc.returncode}): {proc.stderr[-3000:]}")
    bench = json.loads(lines[-1])
    miss = gate_miss(bench)
    if proc.returncode != 0 and miss is None:
        fail(f"2k (f): the ha bench failed: {json.dumps(bench)} "
             f"{proc.stderr[-3000:]}")
    bm = bench["metrics"]
    print(f"2k (f): stress ha ({bench['params']['masters']} masters, "
          f"election timeout {bench['params']['election_timeout_s']} s): "
          f"MTTR {bm['mttr_s']} s against the gate of "
          f"{bench['params']['mttr_budget_s']} s (two election timeouts "
          f"plus the rank stagger){' MISSED' if miss else ''}; "
          f"{bm['acked_writes']} acknowledged writes, {bm['lost_acked']} "
          f"lost, {bm['staleness_violations']} staleness violations, "
          f"standby lag p50 {bm['standby_lag_p50_us']} us p99 "
          f"{bm['standby_lag_p99_us']} us", flush=True)
    for e in (first, second, third):
        for key in ("sums", "times", "blocks"):
            e.pop(key, None)
    out = {"keys": HA_KEYS, "settings": HA_SETTINGS,
           "block_bytes": BLOCK_BYTES, "shards": HA_SHARDS,
           "leader_s": leader_s, "write_s": drill["write_s"],
           "epochs": [first, second, third], "chain": got,
           "failover": {"leader_named_s": w.leader_s,
                        "first_ack_s": drill["first_ack_s"],
                        "worker_registered_s": w.registered_s,
                        "off_shm_blocks": drill["off_shm"],
                        "acked_creates": len(acks), "lost": 0},
           "standby_reads": {"latency": lat, "counted": standby_reads,
                             "staleness_violations": violations},
           "rejoin": {"quorum_alert_fired_s": fired_s, "rejoin_s": rejoin_s,
                      "resolved_s": resolved_s, "masters_rows": rows},
           "backup": {"landed_s": landed["s"], "restored": len(restored),
                      "migrate_down": down, "migrate_up": up},
           "bench": {"metrics": bm, "params": bench["params"],
                     "gate_miss": miss, "exit": proc.returncode},
           # the suite's ha-failover row (2h d takes it)
           "bench_row": bench,
           "launches": rk.launches, "s": time.perf_counter() - t_phase}
    print(f"2k: {out['s']:.1f} s, scaled_sum launched {rk.launches} times",
          flush=True)
    return out


# -- 2m: the port's lock-order auditor and lint on the card -------------------
#: 2m's cuts, each printed beside its default: the master's history tick,
#: the worker's metrics heartbeat and the client's metrics collection, so
#: the history store takes samples during the audited epochs
LOCKAUDIT_KEYS = {
    "atpu.master.health.eval.interval": "200ms",
    "atpu.worker.metrics.heartbeat.interval": "250ms",
    "atpu.user.metrics.collection.enabled": "true",
    "atpu.user.metrics.heartbeat.interval": "250ms",
}
LOCKAUDIT_THREADS = 4          # (b): namespace threads under /audit
LOCKAUDIT_ASYNC_FILES = 8      # (b): ASYNC_THROUGH files, one every ...
LOCKAUDIT_ASYNC_GAP_S = 0.2    # ... 0.2 s while the epochs run
LOCKAUDIT_ASYNC_BYTES = 1 << 20
LOCKAUDIT_PERSIST_S = 60.0
LOCKAUDIT_HA_BLOCKS = 16       # (c): the HA turn's CACHE_THROUGH shards
LINT_TIMEOUT_S = 120


def audit_epoch(device, fs, paths: list, on_block=None) -> dict:
    """One epoch of a fresh loader with a device tier over ``paths``
    (every block crosses from the worker into the tier): each block's
    ``scaled_sum`` held against ``scaled_sum_reference``; ``on_block(n)``
    after the n-th consumed block."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    loader = DeviceBlockLoader(fs, paths, device=device,
                               hbm_bytes=len(paths) * BLOCK_BYTES
                               + (64 << 20), prefetch=2, dtype=np.int32)
    n = 0
    try:
        _sync_device(device)
        t = time.perf_counter()
        for path, block in zip(paths, loader.epoch()):
            x = rk.pad_to_kernel_shape(block)
            got = int(rk.scaled_sum(x, 1))
            want = int(rk.scaled_sum_reference(x, 1))
            if got != want:
                fail(f"2m: {path}'s scaled_sum {got} != plain {want}")
            n += 1
            if on_block is not None:
                on_block(n)
        _sync_device(device)
        epoch_s = time.perf_counter() - t
    finally:
        loader.close()
    if n != len(paths):
        fail(f"2m: the epoch gave {n} blocks for {len(paths)} files")
    return {"s": epoch_s,
            "gb_per_s": len(paths) * BLOCK_BYTES / epoch_s / 1e9}


class SideLoad:
    """(2m b) what runs beside the audited epochs: ``LOCKAUDIT_THREADS``
    threads that create, write, rename and delete under ``/audit``, and
    one that writes ``LOCKAUDIT_ASYNC_FILES`` ASYNC_THROUGH files for the
    persistence scheduler to persist. ``stop()`` joins them and raises
    the first error any of them met."""

    def __init__(self, fs) -> None:
        import threading

        self._fs = fs
        self._stop = threading.Event()
        self.ops = [0] * LOCKAUDIT_THREADS
        self.async_files: dict = {}
        self.errors: list = []
        self._threads = [
            threading.Thread(target=self._namespace, args=(n,), daemon=True,
                             name=f"smoke-2m-ns-{n}")
            for n in range(LOCKAUDIT_THREADS)]
        self._threads.append(threading.Thread(
            target=self._async_through, daemon=True, name="smoke-2m-async"))
        for t in self._threads:
            t.start()

    def _namespace(self, n: int) -> None:
        from alluxio_tpu_torch.client.streams import WriteType

        fs, i = self._fs, 0
        try:
            while not self._stop.is_set():
                d = f"/audit/t{n}/d{i}"
                fs.create_directory(d, recursive=True)
                fs.write_all(f"{d}/f", b"a" * 4096,
                             write_type=WriteType.MUST_CACHE)
                fs.rename(f"{d}/f", f"{d}/g")
                fs.delete(d, recursive=True)
                self.ops[n] += 4
                i += 1
        except Exception as e:  # noqa: BLE001 - surfaced by stop()
            self.errors.append(e)

    def _async_through(self) -> None:
        from alluxio_tpu_torch.client.streams import WriteType

        rng = np.random.default_rng(SEED + 17)
        try:
            for i in range(LOCKAUDIT_ASYNC_FILES):
                path = f"/audit/async/f{i}"
                data = rng.integers(0, 256, LOCKAUDIT_ASYNC_BYTES,
                                    dtype=np.uint8).tobytes()
                self._fs.write_all(path, data,
                                   write_type=WriteType.ASYNC_THROUGH)
                self.async_files[path] = data
                # a stop only cuts the gaps: every file is written
                self._stop.wait(LOCKAUDIT_ASYNC_GAP_S)
        except Exception as e:  # noqa: BLE001 - surfaced by stop()
            self.errors.append(e)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(60)
        if any(t.is_alive() for t in self._threads):
            fail("2m: a side-load thread outlived its stop")
        if self.errors:
            fail(f"2m: the side load failed: {self.errors[0]!r}")


def wait_persisted(fs, files: dict) -> float:
    """Seconds until every file of ``files`` is PERSISTED, each UFS copy
    then held against its bytes."""
    t = time.perf_counter()
    deadline = t + LOCKAUDIT_PERSIST_S
    for path, data in files.items():
        while not fs.get_status(path).persisted:
            if time.perf_counter() > deadline:
                fail(f"2m: {path} was not persisted within "
                     f"{LOCKAUDIT_PERSIST_S:.0f} s")
            time.sleep(0.05)
        with open(fs.get_status(path).ufs_path, "rb") as f:
            if f.read() != data:
                fail(f"2m: {path}'s UFS copy differs from what was written")
    return time.perf_counter() - t


def lockaudit_ha_turn(device, main: dict, base: str) -> dict:
    """(2m c) the audit over an in-process ``HaCluster`` (three masters on
    Raft journals, one worker): ``LOCKAUDIT_HA_BLOCKS`` CACHE_THROUGH
    shards read by the card's loader, the primary stepping down to a
    standby when half the epoch is consumed."""
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.lint import pytest_lockaudit as pla
    from alluxio_tpu_torch.minicluster.ha_cluster import HaCluster

    paths = list(main["files"])[:LOCKAUDIT_HA_BLOCKS]
    files = {f"/audit-ha/s{i:02d}": main["files"][p][1]
             for i, p in enumerate(paths)}
    cluster = HaCluster(
        os.path.join(base, "ha"), num_masters=3, num_workers=1,
        worker_mem_bytes=LOCKAUDIT_HA_BLOCKS * BLOCK_BYTES + (256 << 20),
        conf_overrides={Keys.USER_BLOCK_SIZE_BYTES_DEFAULT: BLOCK_BYTES})
    try:
        cluster.start()
        fs = cluster.file_system()
        for path, block_file in files.items():
            fs.write_all(path, np.fromfile(block_file, dtype=np.uint8),
                         write_type=WriteType.CACHE_THROUGH)
        before = cluster.primary_index()
        step = {}

        def step_down(n: int) -> None:
            if n != LOCKAUDIT_HA_BLOCKS // 2:
                return
            target = cluster.raft_addresses[(before + 1) % 3]
            t = time.perf_counter()
            if not cluster.masters[before].journal.transfer_leadership(
                    target):
                fail("2m (c): the primary's step-down did not complete")
            step["s"] = time.perf_counter() - t

        with pla.audited() as auditor:
            epoch = audit_epoch(device, fs, list(files), on_block=step_down)
        after = cluster.await_primary()
        fs.close()
    finally:
        cluster.stop()
    if after == before or "s" not in step:
        fail(f"2m (c): the primary stayed m{before}")
    inversions = auditor.inversions()
    if inversions:
        fail(f"2m (c): lock-order inversions {inversions}\n"
             f"{auditor.report()}")
    return {"epoch_s": epoch["s"], "step_down_s": step["s"],
            "primary": [before, after], "edges": len(auditor.edges),
            "inversions": inversions}


def lint_on_host() -> dict:
    """(2m f) ``python -m alluxio_tpu_torch.lint`` on this host (g++
    builds the port's native library, so ``native-abi`` diffs it)."""
    import re

    from alluxio_tpu_torch import native

    symbols = native.exported_symbols()
    if symbols != sorted(native._PROTOTYPES):
        fail(f"2m (f): the native library exports {symbols}, the "
             f"prototypes are {sorted(native._PROTOTYPES)}")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "alluxio_tpu_torch.lint"],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t
    m = re.search(r"lint: (\d+) new finding\(s\) .*?, (\d+) suppressed, "
                  r"(\d+) baselined, (\d+) stale .* in ([0-9.]+)s",
                  proc.stdout)
    if proc.returncode != 0 or m is None or int(m.group(1)) != 0:
        fail(f"2m (f): the lint exited {proc.returncode}: "
             f"{proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    return {"new": int(m.group(1)), "suppressed": int(m.group(2)),
            "baselined": int(m.group(3)), "stale": int(m.group(4)),
            "analysis_s": float(m.group(5)), "s": seconds,
            "native_symbols": len(symbols)}


def lockaudit_phase(device, main: dict) -> dict:
    """(2m) the port's lock-order auditor around an in-process cluster
    (master, one worker, the job service) while the card's loader reads
    the main path's set: a first epoch over the freshly written blocks,
    two audited epochs and a plain one beside the side load; then the
    auditor around an HA cluster's step-down, and the port's lint on
    this host. Any inversion fails the phase."""
    from alluxio_tpu_torch.conf.property_key import REGISTRY
    from alluxio_tpu_torch.lint import pytest_lockaudit as pla
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    t_phase = time.perf_counter()
    for key, value in LOCKAUDIT_KEYS.items():
        print(f"2m: cut {key} = {value} (default "
              f"{REGISTRY.get(key).default})", flush=True)
    # (a) the classes are patched before the cluster builds its locks
    pla.install()
    paths = list(main["files"])
    tier = NUM_BLOCKS * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + LOCKAUDIT_HA_BLOCKS * BLOCK_BYTES * 2)
    rk.launches = 0
    cluster = LocalCluster(
        os.path.join(base, "cluster"), num_workers=1,
        block_size=BLOCK_BYTES, worker_mem_bytes=tier,
        start_worker_heartbeats=True, start_job_service=True,
        conf_overrides=LOCKAUDIT_KEYS).start()
    try:
        fs = cluster.file_system()
        write_s = write_files(fs, main["files"])
        history = cluster.master.metrics_master.history
        samples0 = history.series_count()
        # (b) a first epoch pays the first touch of the freshly written
        # blocks; then two audited epochs under the side load, and a
        # plain one
        first = audit_epoch(device, fs, paths)
        side = SideLoad(fs)
        try:
            before = rk.launches
            with pla.audited() as auditor:
                audited = [audit_epoch(device, fs, paths) for _ in range(2)]
                names = pla.acquired_names()
            audited_launches = rk.launches - before
            plain = audit_epoch(device, fs, paths)
        finally:
            side.stop()
        persist_s = wait_persisted(fs, side.async_files)
        series = history.series_count() - samples0
        fs.close()
    finally:
        cluster.stop()
    inversions = auditor.inversions()
    if inversions:
        fail(f"2m (b): lock-order inversions {inversions}\n"
             f"{auditor.report()}")
    if audited_launches != 2 * NUM_BLOCKS:
        fail(f"2m (b): {audited_launches} scaled_sum launches in the two "
             f"audited epochs, want {2 * NUM_BLOCKS}")
    must = {"InodeTree.lock", "BlockMaster._lock", "JobMaster._lock",
            "HbmPageStore._lock", "MetricsHistory._lock",
            "FileSystemMaster._persist_mutex"}
    if not must <= set(names):
        fail(f"2m (b): the audit saw no acquisition of "
             f"{sorted(must - set(names))}")
    print(f"2m (b): {NUM_BLOCKS} x {BLOCK_BYTES >> 20} MiB written in "
          f"{write_s:.2f} s; the first epoch over them "
          f"{first['s']:.3f} s; audited epochs {audited[0]['s']:.3f} s and "
          f"{audited[1]['s']:.3f} s ({audited[1]['gb_per_s']:.2f} GB/s), "
          f"the plain epoch {plain['s']:.3f} s "
          f"({plain['gb_per_s']:.2f} GB/s); every block's scaled_sum the "
          f"plain version's; beside them {sum(side.ops)} namespace ops on "
          f"{LOCKAUDIT_THREADS} threads, {len(side.async_files)} "
          f"ASYNC_THROUGH files persisted {persist_s:.2f} s after the "
          f"epochs, {series} new history series; {len(names)} audited "
          f"locks taken, {len(auditor.edges)} order edges, inversions "
          f"{inversions}", flush=True)
    ha = lockaudit_ha_turn(device, main, base)
    print(f"2m (c): HA cluster (three masters, Raft journals): "
          f"{LOCKAUDIT_HA_BLOCKS} CACHE_THROUGH shards read in "
          f"{ha['epoch_s']:.3f} s, m{ha['primary'][0]} stepped down to "
          f"m{ha['primary'][1]} at block {LOCKAUDIT_HA_BLOCKS // 2} "
          f"({ha['step_down_s']:.3f} s); {ha['edges']} order edges, "
          f"inversions {ha['inversions']}", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    launches = rk.launches
    lint = lint_on_host()
    print(f"2m (f): python -m alluxio_tpu_torch.lint exited 0 in "
          f"{lint['s']:.2f} s ({lint['analysis_s']} s of analysis): "
          f"{lint['new']} new, {lint['baselined']} baselined, "
          f"{lint['suppressed']} suppressed; native-abi diffed "
          f"{lint['native_symbols']} exported symbols", flush=True)
    out = {"locks": len(names), "edges": len(auditor.edges),
           "inversions": inversions,
           "epoch_s": [(audited[0]["s"] + audited[1]["s"]) / 2, plain["s"]],
           "audited_epochs_s": [e["s"] for e in audited],
           "first_epoch_s": first["s"], "lock_names": names,
           "scaled_sum_launches": audited_launches,
           "namespace_ops": sum(side.ops),
           "async_through": {"files": len(side.async_files),
                             "persisted_s": persist_s},
           "history_series": series, "ha": ha, "card": CARD,
           "launches": launches, "lint": lint,
           "s": time.perf_counter() - t_phase}
    print(f"2m: {out['s']:.1f} s, scaled_sum launched {launches} times",
          flush=True)
    return out


# -- 2n: the UFS connectors: a cold epoch from a faked S3 bucket -------------
S3_SHARDS = 16            # (a): 16 x 32 MiB = 512 MiB put into the bucket
S3_BUCKET = "bkt"
S3_ROOT = "data"
S3_KEYS = {"s3.access.key": "smoke-ak", "s3.secret.key": "smoke-sk"}
S3_BOOT_S = 30.0
S3_DEADLINE_S = 60.0
#: the worker's metrics heartbeat, cut so that the master's cluster
#: counters (the worker's fetch counts) trail the epoch by 200 ms
S3_METRICS_HEARTBEAT = "200ms"
S3_PARQUET_ROWS = 1 << 20  # (e): one int64 and one float32 column
#: the fake S3 server of ``tests/testutils/fake_s3.py``, loaded by path in
#: a process of its own (its GIL is not the client's); on a machine where
#: an installed ``tests`` package shadows the repository's, the two
#: modules it needs are put in place first
S3_CHILD = r"""
import importlib.util, os, sys, types
root = sys.argv[1]
for name in ("tests", "tests.testutils"):
    sys.modules[name] = types.ModuleType(name)
def load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
load("tests.testutils.httpfake", "tests/testutils/httpfake.py")
fake = load("tests.testutils.fake_s3", "tests/testutils/fake_s3.py")
srv = fake.FakeS3Server()
print(srv.endpoint, flush=True)
srv._server.serve_forever(poll_interval=0.1)
"""


def start_http_child(name: str, what: str, code: str, *args: str,
                     timeout_s: float) -> tuple:
    """A fake HTTP server run by ``code`` in a child process (argv: the
    repository, then ``args``) that prints its endpoint first: (process,
    endpoint). Its stdin is a pipe, for a child that takes commands; the
    run fails (phase ``name``) if no endpoint comes in ``timeout_s``."""
    import select

    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), *args],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline().strip() if ready else ""
    if not line.startswith("http://"):
        stop_child(proc)
        fail(f"{name}: the fake {what} did not start ({line!r}, "
             f"{proc.stderr.read()[-1500:]!r})")
    return proc, line


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def cluster_fetch(meta) -> dict:
    """The worker's fetch counters as the master aggregates them from
    the worker's metrics heartbeat (``Cluster.<name>``)."""
    m = meta.get_metrics()
    return {n: int(m.get(f"Cluster.{n}", 0)) for n in (
        "UfsFetchStarted", "UfsFetchBytes", "UfsFetchCoalesced",
        "UfsFetchFallbacks", "UfsFetchFailures", "UfsBlocksRead")}


def settled_fetch(meta, before: dict, blocks: int) -> dict:
    """The fetch counters' delta since ``before`` once the worker has
    reported ``blocks`` UFS block reads and two more heartbeats brought
    nothing new."""
    deadline = time.monotonic() + S3_DEADLINE_S
    last, same = None, 0
    while same < 2:
        now = cluster_fetch(meta)
        d = {n: now[n] - before[n] for n in now}
        same = same + 1 if d == last and d["UfsBlocksRead"] >= blocks \
            else 0
        last = d
        if time.monotonic() > deadline:
            fail(f"2n: the worker's fetch counters never settled at "
                 f"{blocks} UFS block reads: {d}")
        time.sleep(0.25)
    return last


def s3_epoch(name: str, device, loader, paths: list, sums: dict) -> dict:
    """One loader epoch onto ``device``: each block's ``scaled_sum``
    (one launch a block) against the plain version and against numpy's
    sum of the object read straight from the bucket."""
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    got = {}
    _sync_device(device)
    t = time.perf_counter()
    for path, block in zip(paths, loader.epoch()):
        x = rk.pad_to_kernel_shape(block)
        value = int(rk.scaled_sum(x, 1))
        plain = int(rk.scaled_sum_reference(x, 1))
        if value != plain or value != sums[path]:
            fail(f"2n {name}: {path}'s scaled_sum {value}, plain {plain}, "
                 f"the bucket's bytes {sums[path]}")
        got[path] = value
    _sync_device(device)
    dt = time.perf_counter() - t
    if list(got) != list(paths):
        fail(f"2n {name}: the epoch gave {len(got)} of {len(paths)} blocks")
    return {"s": dt, "gb_per_s": len(paths) * BLOCK_BYTES / dt / 1e9,
            "wait_s": loader.stall_report()["total_wait_s"]}


def adapters_check(device, fs) -> dict:
    """(2n e): a Parquet file written into the cluster through the
    port's Arrow adapter, read back through it and through the port's
    fsspec class; one column onto the card, its sum against numpy's."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from alluxio_tpu_torch.client.arrow_fs import arrow_file_system
    from alluxio_tpu_torch.client.fsspec_fs import AlluxioTpuFileSystem

    rng = np.random.default_rng(SEED + 18_100)
    x = rng.integers(-2**40, 2**40, S3_PARQUET_ROWS, dtype=np.int64)
    y = rng.standard_normal(S3_PARQUET_ROWS).astype(np.float32)
    table = pa.table({"x": x, "y": y})
    afs = arrow_file_system(fs=fs)
    t = time.perf_counter()
    afs.create_dir("/adapters")
    pq.write_table(table, "/adapters/t.parquet", filesystem=afs)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    back = pq.read_table("/adapters/t.parquet", filesystem=afs)
    arrow_s = time.perf_counter() - t
    t = time.perf_counter()
    via_fsspec = pq.read_table("adapters/t.parquet",
                               filesystem=AlluxioTpuFileSystem(fs=fs),
                               columns=["x"])
    fsspec_s = time.perf_counter() - t
    if not back.equals(table) or \
            not via_fsspec.column("x").equals(table.column("x")):
        fail("2n (e): the Parquet file read back through the adapters "
             "differs from the table written")
    col = torch.from_numpy(via_fsspec.column("x").to_numpy().copy()).to(
        device)
    card = int(col.sum())
    want = int(x.sum())
    if card != want:
        fail(f"2n (e): column x sums to {card} on the card, {want} in numpy")
    size = fs.get_status("/adapters/t.parquet").length
    return {"rows": S3_PARQUET_ROWS, "parquet_bytes": size,
            "arrow_write_s": write_s, "arrow_read_s": arrow_s,
            "fsspec_read_s": fsspec_s, "column_sum": card}


def s3_phase(device, worker: dict) -> dict:
    """(2n): the UFS connectors on the card's path. A fake S3 server in a
    child process; (a) ``S3_SHARDS`` seeded int32 shards of 32 MiB put
    into its bucket through the port's ``S3UnderFileSystem`` (multipart);
    (b) a ``MultiProcessCluster`` mounts ``s3://bkt/data`` at ``/s3`` with
    the endpoint and keys as mount properties, and lists it; (c) a
    ``DeviceBlockLoader`` with a device tier reads the shards cold: every
    block crosses the worker's fetch from S3 once (the worker's counters,
    as the master aggregates them), and each block's ``scaled_sum``
    equals the plain version and numpy's sum of the bucket's bytes; (d) a
    second epoch from the device tier adds no UFS read; (e) the Arrow and
    fsspec adapters round-trip a Parquet file."""
    import torch

    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.minicluster.multi_process import (
        MultiProcessCluster,
    )
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.clients import MetaMasterClient
    from alluxio_tpu_torch.underfs.registry import supported_schemes
    from alluxio_tpu_torch.underfs.s3 import S3Client, S3UnderFileSystem

    if "s3" not in supported_schemes():
        fail(f"2n: the port's registry has no s3 connector "
             f"({supported_schemes()})")
    n = S3_SHARDS
    tier = n * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + (64 << 20))
    proc, endpoint = start_http_child("2n", "S3 server", S3_CHILD,
                                      timeout_s=S3_BOOT_S)
    props = {"s3.endpoint": endpoint, **S3_KEYS}
    cluster = fs = loader = None
    try:
        # (a) the bucket, filled through the port's connector
        ufs = S3UnderFileSystem(f"s3://{S3_BUCKET}/{S3_ROOT}", props)
        sums, fill_s = {}, 0.0
        for i in range(n):
            arr = np.random.default_rng(SEED + 18_000 + i).integers(
                -2**31, 2**31 - 1, size=BLOCK_BYTES // 4, dtype=np.int32)
            key = f"s3://{S3_BUCKET}/{S3_ROOT}/shard-{i:02d}.bin"
            t = time.perf_counter()
            with ufs.create(key) as w:
                w.write(arr.data)
            fill_s += time.perf_counter() - t
            sums[f"/s3/shard-{i:02d}.bin"] = wrap32(arr.sum(dtype=np.int64))
        ufs.close()
        total = n * BLOCK_BYTES
        print(f"2n (a): {n} x {BLOCK_BYTES >> 20} MiB seeded shards put "
              f"into s3://{S3_BUCKET}/{S3_ROOT} on a fake S3 server (a "
              f"child process, {endpoint}) through the port's "
              f"S3UnderFileSystem, multipart at 8 MiB parts, SigV4: "
              f"{fill_s:.3f} s ({total / fill_s / 1e9:.3f} GB/s)",
              flush=True)

        # (b) the mount, its properties the endpoint and the keys
        cluster = MultiProcessCluster(
            os.path.join(base, "cluster"), num_workers=1, extra_conf={
                Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(BLOCK_BYTES),
                Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
                "atpu.worker.metrics.heartbeat.interval":
                    S3_METRICS_HEARTBEAT})
        t = time.perf_counter()
        cluster.start(timeout_s=MP_BOOT_S)
        fs = cluster.file_system()
        boot_s = time.perf_counter() - t
        meta = MetaMasterClient(cluster.master_addresses,
                                retry_duration_s=30.0)
        t = time.perf_counter()
        fs.mount("/s3", f"s3://{S3_BUCKET}/{S3_ROOT}", properties=props)
        listed = {i.path: i.length for i in fs.list_status("/s3")}
        mount_s = time.perf_counter() - t
        if listed != {p: BLOCK_BYTES for p in sums}:
            fail(f"2n (b): /s3 lists {listed}, want the {n} shards of "
                 f"{BLOCK_BYTES} bytes")
        print(f"2n (b): MultiProcessCluster up in {boot_s:.2f} s; mount "
              f"/s3 -> s3://{S3_BUCKET}/{S3_ROOT} and its listing "
              f"{mount_s:.3f} s: {len(listed)} files of {BLOCK_BYTES} "
              f"bytes", flush=True)

        # (c) the cold epoch: every block through the worker's S3 fetch
        paths = list(sums)
        rfs = RungFS(fs)
        before = settled_fetch(meta, {k: 0 for k in cluster_fetch(meta)}, 0)
        hits = metrics().counter("Client.JaxHbmHits")
        loader = DeviceBlockLoader(rfs, paths, device=device,
                                   hbm_bytes=total + (64 << 20),
                                   prefetch=2, dtype=np.int32)
        rk.launches = 0
        cold = s3_epoch("cold epoch", device, loader, paths, sums)
        launches = rk.launches
        d = settled_fetch(meta, before, n)
        check_fetch("2n (c) cold epoch", d, n)
        if launches != n:
            fail(f"2n (c): scaled_sum launched {launches} times, want {n}")
        # (d) the warm epoch, from the device tier
        hits0 = hits.count
        rk.launches = 0
        warm = s3_epoch("warm epoch", device, loader, paths, sums)
        launches += rk.launches
        warm_hits = hits.count - hits0
        d2 = settled_fetch(meta, before, n)
        if d2 != d or warm_hits != n:
            fail(f"2n (d): the warm epoch made {warm_hits} device-tier "
                 f"hits (want {n}) and moved the fetch counters "
                 f"{d} -> {d2}")
        loader.close()
        loader = None
        local = {t["mode"]: t for t in worker["cold_read"]}["single"]
        print(f"2n (c): cold epoch of {n} x {BLOCK_BYTES >> 20} MiB from "
              f"the fake S3 bucket through the worker's fetch into the "
              f"device tier {cold['s']:.3f} s ({cold['gb_per_s']:.3f} "
              f"GB/s, consumer wait {cold['wait_s']:.3f} s), block opens "
              f"by rung {rfs.rungs}, {d['UfsFetchStarted']} fetches, "
              f"{d['UfsBlocksRead']} UFS block reads, "
              f"{d['UfsFetchBytes']} bytes, {d['UfsFetchFallbacks']} "
              f"fallbacks, {d['UfsFetchFailures']} failures; every "
              f"scaled_sum == plain == the bucket's bytes; beside 2c's "
              f"local cold rung (one stream, {local['blocks']} x "
              f"{BLOCK_BYTES >> 20} MiB) {local['gb_per_s']:.3f} GB/s; "
              f"(d) warm epoch {warm['s']:.4f} s, {warm_hits} device-tier "
              f"hits, no UFS read", flush=True)

        # (e) the adapters
        adapters = adapters_check(device, fs)
        print(f"2n (e): Parquet ({adapters['rows']} rows, "
              f"{adapters['parquet_bytes']} bytes) written through "
              f"arrow_file_system in {adapters['arrow_write_s']:.3f} s, "
              f"read back through it in {adapters['arrow_read_s']:.3f} s "
              f"and column x through AlluxioTpuFileSystem in "
              f"{adapters['fsspec_read_s']:.3f} s; its sum on the card "
              f"{adapters['column_sum']} == numpy", flush=True)
        bucket = S3Client(S3_BUCKET, props)
        keys = bucket.list_prefix(f"{S3_ROOT}/")
        if len(keys) != n:
            fail(f"2n: the bucket holds {keys}, want the {n} shards")
        return {"shards": n, "bytes": total, "fill_s": fill_s,
                "fill_gb_per_s": total / fill_s / 1e9, "boot_s": boot_s,
                "mount_list_s": mount_s, "cold": cold, "warm": warm,
                "warm_hits": warm_hits, "fetch": d, "rungs": rfs.rungs,
                "local_cold_gb_per_s": local["gb_per_s"],
                "adapters": adapters, "launches": launches}
    finally:
        try:
            if loader is not None:
                loader.close()
            if fs is not None:
                fs.close()
        finally:
            try:
                if cluster is not None:
                    cluster.stop()
            finally:
                stop_child(proc)
                shutil.rmtree(base, ignore_errors=True)


# -- 2o: the serving surfaces: FUSE, the S3 and REST proxy, Hive, the log server
SERVE_SHARDS = 16          # (a): 16 x 32 MiB = 512 MiB, written MUST_CACHE
#: (c)'s ranged GETs through the port's S3 client
SERVE_RANGE_BYTES = 8 << 20
#: (b)'s reads in process: the size a FUSE read callback is asked for
#: (libfuse 2's default max_read, 128 KiB)
SERVE_FUSE_READ_BYTES = 128 << 10
SERVE_HIVE_ROWS = 1 << 20  # (d): a Parquet table of 1 Mi rows
SERVE_BOOT_S = 60.0
#: the S3 root the proxy serves, and the corpus's bucket under it
SERVE_S3_ROOT = "/s3"
SERVE_BUCKET = "corpus"
#: how (b) reaches the FUSE layer, chosen once from ``tools/fuse_probe.py``
#: on the card's host (PERF.md section 5): that host has /dev/fuse but no
#: libfuse.so.2, so no kernel mount; the leg calls ``FuseFs``'s
#: open/read/release in process over the same files ("kernel": through a
#: mount by the ``fuse`` child)
SERVE_FUSE_ROUTE = "in-process"
#: the fake Hive metastore of ``tests/testutils/fake_hms.py``, loaded by
#: path in a process of its own, its thrift layer the port's copy (the
#: fake names JAX's module, which this script never imports): argv is the
#: repository, the database, the table, its location and its columns
HMS_CHILD = r"""
import importlib.util, json, os, sys, types
root = sys.argv[1]
sys.path.insert(0, root)
import alluxio_tpu_torch.table.thrift_proto as tp
for name in ("tests", "tests.testutils", "alluxio_tpu", "alluxio_tpu.table"):
    sys.modules[name] = types.ModuleType(name)
sys.modules["alluxio_tpu.table.thrift_proto"] = tp
spec = importlib.util.spec_from_file_location(
    "tests.testutils.fake_hms", os.path.join(root, "tests/testutils/fake_hms.py"))
fake = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fake)
srv = fake.FakeHmsServer()
srv.add_table(sys.argv[2], fake.HmsTable(
    sys.argv[3], sys.argv[4], cols=[tuple(c) for c in json.loads(sys.argv[5])]))
print(srv.port, flush=True)
srv._httpd.serve_forever(poll_interval=0.1)
"""


def serve_scan(name: str, device, buf, path: str, sums: dict) -> None:
    """One block from the pinned host buffer ``buf`` onto the card: its
    ``scaled_sum`` (one launch) against the plain version and numpy's
    int32-wraparound sum of the file's bytes."""
    import torch

    from alluxio_tpu_torch.ops import reduce_kernel as rk

    x = rk.pad_to_kernel_shape(buf.to(device).view(torch.int32))
    value = int(rk.scaled_sum(x, 1))
    plain = int(rk.scaled_sum_reference(x, 1))
    if value != plain or value != sums[path]:
        fail(f"2o {name}: {path}'s scaled_sum {value}, plain {plain}, "
             f"the file's bytes {sums[path]}")


def wait_for(what: str, cond, timeout_s: float = SERVE_BOOT_S,
             name: str = "2o"):
    """``cond()``'s first true value, polled every 50 ms; the run fails
    (phase ``name``) with ``what`` after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            fail(f"{name}: {what} within {timeout_s} s")
        time.sleep(0.05)


def _accepts(port: int) -> bool:
    import socket

    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
        return True
    except OSError:
        return False


def fuse_leg(device, fs, mnt: str, paths: list, sums: dict, base: str,
             main: dict) -> dict:
    """(2o b): the corpus through the FUSE layer, by ``SERVE_FUSE_ROUTE``:
    the listing, each shard read by path into a pinned host buffer, onto
    the card and scanned; one seeded 32 MiB file copied in, read back
    through the port's ``FileSystem``."""
    import torch

    from alluxio_tpu_torch.fuse.fs import FuseFs

    names = sorted(os.path.basename(p) for p in paths)
    listing = sorted(i.name for i in fs.list_status(
        f"{SERVE_S3_ROOT}/{SERVE_BUCKET}"))
    impl = FuseFs(fs, f"{SERVE_S3_ROOT}/{SERVE_BUCKET}") \
        if SERVE_FUSE_ROUTE == "in-process" else None
    seen = sorted(impl.readdir("/")) if impl is not None \
        else sorted(os.listdir(mnt))
    if seen != listing or not set(names) <= set(seen):
        fail(f"2o (b): the FUSE listing {seen} != list_status {listing}")
    buf = torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    wait_s = 0.0
    _sync_device(device)
    t = time.perf_counter()
    for path in paths:
        name = os.path.basename(path)
        t_read = time.perf_counter()
        if impl is None:
            with open(os.path.join(mnt, name), "rb", buffering=0) as f:
                n = f.readinto(memoryview(host))
        else:
            fh = impl.open(f"/{name}", write=False)
            if fh < 0:
                fail(f"2o (b): FuseFs.open({name}) = {fh}")
            n = 0
            try:
                while n < BLOCK_BYTES:
                    chunk = impl.read(fh, SERVE_FUSE_READ_BYTES, n)
                    if isinstance(chunk, int):
                        fail(f"2o (b): FuseFs.read({name}) = {chunk}")
                    if not chunk:
                        break
                    host[n:n + len(chunk)] = np.frombuffer(chunk, np.uint8)
                    n += len(chunk)
            finally:
                impl.release(fh)
        wait_s += time.perf_counter() - t_read
        if n != BLOCK_BYTES:
            fail(f"2o (b): {name} read {n} bytes, want {BLOCK_BYTES}")
        serve_scan("(b) FUSE", device, buf, path, sums)
    _sync_device(device)
    epoch_s = time.perf_counter() - t
    # one seeded 32 MiB file copied in
    data = np.random.default_rng(SEED + 19_001).integers(
        0, 256, size=BLOCK_BYTES, dtype=np.uint8).tobytes()
    src = os.path.join(base, "copy-src.bin")
    Path(src).write_bytes(data)
    t = time.perf_counter()
    if impl is None:
        shutil.copyfile(src, os.path.join(mnt, "copy.bin"))
    else:
        fh = impl.create("/copy.bin")
        with open(src, "rb") as f:
            off = 0
            while True:
                chunk = f.read(SERVE_FUSE_READ_BYTES)
                if not chunk:
                    break
                if impl.write(fh, chunk, off) != len(chunk):
                    fail("2o (b): FuseFs.write of copy.bin failed")
                off += len(chunk)
        if impl.flush(fh) != 0 or impl.release(fh) != 0:
            fail("2o (b): FuseFs could not commit copy.bin")
    copy_s = time.perf_counter() - t
    back = fs.read_all(f"{SERVE_S3_ROOT}/{SERVE_BUCKET}/copy.bin")
    if bytes(back) != data:
        fail("2o (b): copy.bin read back through FileSystem differs")
    if impl is not None:
        impl.close_all()
    total = len(paths) * BLOCK_BYTES
    out = {"route": SERVE_FUSE_ROUTE, "s": epoch_s,
           "gb_per_s": total / epoch_s / 1e9, "wait_s": wait_s,
           "copy_s": copy_s, "main_epoch1_s": main["epoch1_s"],
           "main_gb_per_s": NUM_BLOCKS * BLOCK_BYTES / main["epoch1_s"]
           / 1e9}
    how = ("through the kernel mount" if impl is None else
           f"through FuseFs in process ({SERVE_FUSE_READ_BYTES >> 10} KiB "
           f"reads; the card's host cannot mount)")
    print(f"2o (b): FUSE {how}: the listing equals list_status; "
          f"{len(paths)} x {BLOCK_BYTES >> 20} MiB by path into a pinned "
          f"buffer, onto the card and scanned, every scaled_sum == plain "
          f"== the file's bytes: {epoch_s:.3f} s "
          f"({out['gb_per_s']:.3f} GB/s, consumer wait {wait_s:.3f} s), "
          f"beside the main path's SHM-rung epoch 1 {main['epoch1_s']:.3f} "
          f"s ({out['main_gb_per_s']:.3f} GB/s); a seeded 32 MiB file "
          f"copied in ({copy_s:.3f} s) reads back equal", flush=True)
    return out


def proxy_leg(device, fs, pport: int, paths: list, sums: dict) -> dict:
    """(2o c): the corpus through the S3 proxy: ListBuckets and
    ListObjectsV2 against the listing, each shard in ranged GETs through
    the port's ``S3Client`` into a pinned buffer, onto the card and
    scanned; a multipart PUT read back; one REST ``get-status``."""
    import xml.etree.ElementTree as ET

    import requests
    import torch

    from alluxio_tpu_torch.underfs.s3 import S3Client

    endpoint = f"http://127.0.0.1:{pport}"
    root = ET.fromstring(requests.get(endpoint + "/", timeout=30).content)
    buckets = sorted(e.findtext("Name") for e in root.iter("Bucket"))
    want = sorted(i.name for i in fs.list_status(SERVE_S3_ROOT) if i.folder)
    if buckets != want:
        fail(f"2o (c): ListBuckets {buckets} != the listing {want}")
    client = S3Client(SERVE_BUCKET, {"s3.endpoint": endpoint})
    keys = sorted(client.list_prefix(""))
    listing = sorted(i.name for i in fs.list_status(
        f"{SERVE_S3_ROOT}/{SERVE_BUCKET}"))
    if keys != listing:
        fail(f"2o (c): ListObjectsV2 {keys} != the listing {listing}")
    buf = torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    wait_s, gets = 0.0, 0
    _sync_device(device)
    t = time.perf_counter()
    for path in paths:
        key = os.path.basename(path)
        t_read = time.perf_counter()
        for off in range(0, BLOCK_BYTES, SERVE_RANGE_BYTES):
            part = client.get(key, off, SERVE_RANGE_BYTES)
            if part is None or len(part) != SERVE_RANGE_BYTES:
                fail(f"2o (c): GET {key} bytes={off}- gave "
                     f"{None if part is None else len(part)} bytes")
            host[off:off + SERVE_RANGE_BYTES] = np.frombuffer(part, np.uint8)
            gets += 1
        wait_s += time.perf_counter() - t_read
        serve_scan("(c) proxy", device, buf, path, sums)
    _sync_device(device)
    epoch_s = time.perf_counter() - t
    # a multipart PUT of one seeded object
    data = np.random.default_rng(SEED + 19_002).integers(
        0, 256, size=BLOCK_BYTES, dtype=np.uint8).tobytes()
    t = time.perf_counter()
    upload = client.initiate_multipart("multipart.bin")
    etags = [(i + 1, client.upload_part(
        "multipart.bin", upload, i + 1,
        data[off:off + SERVE_RANGE_BYTES]))
        for i, off in enumerate(range(0, len(data), SERVE_RANGE_BYTES))]
    client.complete_multipart("multipart.bin", upload, etags)
    put_s = time.perf_counter() - t
    back = fs.read_all(f"{SERVE_S3_ROOT}/{SERVE_BUCKET}/multipart.bin")
    if bytes(back) != data:
        fail("2o (c): the multipart object read back through FileSystem "
             "differs")
    # one REST get-status
    status_path = paths[0]
    r = requests.get(f"{endpoint}/api/v1/paths{status_path}/get-status",
                     timeout=30)
    st = fs.get_status(status_path)
    rest = r.json()
    mine = {"path": st.path, "name": st.name, "folder": st.folder,
            "length": st.length,
            "lastModificationTimeMs": st.last_modification_time_ms}
    if r.status_code != 200 or rest != mine:
        fail(f"2o (c): REST get-status {r.status_code} {rest} != "
             f"get_status {mine}")
    total = len(paths) * BLOCK_BYTES
    out = {"s": epoch_s, "gb_per_s": total / epoch_s / 1e9,
           "wait_s": wait_s, "gets": gets, "multipart_put_s": put_s,
           "multipart_parts": len(etags)}
    print(f"2o (c): the S3 proxy (a child of the shell, {endpoint}): "
          f"ListBuckets {buckets} and ListObjectsV2 ({len(keys)} keys) "
          f"equal the listing; {len(paths)} x {BLOCK_BYTES >> 20} MiB in "
          f"{gets} ranged GETs of {SERVE_RANGE_BYTES >> 20} MiB through "
          f"the port's S3Client into a pinned buffer, onto the card and "
          f"scanned, every scaled_sum == plain == the file's bytes: "
          f"{epoch_s:.3f} s ({out['gb_per_s']:.3f} GB/s, consumer wait "
          f"{wait_s:.3f} s); a {len(etags)}-part multipart PUT "
          f"({put_s:.3f} s) reads back equal; REST get-status == "
          f"get_status", flush=True)
    return out


def hive_leg(device, cluster, fs, base: str) -> dict:
    """(2o d): a Parquet table of ``SERVE_HIVE_ROWS`` seeded rows written
    into the cluster under a mount, named by a fake Hive metastore (a
    child) at its UFS URI; ``validateHms`` through the shell; ``table
    attachdb hive`` through the table master; three columns through the
    planned reader onto the card."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.table_service import TableMasterClient
    from alluxio_tpu_torch.table.reader import read_columns

    wh = os.path.join(base, "warehouse")
    os.makedirs(wh)
    fs.mount("/warehouse", wh)
    rng = np.random.default_rng(SEED + 19_003)
    cols = {"a": rng.integers(-2**31, 2**31 - 1, SERVE_HIVE_ROWS,
                              dtype=np.int32),
            "b": rng.integers(-2**31, 2**31 - 1, SERVE_HIVE_ROWS,
                              dtype=np.int32),
            "c": rng.integers(-2**40, 2**40, SERVE_HIVE_ROWS,
                              dtype=np.int64)}
    sink = io.BytesIO()
    pq.write_table(pa.table(cols), sink)
    path = "/warehouse/events/part-0.parquet"
    t = time.perf_counter()
    fs.create_directory("/warehouse/events", recursive=True,
                        allow_exists=True)
    fs.write_all(path, sink.getvalue(), write_type=WriteType.CACHE_THROUGH)
    write_s = time.perf_counter() - t
    hive_cols = [["a", "int"], ["b", "int"], ["c", "bigint"]]
    proc = subprocess.Popen(
        [sys.executable, "-c", HMS_CHILD, str(ROOT), "smoke", "events",
         os.path.join(wh, "events"), json.dumps(hive_cols)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        import select

        ready, _, _ = select.select([proc.stdout], [], [], SERVE_BOOT_S)
        line = proc.stdout.readline().strip() if ready else ""
        if not line.isdigit():
            fail(f"2o (d): the fake metastore did not start ({line!r})")
        uri = f"thrift://127.0.0.1:{line}"
        t = time.perf_counter()
        v = subprocess.run(
            [sys.executable, "-m", "alluxio_tpu_torch.shell.main",
             "--master", cluster.master_addresses.split(",")[0],
             "validateHms", "-m", uri, "-d", "smoke", "-t", "events"],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        validate_s = time.perf_counter() - t
        if v.returncode != 0 or "hms.tables" not in v.stdout:
            fail(f"2o (d): validateHms exited {v.returncode}: "
                 f"{v.stdout[-1500:]} {v.stderr[-1500:]}")
        tc = TableMasterClient(cluster.master_addresses)
        t = time.perf_counter()
        tc.attach_database("hive", uri, "smoke")
        tables = tc.get_all_tables("smoke")
        table = tc.get_table("smoke", "events")
        attach_s = time.perf_counter() - t
    finally:
        stop_child(proc)
    if tables != ["events"] or table["location"] != "/warehouse/events":
        fail(f"2o (d): attachdb hive lists {tables} at "
             f"{table['location']}")
    t = time.perf_counter()
    got = read_columns(fs, [path], ["a", "b", "c"])
    read_s = time.perf_counter() - t
    launches = 0
    for name in ("a", "b"):
        arr = got.column(name).to_numpy()
        host = torch.from_numpy(arr.copy())
        if device.type == "cuda":
            host = host.pin_memory()
        x = rk.pad_to_kernel_shape(host.to(device))
        n0 = rk.launches
        value = int(rk.scaled_sum(x, 1))
        launches += rk.launches - n0
        plain = int(rk.scaled_sum_reference(x, 1))
        want = wrap32(cols[name].sum(dtype=np.int64))
        if value != plain or value != want:
            fail(f"2o (d): column {name}'s scaled_sum {value}, plain "
                 f"{plain}, numpy {want}")
    c = torch.from_numpy(got.column("c").to_numpy().copy()).to(device)
    if int(c.sum()) != int(cols["c"].sum()):
        fail("2o (d): column c's sum on the card differs from numpy's")
    print(f"2o (d): Hive: a {SERVE_HIVE_ROWS}-row Parquet table "
          f"({len(sink.getvalue())} bytes) written CACHE_THROUGH under "
          f"the mount /warehouse -> {wh} ({write_s:.3f} s); a fake "
          f"metastore (a child) names it at its UFS URI; validateHms "
          f"through the shell exits 0 ({validate_s:.2f} s); attachdb hive "
          f"lists {tables} at {table['location']} ({attach_s:.3f} s); "
          f"columns a, b, c through the planned reader ({read_s:.3f} s) "
          f"onto the card: a's and b's scaled_sum == plain == numpy, c's "
          f"sum == numpy", flush=True)
    return {"rows": SERVE_HIVE_ROWS, "write_s": write_s,
            "validate_s": validate_s, "attach_s": attach_s,
            "read_s": read_s, "launches": launches}


#: (2o e): each role's record in the log server's files: (role, logger,
#: the start of a message), by the FUSE route
SERVE_LOG_RECORDS = (
    ("master", "alluxio_tpu_torch.shell.launch",
     "alluxio-tpu master serving"),
    ("worker", "alluxio_tpu_torch.shell.launch",
     "alluxio-tpu worker serving"),
    ("proxy", "alluxio_tpu_torch.proxy.process", "S3 proxy serving"),
)
SERVE_FUSE_RECORD = {
    "kernel": ("fuse", "alluxio_tpu_torch.fuse.process", "fuse: "),
    "in-process": ("fuse", "alluxio_tpu_torch.shell.launch",
                   "FUSE is unavailable"),
}


def log_records(logs: str) -> dict:
    """role -> whether the log server's files hold its record."""
    text = ""
    if os.path.isdir(logs):
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name), errors="replace") as f:
                text += f.read()
    lines = text.splitlines()
    want = SERVE_LOG_RECORDS + (SERVE_FUSE_RECORD[SERVE_FUSE_ROUTE],)
    return {role: any(f" {logger} [" in line and
                      line.split("] ", 1)[-1].startswith(msg)
                      for line in lines)
            for role, logger, msg in want}


def serving_phase(device, main: dict, h2d_gb_per_s: float) -> dict:
    """(2o): the serving surfaces on a ``MultiProcessCluster`` of their
    own, every role shipping its records to a log server launched by
    the shell; the proxy and FUSE launched by the shell as an operator
    starts them, a fake Hive metastore beside them. (a) the corpus; (b)
    the FUSE leg; (c) the proxy leg; (d) the Hive leg; (e) the log
    server's records, then every role stopped, none left behind. The
    two legs' rates print beside ``h2d_gb_per_s``, the pinned
    host->device ceiling this run measured (2c)."""
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.lint import pytest_lockaudit as pla
    from alluxio_tpu_torch.minicluster.multi_process import (
        ManagedProcess, MultiProcessCluster, free_port,
    )
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    t_phase = time.perf_counter()
    n = SERVE_SHARDS
    tier = (n + 4) * BLOCK_BYTES + (256 << 20)
    base = block_dir(tier + (64 << 20))
    logs = os.path.join(base, "logserver")
    lport, pport = free_port(), free_port()
    mnt = os.path.join(base, "mnt")
    os.makedirs(mnt)
    env = {"ATPU_HOME": base, "ATPU_LOGSERVER_PORT": str(lport),
           "ATPU_LOGSERVER_LOGS_DIR": logs}
    logserver = ManagedProcess("logserver", env,
                               os.path.join(base, "logserver.out"))
    cluster = fs = proxy = fuse = None
    roles = [logserver]
    try:
        logserver.start()
        wait_for("the log server listens", lambda: _accepts(lport))
        cluster = MultiProcessCluster(
            os.path.join(base, "cluster"), num_workers=1, extra_conf={
                Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.name: str(BLOCK_BYTES),
                Templates.WORKER_TIER_DIRS_QUOTA.format(0).name: str(tier),
                "atpu.logserver.hostname": "127.0.0.1",
                "atpu.logserver.port": str(lport)})
        t = time.perf_counter()
        cluster.start(timeout_s=MP_BOOT_S)
        boot_s = time.perf_counter() - t
        fs = cluster.file_system()
        role_env = {**cluster._role_env(),
                    "ATPU_MASTER_RPC_ADDRESSES": cluster.master_addresses,
                    "ATPU_MASTER_RPC_PORT": str(cluster.master_ports[0]),
                    "ATPU_PROXY_WEB_PORT": str(pport),
                    "ATPU_PROXY_S3_ROOT": SERVE_S3_ROOT,
                    "ATPU_FUSE_MOUNT_POINT": mnt,
                    "ATPU_FUSE_FS_ROOT": f"{SERVE_S3_ROOT}/{SERVE_BUCKET}"}
        # (a) the corpus, before the FUSE child lists it
        sums, paths = {}, []
        fs.create_directory(f"{SERVE_S3_ROOT}/{SERVE_BUCKET}",
                            recursive=True, allow_exists=True)
        t = time.perf_counter()
        for i in range(n):
            arr = np.random.default_rng(SEED + 19_000 + i).integers(
                -2**31, 2**31 - 1, size=BLOCK_BYTES // 4, dtype=np.int32)
            path = f"{SERVE_S3_ROOT}/{SERVE_BUCKET}/shard-{i:02d}.bin"
            fs.write_all(path, arr.data, write_type=WriteType.MUST_CACHE)
            sums[path] = wrap32(arr.sum(dtype=np.int64))
            paths.append(path)
        write_s = time.perf_counter() - t
        proxy = ManagedProcess("proxy", role_env,
                               os.path.join(base, "proxy.out"))
        fuse = ManagedProcess("fuse", role_env,
                              os.path.join(base, "fuse.out"))
        roles += [proxy, fuse]
        proxy.start()
        fuse.start()
        print(f"2o (a): a log server (pid {logserver.proc.pid}, port "
              f"{lport}) and a MultiProcessCluster shipping to it, up in "
              f"{boot_s:.2f} s; {n} x {BLOCK_BYTES >> 20} MiB seeded "
              f"shards written MUST_CACHE under "
              f"{SERVE_S3_ROOT}/{SERVE_BUCKET} in {write_s:.3f} s "
              f"({n * BLOCK_BYTES / write_s / 1e9:.3f} GB/s); the proxy "
              f"(pid {proxy.proc.pid}) and the fuse child (pid "
              f"{fuse.proc.pid}) launched by the shell", flush=True)
        wait_for("the proxy answers", lambda: _accepts(pport))
        if SERVE_FUSE_ROUTE == "kernel":
            wait_for("the fuse child mounts", lambda: os.path.ismount(mnt))
        else:
            wait_for("the fuse child exits",
                     lambda: fuse.proc.poll() is not None)
            if fuse.proc.returncode != 1:
                fail(f"2o (b): the fuse child exited "
                     f"{fuse.proc.returncode}, want 1 (no FUSE here)")
        # (b)-(d) under the port's lock-order auditor (this process's
        # locks: the in-process FUSE layer's among them)
        with pla.audited() as auditor:
            rk.launches = 0
            fuse_out = fuse_leg(device, fs, mnt, paths, sums, base, main)
            fuse_out["launches"] = rk.launches
            rk.launches = 0
            proxy_out = proxy_leg(device, fs, pport, paths, sums)
            proxy_out["launches"] = rk.launches
            rk.launches = 0
            hive = hive_leg(device, cluster, fs, base)
            audited = pla.acquired_names()
        inversions = auditor.inversions()
        if inversions:
            fail(f"2o: lock-order inversions {inversions}\n"
                 f"{auditor.report()}")
        must = {"FuseFs._lock", "_OpenFile.lock"} \
            if SERVE_FUSE_ROUTE == "in-process" else set()
        if not must <= set(audited):
            fail(f"2o: the audit saw no acquisition of "
                 f"{sorted(must - set(audited))}")
        if fuse_out["launches"] != n or proxy_out["launches"] != n or \
                hive["launches"] != 2:
            fail(f"2o: scaled_sum launched {fuse_out['launches']} times in "
                 f"(b), {proxy_out['launches']} in (c), "
                 f"{hive['launches']} in (d); want {n}, {n}, 2")
        # (e) every role's records at the log server
        def every_role_logged():
            got = log_records(logs)
            return got if all(got.values()) else None

        seen = wait_for("every role's record at the log server",
                        every_role_logged, timeout_s=15.0)
        files = sorted(os.listdir(logs))
    finally:
        try:
            if fs is not None:
                fs.close()
            for role in (fuse, proxy):
                if role is not None:
                    role.stop()
            if cluster is not None:
                cluster.stop()
                roles += cluster.masters + cluster.workers
        finally:
            logserver.stop()
            mounted = os.path.ismount(mnt)
            shutil.rmtree(base, ignore_errors=True)
    alive = [(r.role, r.proc.pid) for r in roles if r.alive]
    if alive or mounted:
        fail(f"2o (e): {alive} outlived the phase's stop, mount left "
             f"{mounted}")
    s = time.perf_counter() - t_phase
    launches = fuse_out["launches"] + proxy_out["launches"] + \
        hive["launches"]
    print(f"2o: FUSE {fuse_out['gb_per_s']:.3f} GB/s and the proxy "
          f"{proxy_out['gb_per_s']:.3f} GB/s against the pinned "
          f"host->device ceiling {h2d_gb_per_s:.2f} GB/s (2c, this run)",
          flush=True)
    print(f"2o (e): the log server's files {files} hold every role's "
          f"record ({', '.join(seen)}); every role stopped, none left "
          f"behind, no mount left; (b)-(d) audited: {len(audited)} locks, "
          f"{len(auditor.edges)} order edges, no inversion. 2o: {s:.1f} "
          f"s, scaled_sum launched {launches} times", flush=True)
    return {"shards": n, "bytes": n * BLOCK_BYTES, "boot_s": boot_s,
            "write_s": write_s, "fuse": fuse_out, "proxy": proxy_out,
            "hive": hive, "log_files": files,
            "h2d_ceiling_gb_per_s": h2d_gb_per_s,
            "audit": {"locks": audited, "edges": len(auditor.edges),
                      "inversions": 0},
            "launches": launches, "s": s}

# -- 2p: deployment: a YARN-launched cluster fed by the dataset operator ------
#: (d)'s corpus: 16 seeded int32 shards of 32 MiB (512 MiB) in a local UFS
#: directory, mounted read-only by the operator
DEPLOY_SHARDS = 16
DEPLOY_DATASET = "corpus"
DEPLOY_MOUNT = "train"
#: the fake ResourceManager's node hosts: names that resolve on any host
DEPLOY_RM_HOSTS = ("localhost", "127.0.0.1")
#: the operator's reconcile interval (its default is 10 s)
DEPLOY_INTERVAL_S = 0.5
#: the worker's block heartbeat (the default is 1 s), as the process
#: cluster's workers run it, so that a free shows in the used bytes soon
DEPLOY_BLOCK_HEARTBEAT = "200ms"
DEPLOY_BOOT_S = 60.0
DEPLOY_DEADLINE_S = 120.0
#: (f): the worker's used bytes must fall by at least the corpus
DEPLOY_FREED_MIN = DEPLOY_SHARDS * BLOCK_BYTES
#: the fake ResourceManager of ``tests/testutils/fake_yarn.py``, loaded by
#: path in a process of its own: argv is the repository and its hosts
RM_CHILD = r"""
import importlib.util, os, sys, types
root = sys.argv[1]
for name in ("tests", "tests.testutils"):
    sys.modules[name] = types.ModuleType(name)
def load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
load("tests.testutils.httpfake", "tests/testutils/httpfake.py")
fake = load("tests.testutils.fake_yarn", "tests/testutils/fake_yarn.py")
srv = fake.FakeResourceManager(sys.argv[2].split(","))
print(srv.endpoint, flush=True)
srv._server.serve_forever(poll_interval=0.1)
"""
#: the fake Kubernetes API server of ``tests/testutils/fake_k8s.py``,
#: loaded by path in a process of its own, its CRD constants the port's
#: operator's (the fake names JAX's module, which this script never
#: imports); it serves on a thread and takes one JSON command a line on
#: stdin (create, update_spec, delete, get), answering one JSON line each
K8S_CHILD = r"""
import copy, importlib.util, json, os, sys, threading, types
root = sys.argv[1]
sys.path.insert(0, root)
import alluxio_tpu_torch.operator.controller as ctl
for name in ("tests", "tests.testutils", "alluxio_tpu", "alluxio_tpu.operator"):
    sys.modules[name] = types.ModuleType(name)
sys.modules["alluxio_tpu.operator.controller"] = ctl
def load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
load("tests.testutils.httpfake", "tests/testutils/httpfake.py")
fake = load("tests.testutils.fake_k8s", "tests/testutils/fake_k8s.py")
srv = fake.FakeK8sApiServer()
threading.Thread(target=srv._server.serve_forever, args=(0.1,),
                 daemon=True).start()
print(srv.endpoint, flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    op = cmd["op"]
    if op == "create":
        srv.create(cmd["name"], cmd["spec"])
    elif op == "update_spec":
        srv.update_spec(cmd["name"], cmd["spec"])
    elif op == "delete":
        srv.delete(cmd["name"])
    with srv._lock:
        obj = copy.deepcopy(srv.objects.get(cmd["name"]))
    print(json.dumps(obj), flush=True)
"""


def k8s_call(proc, op: str, name: str, spec: "dict | None" = None):
    """One command to the fake API server's child: the CR after it (None
    once the CR is gone)."""
    proc.stdin.write(json.dumps({"op": op, "name": name, "spec": spec})
                     + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        fail(f"2p: the fake API server exited ({proc.stderr.read()[-1500:]})")
    return json.loads(line)


def deploy_env(base: str) -> dict:
    """The environment of 2p's children: the repository on the path, and
    a ``python`` first on ``PATH`` that runs this interpreter (the AM's
    plans run ``python``; a host may have only ``python3``)."""
    shim_dir = os.path.join(ROOT, "build", "deploy_bin")
    os.makedirs(shim_dir, exist_ok=True)
    shim = os.path.join(shim_dir, "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(shim, 0o755)
    env = stress_env()
    env["PATH"] = os.pathsep.join([shim_dir, env.get("PATH", "")])
    env["ATPU_HOME"] = base
    return env


def yarn_cli(env: dict, rm: str, *argv: str) -> str:
    """``python -m alluxio_tpu_torch.yarn --rm rm argv``: its stdout, or
    the run fails unless it exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "alluxio_tpu_torch.yarn", "--rm", rm, *argv],
        capture_output=True, text=True, timeout=60, env=env)
    if proc.returncode != 0:
        fail(f"2p: yarn {' '.join(argv)} exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc.stdout.strip()


def deploy_conf(base: str, mport: int, wport: int, jport: int) -> dict:
    """The ``-C`` keys of the YARN submit: the roles' ports and
    directories of their own under ``base``, the host's name as locality
    (the load plan pairs a job worker, named by the host, with a block
    worker), a MEM tier of the corpus plus 256 MiB."""
    import socket

    tier = DEPLOY_SHARDS * BLOCK_BYTES + (256 << 20)
    return {"atpu.home": base,
            "atpu.master.journal.folder": os.path.join(base, "journal"),
            "atpu.master.rpc.port": str(mport),
            "atpu.master.fastpath.dir": base,
            "atpu.master.safemode.wait": "0s",
            "atpu.job.master.rpc.port": str(jport),
            "atpu.worker.rpc.port": str(wport),
            "atpu.worker.data.folder": os.path.join(base, "worker"),
            "atpu.worker.shm.dir": os.path.join(base, "shm"),
            "atpu.worker.ramdisk.size": f"{tier >> 20}MB",
            "atpu.worker.block.heartbeat.interval": DEPLOY_BLOCK_HEARTBEAT,
            "atpu.locality.identity": f"host={socket.gethostname()}"}


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False


def stop_group(proc) -> None:
    """SIGTERM the process group ``proc`` leads (the AM and the roles it
    launched), then SIGKILL whatever is left after 20 s."""
    import signal

    if proc is None:
        return
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    deadline = time.monotonic() + 20.0
    while _group_alive(proc.pid) and time.monotonic() < deadline:
        proc.poll()
        time.sleep(0.1)
    if _group_alive(proc.pid):
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass


def deploy_epoch(device, fs, paths: list, sums: dict) -> dict:
    """One loader epoch (no device tier) onto ``device`` over ``paths``:
    every block on the SHM rung, each block's ``scaled_sum`` held against
    the plain version and numpy's sum of the UFS file's bytes."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    rfs = RungFS(fs)
    loader = DeviceBlockLoader(rfs, list(paths), device=device, prefetch=2,
                               dtype=np.int32)
    got = {}
    try:
        _sync_device(device)
        t = time.perf_counter()
        for path, block in zip(paths, loader.epoch()):
            x = rk.pad_to_kernel_shape(block)
            value = int(rk.scaled_sum(x, 1))
            plain = int(rk.scaled_sum_reference(x, 1))
            if value != plain or value != sums[path]:
                fail(f"2p (e): {path}'s scaled_sum {value}, plain {plain}, "
                     f"the UFS file's bytes {sums[path]}")
            got[path] = value
        _sync_device(device)
        epoch_s = time.perf_counter() - t
        wait_s = loader.stall_report()["total_wait_s"]
    finally:
        loader.close()
    if list(got) != list(paths):
        fail(f"2p (e): the epoch gave {len(got)} of {len(paths)} blocks")
    rfs.check_rungs("2p (e)", "shm")
    return {"s": epoch_s, "gb_per_s": len(paths) * BLOCK_BYTES / epoch_s
            / 1e9, "wait_s": wait_s, "rungs": dict(rfs.rungs)}


def deployment_phase(device, main: dict) -> dict:
    """(2p): the cluster the port's YARN path stands up, fed by the
    port's dataset operator, read by the loader. (a) a fake RM child and
    ``yarn submit``; (b) the port's AM as a child in its own process
    group launches the master and one worker through
    ``SubprocessLauncher``; (c) a job master and a job worker launched
    through the shell, to which the launched master attaches its
    checkers; (d) a fake K8s API child, one ``Dataset`` CR (a read-only
    mount of 16 seeded 32 MiB shards, ``replicas: 1``, Eager) and the
    operator as a child until the CR is Bound and fully cached; (e) one
    loader epoch onto the card, every block on the SHM rung; (f)
    ``replicas: 0``, then the CR deleted: the worker's used bytes fall
    by the corpus and the CR goes; (g) ``yarn kill``, then the AM's
    group and the job roles stopped, none left. The epoch prints beside
    the main path's epoch 1."""
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.minicluster.multi_process import (
        ManagedProcess, free_port,
    )
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.clients import (
        BlockMasterClient, MetaMasterClient,
    )
    from alluxio_tpu_torch.rpc.job_service import JobMasterClient

    t_phase = time.perf_counter()
    n = DEPLOY_SHARDS
    base = block_dir(2 * n * BLOCK_BYTES + (512 << 20))
    env = deploy_env(base)
    mport, wport, jport = free_port(), free_port(), free_port()
    master = f"localhost:{mport}"
    conf = deploy_conf(base, mport, wport, jport)
    # the master's root UFS, a directory under atpu.home that the master
    # does not make (as a MultiProcessCluster makes it for its roles)
    os.makedirs(os.path.join(base, "underFSStorage"))
    steps = {}
    rm = k8s = am = operator = fs = None
    job_roles = []
    try:
        # (a) the fake RM, and the submit through the port's YARN CLI
        rm, rm_ep = start_http_child("2p", "ResourceManager", RM_CHILD,
                                     ",".join(DEPLOY_RM_HOSTS),
                                     timeout_s=DEPLOY_BOOT_S)
        t = time.perf_counter()
        app_id = yarn_cli(env, rm_ep, "submit", "--name", "atpu-smoke",
                          "--workers", "1",
                          *[a for k, v in conf.items()
                            for a in ("-C", f"{k}={v}")])
        steps["submit"] = time.perf_counter() - t
        state = yarn_cli(env, rm_ep, "status", app_id)
        if state != "ACCEPTED":
            fail(f"2p (a): {app_id} is {state}, want ACCEPTED")
        print(f"2p (a): a fake ResourceManager (pid {rm.pid}, hosts "
              f"{list(DEPLOY_RM_HOSTS)}); yarn submit gave {app_id} "
              f"({state}) in {steps['submit']:.3f} s (a child "
              f"interpreter)", flush=True)
        print(f"2p: cut atpu.worker.block.heartbeat.interval = "
              f"{DEPLOY_BLOCK_HEARTBEAT} (default "
              f"{Keys.WORKER_BLOCK_HEARTBEAT_INTERVAL.default}), the "
              f"operator's --interval = {DEPLOY_INTERVAL_S} s (default "
              f"10 s)", flush=True)
        # (b) the AM, in its own process group with the roles it launches
        am_log = os.path.join(base, "am.log")
        t = time.perf_counter()
        with open(am_log, "ab") as log:
            am = subprocess.Popen(
                [sys.executable, "-m", "alluxio_tpu_torch.yarn.am",
                 "--rm", rm_ep, "--workers", "1",
                 *[a for k, v in conf.items() for a in ("-C", f"{k}={v}")]],
                env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        meta = MetaMasterClient(master, fastpath=False, retry_duration_s=0.5)
        blocks = BlockMasterClient(master, fastpath=False,
                                   retry_duration_s=0.5)

        def master_answers():
            try:
                return meta.get_master_info()
            except Exception:  # noqa: BLE001 - not serving yet
                return None

        def worker_registered():
            try:
                return blocks.get_worker_infos()
            except Exception:  # noqa: BLE001
                return None

        wait_for("(b) the YARN-launched master answers", master_answers,
                 DEPLOY_BOOT_S, "2p")
        steps["master_up"] = time.perf_counter() - t
        workers = wait_for("(b) the YARN-launched worker registers",
                           worker_registered, DEPLOY_BOOT_S, "2p")
        steps["roles_up"] = time.perf_counter() - t
        if [w.address.rpc_port for w in workers] != [wport]:
            fail(f"2p (b): workers {[w.address for w in workers]}, want "
                 f"one on port {wport}")
        print(f"2p (b): the AM (pid {am.pid}, its own process group) "
              f"launched the master ({steps['master_up']:.2f} s to answer) "
              f"and the worker ({steps['roles_up']:.2f} s to register) "
              f"through SubprocessLauncher", flush=True)
        # (c) the job service, launched through the shell
        jenv = {"ATPU_HOME": base, "ATPU_MASTER_HOSTNAME": "localhost",
                "ATPU_MASTER_RPC_PORT": str(mport),
                "ATPU_MASTER_FASTPATH_DIR": base,
                "ATPU_JOB_MASTER_HOSTNAME": "localhost",
                "ATPU_JOB_MASTER_RPC_PORT": str(jport),
                "ATPU_JOB_WORKER_HEARTBEAT_INTERVAL": "100ms",
                "ATPU_LOCALITY_IDENTITY":
                    conf["atpu.locality.identity"]}
        t = time.perf_counter()
        job_roles = [ManagedProcess(role, jenv,
                                    os.path.join(base, f"{role}.out"))
                     for role in ("job-master", "job-worker")]
        for role in job_roles:
            role.start()
        jc = JobMasterClient(f"localhost:{jport}", retry_duration_s=1.0)

        def job_service_attached():
            try:
                if not jc.list_workers():
                    return False
            except Exception:  # noqa: BLE001 - not serving yet
                return False
            return _log_lines(am_log, "persistence scheduler attached") > 0

        wait_for("(c) the job service up and the master's checkers "
                 "attached", job_service_attached, DEPLOY_BOOT_S, "2p")
        steps["job_service"] = time.perf_counter() - t
        print(f"2p (c): a job master and a job worker through the shell, "
              f"the launched master's checkers attached in "
              f"{steps['job_service']:.2f} s", flush=True)
        # (d) the corpus, the fake API server, the CR, the operator
        ufs = os.path.join(base, "ufs")
        os.makedirs(ufs)
        sums, paths = {}, []
        for i in range(n):
            arr = np.random.default_rng(SEED + 20_000 + i).integers(
                -2**31, 2**31 - 1, size=BLOCK_BYTES // 4, dtype=np.int32)
            arr.tofile(os.path.join(ufs, f"shard-{i:02d}.bin"))
            path = (f"/datasets/{DEPLOY_DATASET}/{DEPLOY_MOUNT}/"
                    f"shard-{i:02d}.bin")
            sums[path] = wrap32(arr.sum(dtype=np.int64))
            paths.append(path)
        k8s, k8s_ep = start_http_child("2p", "Kubernetes API server",
                                       K8S_CHILD, timeout_s=DEPLOY_BOOT_S)
        spec = {"mounts": [{"mountPoint": ufs, "name": DEPLOY_MOUNT,
                            "readOnly": True}],
                "replicas": 1, "prefetchStrategy": "Eager"}
        k8s_call(k8s, "create", DEPLOY_DATASET, spec)
        op_log = os.path.join(base, "operator.log")
        t = time.perf_counter()
        with open(op_log, "ab") as log:
            operator = subprocess.Popen(
                [sys.executable, "-m", "alluxio_tpu_torch.operator.controller",
                 "--master", master, "--job-master", f"localhost:{jport}",
                 "--api-server", k8s_ep, "--interval",
                 str(DEPLOY_INTERVAL_S)],
                env=env, stdout=log, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + DEPLOY_DEADLINE_S
        while True:
            status = (k8s_call(k8s, "get", DEPLOY_DATASET) or {}).get(
                "status", {})
            if status.get("phase") == "Bound" and "bound" not in steps:
                steps["bound"] = time.perf_counter() - t
            if status.get("phase") == "Bound" and \
                    status.get("fileCount") == n and \
                    status.get("cachedPercent") == 100:
                steps["cached"] = time.perf_counter() - t
                break
            if operator.poll() is not None:
                fail(f"2p (d): the operator exited {operator.returncode}")
            if time.monotonic() > deadline:
                fail(f"2p (d): the CR's status {status} after "
                     f"{DEPLOY_DEADLINE_S} s")
            time.sleep(0.1)
        if status.get("ufsTotal") != str(n * BLOCK_BYTES):
            fail(f"2p (d): ufsTotal {status.get('ufsTotal')}, want "
                 f"{n * BLOCK_BYTES}")
        print(f"2p (d): the operator (pid {operator.pid}) bound "
              f"{DEPLOY_DATASET} in "
              f"{steps['bound']:.2f} s and its Eager load reached "
              f"cachedPercent 100 in {steps['cached']:.2f} s: {status}",
              flush=True)
        # (e) the card
        fconf = Configuration(load_env=False)
        fconf.set(Keys.MASTER_FASTPATH_DIR, base)
        fs = FileSystem(master, conf=fconf)
        listed = sorted(i.path for i in fs.list_status(
            f"/datasets/{DEPLOY_DATASET}/{DEPLOY_MOUNT}"))
        if listed != paths:
            fail(f"2p (e): the mount lists {listed}")
        block_counts = [len(fs.get_status(p).block_ids) for p in paths]
        if block_counts != [1] * n:
            fail(f"2p (e): blocks a file {block_counts}, want 1 each at "
                 f"the master's default block size")
        rk.launches = 0
        epoch = deploy_epoch(device, fs, paths, sums)
        launches = rk.launches
        if launches != n:
            fail(f"2p (e): scaled_sum launched {launches} times, want {n}")
        print(f"2p (e): one epoch of {n} x {BLOCK_BYTES >> 20} MiB over "
              f"the mount ({sum(block_counts)} blocks, one a file at the "
              f"master's default {Keys.USER_BLOCK_SIZE_BYTES_DEFAULT.default}"
              f" block size), every block on the SHM rung "
              f"{epoch['rungs']}: {epoch['s']:.3f} s, "
              f"{epoch['gb_per_s']:.3f} GB/s, the consumer waiting "
              f"{epoch['wait_s']:.3f} s; the main path's epoch 1 "
              f"{main['epoch1_s']:.3f} s "
              f"({NUM_BLOCKS * BLOCK_BYTES / main['epoch1_s'] / 1e9:.3f} "
              f"GB/s), waiting {main['consumer_wait_s']:.3f} s; "
              f"{launches} launches, each the plain version's and numpy's",
              flush=True)
        # (f) teardown: replicas 0, then the CR deleted
        t = time.perf_counter()
        k8s_call(k8s, "update_spec", DEPLOY_DATASET, dict(spec, replicas=0))
        wait_for("(f) every file's replication_min at 0", lambda: all(
            i.replication_min == 0 for i in fs.list_status(
                f"/datasets/{DEPLOY_DATASET}/{DEPLOY_MOUNT}")),
            DEPLOY_DEADLINE_S, "2p")
        wait_for("(f) every job done", lambda: all(
            j.status in ("COMPLETED", "FAILED", "CANCELED")
            for j in jc.list_jobs()), DEPLOY_DEADLINE_S, "2p")
        used0 = blocks.get_worker_infos()[0].used_bytes
        k8s_call(k8s, "delete", DEPLOY_DATASET)
        wait_for("(f) the CR gone",
                 lambda: k8s_call(k8s, "get", DEPLOY_DATASET) is None,
                 DEPLOY_DEADLINE_S, "2p")

        def freed():
            u = blocks.get_worker_infos()[0].used_bytes
            return used0 - u >= DEPLOY_FREED_MIN and (u,)

        used, = wait_for("(f) the worker's used bytes down by the corpus",
                         freed, DEPLOY_DEADLINE_S, "2p")
        mounts = sorted(m.alluxio_path for m in fs.get_mount_points())
        if any(m.startswith("/datasets") for m in mounts) or \
                fs.exists(f"/datasets/{DEPLOY_DATASET}"):
            fail(f"2p (f): mounts {mounts} after the teardown")
        steps["teardown"] = time.perf_counter() - t
        jobs = jc.list_jobs()
        print(f"2p (f): replicas 0 (every replication_min 0), then the CR "
              f"deleted: unmounted and freed, the worker's used bytes "
              f"{used0} -> {used} ({(used0 - used) / 2**20:.1f} MiB freed), "
              f"the finalizer stripped and the CR gone, in "
              f"{steps['teardown']:.2f} s; load jobs "
              f"{[(j.job_id, j.status) for j in jobs]}", flush=True)
        # (g) the end
        yarn_cli(env, rm_ep, "kill", app_id)
        state = yarn_cli(env, rm_ep, "status", app_id)
        if state != "KILLED":
            fail(f"2p (g): {app_id} is {state} after yarn kill")
    finally:
        try:
            if fs is not None:
                fs.close()
            if operator is not None:
                stop_child(operator)
            if k8s is not None:
                k8s.stdin.close()
                stop_child(k8s)
            for role in reversed(job_roles):
                role.stop()
            stop_group(am)
        finally:
            if rm is not None:
                stop_child(rm)
            shutil.rmtree(base, ignore_errors=True)
    left = [r.role for r in job_roles if r.alive]
    if am is None or _group_alive(am.pid) or left:
        fail(f"2p (g): role processes left: the AM's group "
             f"{am is not None and _group_alive(am.pid)}, job roles {left}")
    s = time.perf_counter() - t_phase
    print(f"2p (g): {app_id} KILLED; the AM's process group and the job "
          f"roles stopped, none left. 2p: {s:.1f} s, scaled_sum launched "
          f"{launches} times", flush=True)
    return {"app_id": app_id, "shards": n, "bytes": n * BLOCK_BYTES,
            "steps_s": steps, "epoch": epoch,
            "main_epoch1_s": main["epoch1_s"],
            "main_consumer_wait_s": main["consumer_wait_s"],
            "freed_bytes": used0 - used, "blocks": sum(block_counts),
            "launches": launches, "s": s}


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
        # the state 2q saves through the cluster (popped before printing)
        out["vit_state"] = {"model": model, "opt": opt, "tx": tx,
                            "cfg": cfg, "step": vit_step, "tokens": tokens,
                            "labels": labels, "at": at}
        print(f"checkpoint: {nbytes} bytes saved in {t1 - t0:.3f} s, "
              f"restored in {t2 - t1:.3f} s, every leaf bit-identical, "
              f"next-step loss {float(loss_a):.6f} on both", flush=True)
    finally:
        loader.close()
    return out


# -- surface phase ------------------------------------------------------------
def _ufs_bytes(ufs_path: str) -> bytes:
    """A file's bytes read straight from the local UFS, not through the
    cluster."""
    local = ufs_path[len("file://"):] if ufs_path.startswith("file://") \
        else ufs_path
    return Path(local).read_bytes()


def _files_under(fs, base: str) -> list:
    out = []
    for info in fs.list_status(base):
        path = f"{base.rstrip('/')}/{info.name}"
        out += _files_under(fs, path) if info.folder else [path]
    return out


def surface_phase(device, mp: dict, main: dict, vit: dict) -> dict:
    """(2q): the parts of the JAX package's public surface that slice 22
    ported and that touch the main path, on 2g's cluster (the main
    path's shards on its worker) with the train phase's ViT state,
    through the package re-exports a JAX program would import. (a) The
    bf16/AdamW state saved with ``save_train_state(write_type=)`` once
    MUST_CACHE and once CACHE_THROUGH; each save loaded back onto the
    card bit for bit, the CACHE_THROUGH files PERSISTED with UFS bytes
    equal to the cluster's, the MUST_CACHE files NOT_PERSISTED, and one
    step from each reloaded state with a finite loss. (b) Tracing on at
    sample rate 1, one of the main path's cached blocks read through the
    striped remote read (short-circuit off, ``REMOTE_STRIPE_BYTES``
    stripes): the client registry's ``to_prometheus()`` must carry the
    read's trace id as an exemplar on a ``Client.ReadLatency`` bucket,
    that id must be the read's span in the tracer, and ``scaled_sum``
    on the card over the block must equal its plain version and numpy's
    sum of the shard file."""
    import math

    import torch

    from alluxio_tpu_torch.client import WriteType
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.models.checkpoint import (load_train_state,
                                                     save_train_state)
    from alluxio_tpu_torch.models.transformer import Transformer
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.utils import tracing
    from alluxio_tpu_torch.utils.bf16 import bits
    from alluxio_tpu_torch.utils.pytree import tree_leaves

    cluster, fs = mp["cluster"], mp["fs"]
    model, opt, tx, cfg = vit["model"], vit["opt"], vit["tx"], vit["cfg"]
    checks, seconds, saves = {}, {}, {}
    t_a = time.perf_counter()
    want = tree_leaves((model.param_tree(), opt))
    for wt in ("MUST_CACHE", "CACHE_THROUGH"):
        base = f"/surface/vit-{wt.lower()}/step-{vit['at']}"
        t0 = time.perf_counter()
        save_train_state(fs, base, model.param_tree(), opt, step=vit["at"],
                         write_type=getattr(WriteType, wt))
        t1 = time.perf_counter()
        fresh = Transformer(cfg, device=device, seed=3)
        params2, opt2, got_at = load_train_state(
            fs, base, like_params=fresh.param_tree(),
            like_opt=tx.init(fresh.leaves()))
        fresh.load_param_tree(params2)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = tree_leaves((fresh.param_tree(), opt2))
        if got_at != vit["at"] or len(got) != len(want) or any(
                b.device != a.device or not torch.equal(bits(a), bits(b))
                for a, b in zip(want, got)):
            fail(f"2q (a) {wt}: the reloaded state (step {got_at}) is not "
                 f"the saved one bit for bit")
        paths = _files_under(fs, base)
        states = {fs.get_status(p).persistence_state for p in paths}
        if wt == "CACHE_THROUGH":
            if states != {"PERSISTED"}:
                fail(f"2q (a) CACHE_THROUGH: persistence states {states}")
            differ = [p for p in paths if _ufs_bytes(
                fs.get_status(p).ufs_path) != bytes(fs.read_all(p))]
            if differ:
                fail(f"2q (a) CACHE_THROUGH: UFS bytes differ for "
                     f"{differ[:3]}")
        elif states != {"NOT_PERSISTED"}:
            fail(f"2q (a) MUST_CACHE: persistence states {states}")
        _, _, loss = vit["step"](fresh, opt2, vit["tokens"], vit["labels"])
        loss = float(loss)
        if not math.isfinite(loss):
            fail(f"2q (a) {wt}: the step from the reloaded state gave loss "
                 f"{loss}")
        nbytes = sum(fs.get_status(p).length for p in paths)
        saves[wt] = {"files": len(paths), "bytes": nbytes,
                     "save_s": t1 - t0, "load_s": t2 - t1,
                     "states": sorted(states), "next_step_loss": loss}
        del fresh, params2, opt2, got
    checks.update({"must_cache_bitwise": True, "must_cache_not_persisted":
                   True, "cache_through_bitwise": True,
                   "cache_through_persisted": True,
                   "cache_through_ufs_equal": True,
                   "reloaded_step_finite": True})
    seconds["a"] = time.perf_counter() - t_a
    print(f"2q (a): ViT state ({saves['MUST_CACHE']['files']} files, "
          f"{saves['MUST_CACHE']['bytes']} bytes) saved MUST_CACHE in "
          f"{saves['MUST_CACHE']['save_s']:.3f} s (NOT_PERSISTED) and "
          f"CACHE_THROUGH in {saves['CACHE_THROUGH']['save_s']:.3f} s "
          f"(PERSISTED, UFS bytes equal); both reload bit for bit, "
          f"next-step loss {saves['MUST_CACHE']['next_step_loss']:.6f} / "
          f"{saves['CACHE_THROUGH']['next_step_loss']:.6f}", flush=True)

    # (b) a sampled striped read of a cached block of the main path
    t_b = time.perf_counter()
    path = next(iter(main["files"]))
    block_file = main["files"][path][1]
    bid = fs.get_status(path).block_ids[0]
    conf = Configuration(load_env=False)
    conf.set(Keys.USER_SHORT_CIRCUIT_ENABLED, False)
    conf.set(Keys.USER_REMOTE_READ_STRIPE_SIZE, REMOTE_STRIPE_BYTES)
    reader = cluster.file_system(conf)
    m = metrics()
    stripes = m.counter("Client.RemoteReadStripes")
    t = tracing.tracer()
    was = (t.enabled, t.sample_rate)
    try:
        t.configure(sample_rate=1.0)
        tracing.set_tracing_enabled(True)
        s0 = stripes.count
        data = bytes(reader.read_all(path))
        n_stripes = stripes.count - s0
    finally:
        tracing.set_tracing_enabled(was[0])
        t.configure(sample_rate=was[1])
        reader.close()
    if n_stripes < 2:
        fail(f"2q (b): the read of {path} took {n_stripes} stripes")
    if data != Path(block_file).read_bytes():
        fail(f"2q (b): {path} read striped differs from its shard file")
    spans = [sp for sp in t.snapshot(limit=5000,
                                     prefix="atpu.client.remote_read")
             if sp.get("tags", {}).get("block_id") == str(bid)]
    if not spans:
        fail(f"2q (b): no remote-read span for block {bid}")
    trace_id = spans[0]["trace_id"]
    text = m.to_prometheus()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("Client_ReadLatency_")
             and f'# {{trace_id="{trace_id}"}}' in ln]
    if not lines:
        fail(f"2q (b): no Client.ReadLatency bucket carries trace "
             f"{trace_id} as its exemplar")
    x = torch.frombuffer(bytearray(data), dtype=torch.int32).to(device)
    rk.launches = 0
    got = int(rk.scaled_sum(x, 3))
    launches = rk.launches
    plain = int(rk.scaled_sum_reference(x, 3))
    total = int((np.frombuffer(data, np.int32).astype(np.int64) * 3)
                .sum()) & 0xFFFFFFFF
    host = total - (1 << 32) if total >= 1 << 31 else total
    if not got == plain == host:
        fail(f"2q (b): scaled_sum {got}, plain {plain}, numpy {host}")
    del x
    checks.update({"exemplar_on_read_latency": True,
                   "exemplar_is_the_reads_span": True,
                   "scaled_sum_equals_plain": True})
    seconds["b"] = time.perf_counter() - t_b
    print(f"2q (b): {path} (block {bid}) read in {n_stripes} stripes, "
          f"trace {trace_id} on {lines[0].split(' #')[0]}, scaled_sum "
          f"{got} == plain == numpy", flush=True)
    return {"checks": checks, "seconds": seconds, "saves": saves,
            "read": {"path": path, "block_id": bid, "stripes": n_stripes,
                     "trace_id": trace_id, "bucket": lines[0].split(
                         " #")[0].split(" ")[0]},
            "launches": launches}


# -- launchers phase (2r) -----------------------------------------------------
LAUNCH_SHARDS = 16         # (b): 2l's corpus, 512 MiB through copyFromLocal
LAUNCH_BOOT_S = 60.0
LAUNCH_CHILD_TIMEOUT_S = 300
LAUNCH_STOP_S = 20.0
LAUNCH_ROLES = ("master", "worker", "job_master", "job_worker")
LAUNCH_EXAMPLES = ("torch_basic_operations.py", "torch_multi_mount.py",
                   "torch_training_pipeline.py")
#: (d): the training pipeline's per-epoch losses on the card against its
#: in-process CPU run, relative: the card's float32 matmuls and
#: reductions sum in another order than the CPU's; both sides print four
#: decimals (half a unit of the last, 5e-5, is well inside)
LAUNCH_LOSS_RTOL = 2e-3
_EPOCH_LINE = re.compile(r"^epoch (\d+): loss ([-\d.]+) in ([\d.]+)s",
                         re.MULTILINE)


def launch_site(base: str, mport: int, wport: int, jport: int) -> str:
    """The cluster's site file: every role's ports (free ones) and
    directories under ``base``, a MEM tier of the corpus plus 256 MiB.
    Returns its path."""
    tier = LAUNCH_SHARDS * BLOCK_BYTES + (256 << 20)
    props = {"atpu.home": base,
             "atpu.master.hostname": "localhost",
             "atpu.master.rpc.port": mport,
             "atpu.master.journal.folder": os.path.join(base, "journal"),
             "atpu.master.fastpath.dir": base,
             "atpu.master.safemode.wait": "0s",
             "atpu.job.master.hostname": "localhost",
             "atpu.job.master.rpc.port": jport,
             "atpu.worker.hostname": "localhost",
             "atpu.worker.rpc.port": wport,
             "atpu.worker.data.folder": os.path.join(base, "worker"),
             "atpu.worker.shm.dir": os.path.join(base, "shm"),
             "atpu.worker.ramdisk.size": f"{tier >> 20}MB",
             # the worker's own default (``<shm dir>/mem``), named so the
             # mount script reports it
             "atpu.worker.tieredstore.level0.dirs.path":
                 os.path.join(base, "shm", "mem")}
    path = os.path.join(base, "site.properties")
    with open(path, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in props.items()))
    return path


def launch_env(base: str, site: str) -> dict:
    """The launchers' environment: the site file, the log and pid
    directories under ``base``, this interpreter as ``PYTHON``."""
    env = stress_env()
    env.update({"ATPU_SITE_PROPERTIES": site,
                "ALLUXIO_TPU_LOGS_DIR": os.path.join(base, "logs"),
                "ALLUXIO_TPU_PID_DIR": os.path.join(base, "pids"),
                "PYTHON": sys.executable})
    return env


def launch_run(env: dict, steps: dict, step: str, argv: list,
               cwd: str = None) -> str:
    """One child (a script under ``bin/`` or an example), its seconds
    added to ``steps[step]``; the run fails unless it exits 0. Returns its
    stdout."""
    t = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          cwd=cwd or str(ROOT),
                          timeout=LAUNCH_CHILD_TIMEOUT_S)
    steps[step] = steps.get(step, 0.0) + time.perf_counter() - t
    if proc.returncode != 0:
        fail(f"2r ({step}): {' '.join(map(str, argv))} exited "
             f"{proc.returncode}: {proc.stdout[-1500:]} "
             f"{proc.stderr[-1500:]}")
    return proc.stdout


def pid_alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie, which no parent has reaped yet,
    has exited)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    return state not in ("Z", "X")


def role_pids(pid_dir: str) -> dict:
    """{role: pid} of the pid files that the start script wrote."""
    pids = {}
    for role in LAUNCH_ROLES:
        path = os.path.join(pid_dir, f"{role}.pid")
        if os.path.exists(path):
            with open(path) as f:
                pids[role] = int(f.read().strip())
    return pids


def kill_left(pids: dict) -> list:
    """SIGKILL whatever of ``pids`` still runs; returns those roles."""
    import signal

    left = [r for r, p in pids.items() if pid_alive(p)]
    for role in left:
        try:
            os.kill(pids[role], signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


def launch_epochs(device, fs, files: dict) -> dict:
    """(c): two loader epochs over the shards onto ``device`` with a device
    tier of them all: every block of epoch 1 on the SHM rung, each block's
    ``scaled_sum`` held against the plain version and numpy's sum of its
    local file in both epochs; epoch 2 must be all device-tier hits."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.metrics import metrics
    from alluxio_tpu_torch.ops import reduce_kernel as rk

    paths = list(files)
    rfs = RungFS(fs)
    hits = metrics().counter("Client.JaxHbmHits")
    loader = DeviceBlockLoader(rfs, paths, device=device,
                               hbm_bytes=len(paths) * BLOCK_BYTES
                               + (64 << 20), prefetch=2, dtype=np.int32)
    out = {}
    try:
        for epoch in (1, 2):
            hits0 = hits.count
            _sync_device(device)
            t = time.perf_counter()
            got = {}
            for path, block in zip(paths, loader.epoch()):
                x = rk.pad_to_kernel_shape(block)
                value = int(rk.scaled_sum(x, 1))
                plain = int(rk.scaled_sum_reference(x, 1))
                if value != plain or value != files[path][1]:
                    fail(f"2r (c) epoch {epoch}: {path}'s scaled_sum "
                         f"{value}, plain {plain}, numpy {files[path][1]}")
                got[path] = value
            _sync_device(device)
            s = time.perf_counter() - t
            if list(got) != paths:
                fail(f"2r (c) epoch {epoch}: {len(got)} of {len(paths)} "
                     f"blocks")
            out[f"epoch{epoch}"] = {
                "s": s, "gb_per_s": len(paths) * BLOCK_BYTES / s / 1e9,
                "device_hits": hits.count - hits0,
                "wait_s": loader.stall_report()["total_wait_s"]}
    finally:
        loader.close()
    rfs.check_rungs("2r (c) epoch 1", "shm")
    if out["epoch2"]["device_hits"] != len(paths):
        fail(f"2r (c): epoch 2 gave {out['epoch2']['device_hits']} "
             f"device-tier hits, want {len(paths)}")
    out["rungs"] = dict(rfs.rungs)
    return out


def epoch_losses(text: str) -> list:
    return [float(m.group(2)) for m in _EPOCH_LINE.finditer(text)]


def launch_examples(device, env: dict, master: str, steps: dict) -> dict:
    """(d): the port's three examples with ``--master`` as children on
    ``device``; the training pipeline's losses against the same example
    run in this process with ``--device cpu`` (its own in-process
    cluster), which runs while the child does."""
    import contextlib
    import io

    outs = {}
    for script in LAUNCH_EXAMPLES[:2]:
        outs[script] = launch_run(
            env, steps, f"d {script[6:-3]}",
            [sys.executable, str(ROOT / "examples" / script),
             "--master", master])
        if not outs[script].rstrip().endswith("done."):
            fail(f"2r (d): {script} did not end in 'done.': "
                 f"{outs[script][-500:]}")
    t = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / LAUNCH_EXAMPLES[2]),
         "--master", master, "--device", device.type],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location(
            "torch_training_pipeline", ROOT / "examples" / LAUNCH_EXAMPLES[2])
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = example.main(["--device", "cpu"])
        steps["d cpu"] = time.perf_counter() - t
        card_text, err = child.communicate(timeout=LAUNCH_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    steps[f"d {LAUNCH_EXAMPLES[2][6:-3]}"] = time.perf_counter() - t
    if child.returncode != 0:
        fail(f"2r (d): {LAUNCH_EXAMPLES[2]} exited {child.returncode}: "
             f"{card_text[-1500:]} {err[-1500:]}")
    card, cpu = epoch_losses(card_text), epoch_losses(buf.getvalue())
    if "loader HBM stats:" not in card_text:
        fail(f"2r (d): no loader HBM stats line: {card_text[-500:]}")
    if rc != 0 or len(cpu) != 3 or len(card) != 3:
        fail(f"2r (d): epochs card {card}, cpu {cpu} (exit {rc})")
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if not all(np.isfinite(card)) or max(rel) > LAUNCH_LOSS_RTOL:
        fail(f"2r (d): the pipeline's losses on {device.type} {card}, on "
             f"the cpu {cpu}: relative {rel} (tolerance "
             f"{LAUNCH_LOSS_RTOL})")
    return {"losses": card, "cpu_losses": cpu, "max_rel": max(rel),
            "epoch_s": [float(m.group(3))
                        for m in _EPOCH_LINE.finditer(card_text)],
            "rtol": LAUNCH_LOSS_RTOL}


def launchers_phase(device, main: dict) -> dict:
    """(2r): a cluster stood up and taken down by the port's own launchers
    under ``bin/``, in a work directory of its own (its site file with
    free ports, its log and pid directories), and read on the card. (a)
    ``bin/alluxio-tpu-torch-start.sh local``: the master must answer and
    the worker register; (b) ``bin/alluxio-tpu-torch fs copyFromLocal``
    of 2l's seeded corpus (``LAUNCH_SHARDS`` 32 MiB shards, made by
    ``shell_corpus``), then ``fsadmin report``,
    each a child interpreter; (c) two loader epochs over the shards onto
    the card, each block's ``scaled_sum`` the plain version's and numpy's,
    epoch 2 all device-tier hits; (d) the port's examples with
    ``--master`` as children on the card (the training pipeline's losses
    within ``LAUNCH_LOSS_RTOL`` of its CPU run in process; the other two
    end in ``done.``); (e) ``bin/alluxio-tpu-torch-mount.sh Check``; (f)
    ``bin/alluxio-tpu-torch-stop.sh all``: no role process left."""
    from alluxio_tpu_torch.client.file_system import FileSystem
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.minicluster.multi_process import free_port
    from alluxio_tpu_torch.ops import reduce_kernel as rk
    from alluxio_tpu_torch.rpc.clients import (
        BlockMasterClient, MetaMasterClient,
    )

    t_phase = time.perf_counter()
    n = LAUNCH_SHARDS
    base = block_dir(2 * n * BLOCK_BYTES + (512 << 20))
    mport, wport, jport = free_port(), free_port(), free_port()
    master = f"localhost:{mport}"
    site = launch_site(base, mport, wport, jport)
    env = launch_env(base, site)
    os.makedirs(os.path.join(base, "underFSStorage"))
    bin_dir = ROOT / "bin"
    steps, pids, stopped = {}, {}, False
    fs = None
    try:
        # (a) the roles, started by the port's start script
        t = time.perf_counter()
        started = launch_run(env, steps, "a",
                             ["bash", str(bin_dir / "alluxio-tpu-torch-start.sh"),
                              "local"])
        pids = role_pids(env["ALLUXIO_TPU_PID_DIR"])
        if sorted(pids) != sorted(LAUNCH_ROLES):
            fail(f"2r (a): pid files for {sorted(pids)}: {started}")
        meta = MetaMasterClient(master, fastpath=False, retry_duration_s=0.5)
        blocks = BlockMasterClient(master, fastpath=False,
                                   retry_duration_s=0.5)

        def master_answers():
            try:
                return meta.get_master_info()
            except Exception:  # noqa: BLE001 - not serving yet
                return None

        def worker_registered():
            try:
                return blocks.get_worker_infos()
            except Exception:  # noqa: BLE001
                return None

        wait_for("(a) the master answers", master_answers, LAUNCH_BOOT_S,
                 "2r")
        workers = wait_for("(a) the worker registers", worker_registered,
                           LAUNCH_BOOT_S, "2r")
        steps["a"] = time.perf_counter() - t
        if [w.address.rpc_port for w in workers] != [wport]:
            fail(f"2r (a): workers {[w.address for w in workers]}, want "
                 f"one on the site file's port {wport}")
        print(f"2r (a): bin/alluxio-tpu-torch-start.sh local started "
              f"{pids}; the master on the site file's port {mport} "
              f"answers and the worker on {wport} registered in "
              f"{steps['a']:.2f} s", flush=True)
        # (b) 2l's corpus in through the launcher, then the report
        files = shell_corpus(os.path.join(base, "corpus"), n, BLOCK_BYTES)
        launch_run(env, steps, "b",
                   ["bash", str(bin_dir / "alluxio-tpu-torch"), "fs",
                    "copyFromLocal", os.path.join(base, "corpus"),
                    "/shell"])
        copy_s = steps["b"]
        report = launch_run(env, steps, "b report",
                            ["bash", str(bin_dir / "alluxio-tpu-torch"),
                             "fsadmin", "report"])
        if f"Master Address: {master}" not in report or \
                "Live Workers: 1" not in report:
            fail(f"2r (b): fsadmin report: {report}")
        print(f"2r (b): copyFromLocal {n} x {BLOCK_BYTES >> 20} MiB in "
              f"{copy_s:.2f} s ({n * BLOCK_BYTES / copy_s / 1e9:.3f} GB/s, "
              f"a child interpreter); fsadmin report in "
              f"{steps['b report']:.2f} s: "
              f"{[line.strip() for line in report.splitlines() if 'Live Workers' in line or 'Used Capacity' in line]}",
              flush=True)
        # (c) the card
        fconf = Configuration(load_env=False)
        fconf.set(Keys.MASTER_FASTPATH_DIR, base)
        fs = FileSystem(master, conf=fconf)
        if [len(fs.get_status(p).block_ids) for p in files] != [1] * n:
            fail("2r (c): want one block a shard")
        rk.launches = 0
        t = time.perf_counter()
        epochs = launch_epochs(device, fs, files)
        steps["c"] = time.perf_counter() - t
        launches = rk.launches
        if launches != 2 * n:
            fail(f"2r (c): scaled_sum launched {launches} times, want "
                 f"{2 * n}")
        e1, e2 = epochs["epoch1"], epochs["epoch2"]
        print(f"2r (c): epoch 1 {e1['s']:.3f} s ({e1['gb_per_s']:.3f} "
              f"GB/s, rungs {epochs['rungs']}, the consumer waiting "
              f"{e1['wait_s']:.3f} s), epoch 2 {e2['s']:.4f} s "
              f"({e2['device_hits']} of {n} device-tier hits); the main "
              f"path's epoch 1 {main['epoch1_s']:.3f} s; {launches} "
              f"launches, each the plain version's and numpy's", flush=True)
        # (d) the examples
        t = time.perf_counter()
        examples = launch_examples(device, env, master, steps)
        steps["d"] = time.perf_counter() - t
        print(f"2r (d): torch_basic_operations and torch_multi_mount ended "
              f"in 'done.'; torch_training_pipeline on {device.type} "
              f"losses {examples['losses']} (epochs "
              f"{examples['epoch_s']} s), in process on the cpu "
              f"{examples['cpu_losses']}: max relative "
              f"{examples['max_rel']:.2e} <= {LAUNCH_LOSS_RTOL}; the children "
              f"{steps['d basic_operations']:.2f}, "
              f"{steps['d multi_mount']:.2f} and "
              f"{steps['d training_pipeline']:.2f} s, the cpu run beside "
              f"the last {steps['d cpu']:.2f} s",
              flush=True)
        # (e) the mount script's report
        check = launch_run(env, steps, "e",
                           ["bash", str(bin_dir / "alluxio-tpu-torch-mount.sh"),
                            "Check"])
        tier = LAUNCH_SHARDS * BLOCK_BYTES + (256 << 20)
        want = (f"tier0 (MEM): {os.path.join(base, 'shm', 'mem')} "
                f"(want {tier} B)")
        if want not in check:
            fail(f"2r (e): mount Check: {check}")
        print(f"2r (e): bin/alluxio-tpu-torch-mount.sh Check: "
              f"{check.splitlines()[0]}", flush=True)
        # (f) the stop script
        fs.close()
        fs = None
        t = time.perf_counter()
        out = launch_run(env, steps, "f",
                         ["bash", str(bin_dir / "alluxio-tpu-torch-stop.sh"),
                          "all"])
        stopped = True
        deadline = time.monotonic() + LAUNCH_STOP_S
        while any(pid_alive(p) for p in pids.values()) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        steps["f"] = time.perf_counter() - t
        left = kill_left(pids)
        if left or role_pids(env["ALLUXIO_TPU_PID_DIR"]):
            fail(f"2r (f): roles {left} outlived stop.sh all ({out})")
        print(f"2r (f): bin/alluxio-tpu-torch-stop.sh all stopped "
              f"{sorted(pids)}, none left, in {steps['f']:.2f} s", flush=True)
    finally:
        try:
            if fs is not None:
                fs.close()
            if pids and not stopped:
                subprocess.run(
                    ["bash", str(bin_dir / "alluxio-tpu-torch-stop.sh"),
                     "all"], env=env, capture_output=True, timeout=60)
                deadline = time.monotonic() + LAUNCH_STOP_S
                while any(pid_alive(p) for p in pids.values()) and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                kill_left(pids)
        finally:
            shutil.rmtree(base, ignore_errors=True)
    s = time.perf_counter() - t_phase
    for step, v in steps.items():
        PHASE_S[f"2r {step}"] = v
    print(f"2r: {s:.1f} s, scaled_sum launched {launches} times", flush=True)
    return {"shards": n, "bytes": n * BLOCK_BYTES, "steps_s": steps,
            "copy_gb_per_s": n * BLOCK_BYTES / copy_s / 1e9,
            "epochs": epochs, "examples": examples, "launches": launches,
            "s": s}


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


def ring_grad_check(device, mesh) -> list:
    """(d) backward: dq, dk and dv of ring_attention over ``data``
    against autograd through reference_attention on the same tensors
    and upstream gradient, with each one's forward-plus-backward time
    and the peak memory above the phase's own."""
    import torch

    from alluxio_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    def ring(q, k, v, *, causal):
        return ring_attention(q, k, v, mesh=mesh, axis="data",
                              causal=causal)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 8)
    total = torch.cuda.get_device_properties(device).total_memory
    out = []
    for shape, dtype in RING_CASES:
        q, k, v, up = (torch.randn(shape, generator=gen, device=device)
                       .to(getattr(torch, dtype)) for _ in range(4))
        for causal in (True, False):
            def fwd_bwd(fn):
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(fn(*qkv, causal=causal), qkv,
                                           up)

            peaks = {}
            for name, fn in (("reference", reference_attention),
                             ("ring", ring)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                grads = fwd_bwd(fn)
                torch.cuda.synchronize()
                peaks[name] = torch.cuda.max_memory_allocated(device) - base
                if name == "reference":
                    want = grads
            case = {"shape": list(shape), "dtype": dtype, "causal": causal,
                    "base_gib": base / 2**30,
                    "peak_gib": {n: b / 2**30 for n, b in peaks.items()},
                    "card_gib": total / 2**30}
            for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    fail(f"ring_attention {name}: {g.dtype} {tuple(g.shape)}"
                         f" != reference {w.dtype} {tuple(w.shape)}")
                err = float((g.float() - w.float()).abs().max())
                scale = float(w.float().abs().max())
                tol = RING_ATOL if dtype == "float32" \
                    else RING_BF16_TOL * scale
                case[name] = {"max_abs_err": err, "max_abs_ref": scale,
                              "tol": tol}
                if not err <= tol:
                    fail(f"ring_attention {list(shape)} {dtype} causal="
                         f"{causal}: {name} differs by {err} from autograd "
                         f"through reference_attention (tolerance {tol})")
            del grads, want
            case["ms"] = time_ms(lambda: fwd_bwd(ring), reps=3, warmup=1)
            case["reference_ms"] = time_ms(
                lambda: fwd_bwd(reference_attention), reps=3, warmup=1)
            out.append(case)
            errs = ", ".join(f"{n} {case[n]['max_abs_err']:.3e} (tolerance "
                             f"{case[n]['tol']:.3e})" for n in
                             ("dq", "dk", "dv"))
            print(f"mesh ring_attention backward {list(shape)} {dtype} "
                  f"causal={causal}: {errs}; forward+backward "
                  f"{case['ms']:.4f} ms, reference {case['reference_ms']:.4f}"
                  f" ms; peak above the phase's {case['base_gib']:.2f} GiB: "
                  f"ring {case['peak_gib']['ring']:.2f}, reference "
                  f"{case['peak_gib']['reference']:.2f} GiB of "
                  f"{case['card_gib']:.1f}", flush=True)
        del q, k, v, up
    return out


def pipeline_check(device, mesh, shape) -> dict:
    """(e): pipeline_apply over a one-stage ``pipe`` axis against the
    stage applied in sequence, bit for bit: the outputs, then the
    gradients of ``w``, ``b`` and the microbatches against the stage's
    own gradients taken microbatch by microbatch in the pipeline's
    reverse order and summed in it (the same ops)."""
    import torch

    from alluxio_tpu_torch.parallel.pipeline import pipeline_apply

    m, rows, d = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    params = {"w": torch.randn((1, d, d), generator=gen, device=device)
              * d ** -0.5,
              "b": torch.randn((1, d), generator=gen, device=device) * 0.1}
    micro = torch.randn(shape, generator=gen, device=device)
    upstream = torch.randn(shape, generator=gen, device=device)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    got = pipeline_apply(stage, params, micro, mesh=mesh)
    want = torch.stack([stage({k: v[0] for k, v in params.items()}, x)
                        for x in micro])
    if not same_bits(got, want):
        fail("pipeline_apply differs from the stage applied in sequence")

    def fwd_bwd():
        leaves = [params["w"].detach().requires_grad_(),
                  params["b"].detach().requires_grad_(),
                  micro.detach().requires_grad_()]
        y = pipeline_apply(stage, dict(zip("wb", leaves[:2])), leaves[2],
                           mesh=mesh)
        return torch.autograd.grad(y, leaves, upstream)

    got = fwd_bwd()
    p0 = {k: v[0].detach().requires_grad_() for k, v in params.items()}
    acc, d_micro = None, [None] * m
    for j in reversed(range(m)):
        x = micro[j].detach().requires_grad_()
        d_micro[j], *g = torch.autograd.grad(stage(p0, x), [x, p0["w"],
                                                            p0["b"]],
                                             upstream[j])
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    want = [acc[0][None], acc[1][None], torch.stack(d_micro)]
    bad = [n for n, a, b in zip(("w", "b", "microbatches"), got, want)
           if not same_bits(a, b)]
    if bad:
        fail(f"pipeline_apply's gradients of {bad} differ from the stage's "
             f"own, microbatch by microbatch")
    ms = time_ms(fwd_bwd, reps=5, warmup=1)
    print(f"mesh pipeline_apply, 1 stage, {m} microbatches of {rows} x {d}: "
          f"outputs and the gradients of w, b and the microbatches "
          f"bit-identical to the stage in sequence; forward+backward "
          f"{ms:.4f} ms", flush=True)
    return {"stages": 1, "microbatches": m, "shape": list(shape),
            "bit_identical": True, "grads_bit_identical": True,
            "forward_backward_ms": ms}


def seq_parallel_check(device, mesh, cfg, batch) -> list:
    """(f): the ViT's loss and every parameter's gradient under
    ``seq_axis="data"`` against the plain ``loss_fn`` on the same
    weights and decoded batch, dense then MoE, with the forward and
    backward timed."""
    import dataclasses

    import torch

    from alluxio_tpu_torch.models.transformer import Transformer, loss_fn

    tokens, labels = batch
    out = []
    for experts in (0, MOE_EXPERTS):
        model = Transformer(dataclasses.replace(cfg, moe_experts=experts),
                            mesh=mesh, seed=0)

        def step(seq_axis):
            loss = loss_fn(model, tokens, labels, seq_axis=seq_axis)
            return loss, torch.autograd.grad(loss, model.leaves())

        (loss_seq, g_seq), (loss_one, g_one) = step("data"), step(None)
        loss_seq, loss_one = loss_seq.item(), loss_one.item()
        loss_err = abs(loss_seq - loss_one)
        worst = 0.0
        for i, (a, b) in enumerate(zip(g_seq, g_one)):
            err = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            worst = max(worst, err / scale if scale else err)
            if a.dtype != b.dtype or not err <= SEQ_TOL * scale:
                fail(f"seq_axis (moe_experts={experts}): gradient leaf {i} "
                     f"differs by {err} (largest {scale}, tolerance "
                     f"{SEQ_TOL} of it) from the plain loss_fn's")
        if not loss_err <= SEQ_LOSS_ATOL:
            fail(f"seq_axis (moe_experts={experts}): loss {loss_seq} != "
                 f"plain {loss_one}")
        del g_seq, g_one
        ms = time_ms(lambda: step("data"), reps=5, warmup=1)
        plain_ms = time_ms(lambda: step(None), reps=5, warmup=1)
        case = {"moe_experts": experts, "tokens": list(tokens.shape),
                "loss": loss_seq, "plain_loss": loss_one,
                "loss_err": loss_err, "leaves": len(model.leaves()),
                "worst_leaf_err_over_max": worst, "tol": SEQ_TOL,
                "forward_backward_ms": ms, "plain_ms": plain_ms}
        out.append(case)
        print(f"mesh seq_axis='data' ViT, moe_experts={experts}, tokens "
              f"{list(tokens.shape)}: loss {case['loss']:.6f} against "
              f"plain {case['plain_loss']:.6f}; {case['leaves']} gradient "
              f"leaves, the worst {worst:.3e} of its largest magnitude "
              f"(tolerance {SEQ_TOL:.3e}); forward+backward {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
    return out


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
        print("mesh backward and sequence parallelism at one rank: no K/V "
              "block, gradient accumulator or activation crosses a link "
              "(the rotations are held at 2 and 4 gloo ranks on the CPU, "
              "tests/test_torch_parallel_grad.py; over NVLink only once "
              "four cards run)", flush=True)
        out["ring_attention_backward"] = phase(
            "mesh d backward", ring_grad_check, device, mesh)
        out["pipeline"] = phase("mesh e", pipeline_check, device,
                                make_mesh({"pipe": 1}), PIPE_SHAPE)
        out["seq_parallel"] = phase("mesh f", seq_parallel_check, device,
                                    mesh, cfg, batches[0])
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
    phase("build", setup)
    kern = phase("kernel", kernel_phase, device,
                 NUM_BLOCKS * BLOCK_BYTES // 4)
    # the block files, the cluster's MEM tier, the records, the page cache
    workdir = block_dir(NUM_BLOCKS * BLOCK_BYTES
                        + (NUM_BLOCKS * BLOCK_BYTES + (256 << 20))
                        + DECODE_BLOCKS * BLOCK_BYTES + PAGE_CACHE_BYTES)
    main = mp = None
    try:
        main = phase("main", main_path, device, workdir, NUM_BLOCKS,
                     BLOCK_BYTES, K)
        shard_files = main["files"]
        prefetch = phase("2a", prefetch_phase, device, main, K)
        master = phase("2d", master_phase, device, main, K)
        suite = {"random_4k": phase("2e #2", suite_random_4k, device, main)}
        # the table read path runs no kernel of the port (JAX's config #4
        # reaches no Pallas kernel): its count is read all the same
        from alluxio_tpu_torch.ops import reduce_kernel as rk
        rk.launches = 0
        suite["projection"] = phase("2e #4", suite_projection, device, main)
        table_launches = rk.launches
        # the cluster's MEM tier leaves /dev/shm before 2e and 2c build
        # their own
        stop_cluster(main)
        suite["prefetch"] = phase("2e #3", suite_prefetch, device, K)
        rk.launches = 0
        suite["projection_real"] = phase("2e #4", suite_projection_real,
                                         device)
        suite["pushdown"] = phase("2e #4", suite_pushdown)
        table_launches += rk.launches
        suite["table_launches"] = table_launches
        suite["write_eviction"] = phase("2e #5", suite_write_eviction, main)
        rk.launches = 0
        clairvoyant = phase("2f", clairvoyant_phase, device)
        clairvoyant["launches"] = rk.launches
        print(f"table path: scaled_sum launched {table_launches} times, "
              f"clairvoyant path {clairvoyant['launches']} (neither has a "
              f"kernel of its own)", flush=True)
        page_cache = phase("2b", page_cache_phase, device, workdir, main)
        worker = phase("2c", worker_phase, device, workdir, main, K)
        # 2g: the main path again, its worker a process of its own; the
        # cluster then serves decode, train and mesh
        mp = phase("2g", start_mp_cluster, NUM_BLOCKS)
        multi = phase("2g", mp_phase, device, mp, main, {
            "cold_write_s": main["cold_write_s"],
            "epoch1_s": main["epoch1_s"],
            "consumer_wait_s": main["consumer_wait_s"],
            "lease_wait_ms": worker["shm_read"]["lease_wait_ms"],
            "shm_map_ms": worker["shm_read"]["shm_map_ms"],
            "metadata_ms": {t: master[t] for t in TRANSPORTS}}, K)
        del main["blocks"]
        files = record_files(workdir, DECODE_BLOCKS, BLOCK_BYTES)
        phase("decode", write_files, mp["fs"], files)
        phase("decode", decode_phase, device, mp["fs"], files,
              DECODE_BLOCKS, BLOCK_BYTES)
        # the train path runs no kernel of the port (the JAX e2e path
        # reaches no Pallas kernel): its count is read all the same
        rk.launches = 0
        train = phase("train", train_phase, device, workdir, mp["fs"],
                      files)
        train["kernel_launches"] = {"scaled_sum": rk.launches}
        print(f"train path: scaled_sum launched {rk.launches} times (the "
              f"path has no kernel of its own)", flush=True)
        # 2q: the surface slice 22 ported, on the cluster that holds the
        # main path's shards, with the train phase's ViT state
        surface = phase("2q", surface_phase, device, mp, main,
                        train.pop("vit_state"))
        # 2r: a cluster of its own, stood up and taken down by the port's
        # launchers under bin/, read on the card, and the port's examples
        launchers = phase("2r", launchers_phase, device, main)
        rk.launches = 0
        mesh = phase("mesh", mesh_phase, device, workdir, mp["fs"],
                     shard_files, files)
        mesh["kernel_launches"] = {"scaled_sum": rk.launches}
        # 2h: the stress CLI and the stressbench job on 2g's cluster, then
        # the master on LSM and the suite on clusters of their own; the
        # path has no kernel of its own, and its count is read all the same
        t_stress = time.perf_counter()
        rk.launches = 0
        stress = {"cli": phase("2h a", stress_cli_phase, mp, workdir),
                  "jobs": phase("2h b", stressbench_phase, mp)}
        stress_launches = rk.launches
        stress_s = time.perf_counter() - t_stress
        # 2l: the operator's shells on 2g's cluster, before it stops
        rk.launches = 0
        shell = phase("2l", shell_phase, device, mp, workdir)
        shell["launches"] = rk.launches
        stop_mp_cluster(mp)
        mp = None
        t_stress = time.perf_counter()
        rk.launches = 0
        stress["lsm"] = phase("2h c", lsm_master_phase,
                              multi["metadata_ms"])
        stress_launches += rk.launches
        stress_s += time.perf_counter() - t_stress
        # 2i: the observability loop on a process cluster of its own
        observability = phase("2i", observability_phase, device, main, K)
        # 2j: the master's guards on a process cluster of its own
        guards = phase("2j", guards_phase, device, main)
        # 2k: master HA on a three-master process cluster of its own
        ha = phase("2k", ha_phase, device, main)
        # 2h d: the suite, once 2h a's and 2k (f)'s lines are there
        t_stress = time.perf_counter()
        rk.launches = 0
        taken = {name: stress["cli"]["rows"][row]["in_process"]
                 for name, (where, row) in SUITE_TAKEN.items()
                 if where == "2h a"}
        taken["ha-failover"] = ha.pop("bench_row")
        host0 = host_load()
        stress["suite"] = phase("2h d", suite_phase, workdir, taken)
        stress["suite"]["host"] = host_load(host0)
        stress["launches"] = stress_launches + rk.launches
        stress["s"] = stress_s + time.perf_counter() - t_stress
        print(f"stress path: scaled_sum launched {stress['launches']} times "
              f"(the path has no kernel of its own); 2h {stress['s']:.1f} s",
              flush=True)
        # 2m: the port's lock-order auditor around the loader, and its
        # lint on this host
        lockaudit = phase("2m", lockaudit_phase, device, main)
        # 2n: a cold epoch from a faked S3 bucket through the port's
        # connectors, and the Arrow and fsspec adapters
        s3 = phase("2n", s3_phase, device, worker)
        # 2o: the serving surfaces (FUSE, the proxy, Hive, the log
        # server) on a process cluster of their own
        serving = phase("2o", serving_phase, device, main,
                        worker["h2d_ceiling"]["32MiB"]["gb_per_s"])
        # 2p: deployment: the cluster the port's YARN path stands up, fed
        # by its dataset operator and read by the loader
        deployment = phase("2p", deployment_phase, device, main)
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
    print(json.dumps({"guards": guards}), flush=True)
    print(json.dumps({"ha": ha}), flush=True)
    print(json.dumps({"shell": shell}), flush=True)
    lint = lockaudit.pop("lint")
    print(json.dumps({"lockaudit": lockaudit}), flush=True)
    print(json.dumps({"lint": {**lint, "card": CARD}}), flush=True)
    print(json.dumps({"s3": {**s3, "card": CARD}}), flush=True)
    print(json.dumps({"serving": {**serving, "card": CARD}}), flush=True)
    print(json.dumps({"deployment": {**deployment, "card": CARD}}),
          flush=True)
    print(json.dumps({"surface": {**surface, "card": CARD}}), flush=True)
    print(json.dumps({"launchers": {**launchers, "card": CARD}}),
          flush=True)
    PHASE_S["total"] = time.perf_counter() - t_start
    print(json.dumps({"phase_s": {k: round(v, 1)
                                  for k, v in PHASE_S.items()}}), flush=True)
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
            "observability": observability["launches"],
            "guards": guards["launches"],
            "ha": ha["launches"],
            "shell": shell["launches"],
            "lockaudit": lockaudit["launches"],
            "s3": s3["launches"],
            "serving": serving["launches"],
            "deployment": deployment["launches"],
            "surface": surface["launches"],
            "launchers": launchers["launches"]},
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
