"""The port's stress benches against the JAX package's, on the CPU.

- ``base.percentiles``, ``drive`` (op counts, bytes, errors) and the
  ``RateLimiter`` (the sleeps it asks for, on a stepped clock) give the
  JAX answers for the same inputs and seeds; ``BenchResult.json_line``
  is the same line;
- ``stress/cluster.py``: ``write_cold_corpus`` leaves a corpus on the UFS
  with no cached copy, in both packages;
- ``write_bench.run`` at a small size passes its checks in both packages
  with equal params, the port's metrics a superset of the JAX ones, every
  file read back right, and a file holding another file's bytes fails;
- ``tpu_suite``'s configs #2, #3, #4 and #5 at small sizes with
  ``device="cpu"`` give rows with the JAX keys (the JAX configs run on
  JAX's CPU device) and pass their checks (config #4's projected columns
  on the device equal the table's); the port's ``run_all`` runs the four
  in the reference's order and lets a raising stage raise;
- ``table_bench.run`` and ``run_pushdown`` at the JAX test's size give
  the JAX params and metric keys, and raise without pyarrow (the JAX
  bench returns a skipped row);
- ``prefetch_bench.run`` at the JAX test's size, and its fault drill at
  JAX's (four workers, replication 2, eviction pressure, a worker killed
  mid-load), give the JAX params and metric keys with every file read
  back equal to its payload; ``run_clairvoyant`` at the JAX defaults
  gives the JAX keys, consumes as many blocks as JAX's for the same seed
  with no miss, and every consumed block equals its file's bytes;
- the worker, master, small-read, cold-UFS, remote-read, metadata,
  observability (tracing, profiler, critical path), health and
  self-healing benches at a toy size give the JAX bench name, params and
  metric keys, the port's with no error (gates relaxed to the mechanics);
  the max-throughput search's ``rounds`` depends on the ops/s each run
  achieves, so it is held to the loop's bounds in both packages instead
  of compared;
- the ``stressbench`` job on each package's ``LocalCluster`` with its job
  service, as JAX's ``TestDistributedStressBench``: two tasks, no error,
  the JAX join's keys, every task's fixtures removed.
"""

import importlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- base ---------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
def test_percentiles_equal(n):
    samples = np.random.default_rng(n).exponential(1e-3, size=n).tolist()
    got = [_mod(pkg, "stress.base").percentiles(list(samples))
           for pkg in PACKAGES]
    assert got[0] == got[1]
    assert set(got[1]) == {"p50_us", "p95_us", "p99_us", "max_us"}


@pytest.mark.parametrize("threads,ops", [(1, 10), (3, 17), (4, 64)])
def test_drive_counts_equal(threads, ops):
    rng = np.random.default_rng(threads * 100 + ops)
    sizes = rng.integers(0, 1 << 20, size=(threads, ops))
    fails = rng.random(size=(threads, ops)) < 0.1

    def op(t, i):
        if fails[t, i]:
            raise RuntimeError("injected")
        return int(sizes[t, i])

    got = []
    for pkg in PACKAGES:
        res = _mod(pkg, "stress.base").drive(threads, op,
                                             ops_per_thread=ops)
        got.append((res.ops, res.bytes, res.errors, len(res.latencies_s)))
    assert got[0] == got[1]
    assert got[1] == (int((~fails).sum()), int(sizes[~fails].sum()),
                      int(fails.sum()), threads * ops)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_drive_needs_a_bound(pkg):
    with pytest.raises(ValueError):
        _mod(pkg, "stress.base").drive(1, lambda t, i: 0)


class _SteppedClock:
    """``time`` for the rate limiter: ``sleep`` advances ``monotonic`` by
    what it was asked, and by 1 ms at least (a float clock would not move
    for the last ulp of a token)."""

    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(round(s, 9))
        self.now += max(s, 1e-3)


@pytest.mark.parametrize("rate", [5.0, 40.0, 1000.0])
def test_rate_limiter_sleeps_equal(rate, monkeypatch):
    got = []
    for pkg in PACKAGES:
        base = _mod(pkg, "stress.base")
        clock = _SteppedClock()
        monkeypatch.setattr(base, "time", clock)
        limiter = base.RateLimiter(rate)
        for _ in range(25):
            limiter.acquire()
        got.append((clock.sleeps, round(clock.now - 100.0, 9)))
    assert got[0] == got[1]
    assert got[1][1] >= 24 / rate * 0.999


def test_bench_result_line_equal():
    kw = dict(bench="b", params={"threads": 2, "x": [1, 2]},
              metrics={"ingest_mb_per_s": 1.5, "p50_us": 3.0}, errors=1,
              duration_s=1.23456)
    lines = [_mod(pkg, "stress.base").BenchResult(**kw).json_line()
             for pkg in PACKAGES]
    assert lines[0] == lines[1]
    assert json.loads(lines[1])["duration_s"] == 1.235


# -- the bench cluster --------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_write_cold_corpus_leaves_no_cached_copy(pkg):
    cluster_mod = _mod(pkg, "stress.cluster")
    payloads = {f"/corpus/f{i}": bytes([i]) * (300 << 10) for i in range(3)}
    with cluster_mod.bench_cluster(
            num_workers=1, block_size=256 << 10,
            worker_mem_bytes=8 << 20, start_worker_heartbeats=True) as (
            fs, cluster):
        cluster_mod.write_cold_corpus(fs, cluster.block_client(), payloads)
        for path, payload in payloads.items():
            st = fs.get_status(path)
            assert st.persisted and st.in_memory_percentage == 0
            assert len(fs.fs_master.get_file_block_info_list(path)) == 2
            with open(st.ufs_path, "rb") as f:
                assert f.read() == payload


# -- write bench --------------------------------------------------------------
SMALL_WRITE = dict(threads=2, num_files=8, file_bytes=1 << 20,
                   mem_bytes=3 << 20, block_size=512 << 10,
                   persist_timeout_s=60.0)


def test_write_bench_small_passes_in_both():
    results = {pkg: _mod(pkg, "stress.write_bench").run(**SMALL_WRITE)
               for pkg in PACKAGES}
    jax, port = results["alluxio_tpu"], results["alluxio_tpu_torch"]
    assert jax.params == port.params
    assert jax.errors == port.errors == 0
    assert jax.metrics["unpersisted"] == port.metrics["unpersisted"] == 0
    assert set(jax.metrics) <= set(port.metrics)
    assert port.metrics["read_back_files"] == SMALL_WRITE["num_files"]
    assert port.metrics["read_back_mismatches"] == 0
    for r in (jax, port):  # memory pressure spilled to the SSD tier
        assert r.metrics["tier_used_bytes"]["SSD"] > 0
    assert json.loads(port.json_line())["bench"] == "write-through-eviction"


def test_write_bench_read_back_tells_files_apart(monkeypatch):
    """Every file carries its own payload, so a file whose UFS bytes are
    another file's fails the read-back (with one payload for every file,
    as the reference writes, it would pass)."""
    from alluxio_tpu_torch.stress import write_bench

    read = write_bench._read_ufs_file
    monkeypatch.setattr(write_bench, "_read_ufs_file", lambda ufs_path:
                        read(ufs_path.replace("f-00000", "f-00001")))
    r = write_bench.run(**SMALL_WRITE)
    assert r.metrics["read_back_files"] == SMALL_WRITE["num_files"]
    assert r.metrics["read_back_mismatches"] == SMALL_WRITE["threads"]
    assert r.errors == SMALL_WRITE["threads"]


# -- the device suite ---------------------------------------------------------
def _jax_cpu():
    import jax

    return jax, jax.devices("cpu")[0]


def test_config2_rows_carry_the_jax_keys(tmp_path):
    from alluxio_tpu.minicluster import LocalCluster as JaxCluster
    from alluxio_tpu.stress import tpu_suite as jax_suite
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.stress import tpu_suite

    kw = dict(shard_bytes=256 << 10, num_shards=2, reads=96, batch=32)
    with JaxCluster(str(tmp_path / "jax"), block_size=1 << 20) as jc:
        fs = jc.file_system()
        jax, dev = _jax_cpu()
        want = jax_suite.config2_random_4k(jax, fs, dev, **kw)
        fs.close()
    with LocalCluster(str(tmp_path / "port"), block_size=1 << 20) as pc:
        fs = pc.file_system()
        got = tpu_suite.config2_random_4k(fs, "cpu", **kw)
        fs.close()
    assert set(want) <= set(got)
    assert (got["config"], got["unit"]) == (want["config"], want["unit"])
    assert got["batches_checked"] == 3
    assert got["value"] > 0 and got["ceiling_mb_per_s"] > 0


def test_config2_checks_the_device_batches(tmp_path, monkeypatch):
    """A batch that differs from the files fails the stage."""
    import torch

    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.stress import tpu_suite

    real = tpu_suite._put

    def corrupt(arr, device):
        t = real(arr, device)
        if arr.ndim == 2:
            t[0, 0] ^= torch.tensor(1, dtype=t.dtype)
        return t

    monkeypatch.setattr(tpu_suite, "_put", corrupt)
    with LocalCluster(str(tmp_path), block_size=1 << 20) as pc:
        fs = pc.file_system()
        with pytest.raises(RuntimeError, match="device batch 0 row 0"):
            tpu_suite.config2_random_4k(fs, "cpu", shard_bytes=64 << 10,
                                        num_shards=2, reads=32, batch=16)
        fs.close()


def test_config3_rows_carry_the_jax_keys():
    from alluxio_tpu.stress import tpu_suite as jax_suite
    from alluxio_tpu_torch.stress import tpu_suite

    jax, dev = _jax_cpu()
    want = jax_suite.config3_prefetch(jax, dev, file_bytes=8 << 20,
                                      num_files=2)
    seen = {}

    def consumer(warm, loaded):
        seen["sets"] = (len(warm), len(loaded))
        return {"equal": all(bool((a == b).all())
                             for a, b in zip(warm, loaded))}

    got = tpu_suite.config3_prefetch("cpu", file_bytes=8 << 20, num_files=2,
                                     consumer=consumer)
    assert set(want) <= set(got)
    assert got["config"] == want["config"]
    assert seen["sets"] == (2, 2)
    assert got["consumer"] == {"equal": True}
    assert got["num_blocks"] == 4
    assert got["blocks_by_host"] == {"localhost-w0": 2, "localhost-w1": 2}


def test_config5_rows_carry_the_jax_keys(monkeypatch):
    import functools

    from alluxio_tpu.stress import tpu_suite as jax_suite
    from alluxio_tpu.stress import write_bench as jax_write_bench
    from alluxio_tpu_torch.stress import tpu_suite

    # the JAX config runs write_bench.run() at its defaults: the same
    # small size for both
    monkeypatch.setattr(jax_write_bench, "run", functools.partial(
        jax_write_bench.run, **SMALL_WRITE))
    want = jax_suite.config5_write_eviction(cold_write_rate=100e6)
    got = tpu_suite.config5_write_eviction(cold_write_rate=100e6,
                                           **SMALL_WRITE)
    assert set(want) <= set(got)
    assert got["config"] == want["config"]
    assert got["unpersisted"] == 0
    assert got["read_back_files"] == SMALL_WRITE["num_files"]
    assert got["tier_used_bytes"]["SSD"] > 0
    assert got["unpressured_cold_write_mb_per_s"] == 100.0


def test_config4_rows_carry_the_jax_keys(tmp_path):
    from alluxio_tpu.minicluster import LocalCluster as JaxCluster
    from alluxio_tpu.stress import tpu_suite as jax_suite
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.stress import tpu_suite

    kw = dict(rows_per_part=3000, partitions=2)
    with JaxCluster(str(tmp_path / "jax"), block_size=1 << 20) as jc:
        fs = jc.file_system()
        jax, dev = _jax_cpu()
        want = jax_suite.config4_projection(jax, fs, dev, **kw)
        fs.close()
    with LocalCluster(str(tmp_path / "port"), block_size=1 << 20) as pc:
        fs = pc.file_system()
        got = tpu_suite.config4_projection(fs, "cpu", **kw)
        fs.close()
    assert set(want) <= set(got)
    assert (got["config"], got["unit"]) == (want["config"], want["unit"])
    # the same seeded table: the same decoded bytes in both packages
    assert got["full_bytes"] == want["full_bytes"]
    assert got["columns_checked"] == 6
    assert got["projected_bytes"] == 2 * 3000 * (4 + 4 + 4)
    assert got["value"] > 0 and got["full_scan_s"] >= 0


def test_config4_checks_the_device_columns(tmp_path, monkeypatch):
    """A projected column that differs on the device fails the stage."""
    import torch

    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.stress import tpu_suite

    real = tpu_suite._put
    puts = []

    def corrupt(arr, device):
        t = real(arr, device)
        puts.append(t)
        if len(puts) == 2:  # partition 0's label column
            t[7] += torch.tensor(1, dtype=t.dtype)
        return t

    monkeypatch.setattr(tpu_suite, "_put", corrupt)
    with LocalCluster(str(tmp_path), block_size=1 << 20) as pc:
        fs = pc.file_system()
        with pytest.raises(RuntimeError,
                           match="column label of /bench/proj-0.parquet"):
            tpu_suite.config4_projection(fs, "cpu", rows_per_part=500)
        fs.close()


def test_run_all_runs_the_three_configs(monkeypatch, tmp_path):
    """Now the four configs, in the reference's order (#4 joined them)."""
    from alluxio_tpu_torch.stress import tpu_suite

    calls = []
    monkeypatch.setattr(tpu_suite, "config2_random_4k",
                        lambda fs, device, **kw: calls.append(
                            ("2", fs, str(device), kw)) or {"config": "2"})
    monkeypatch.setattr(tpu_suite, "config3_prefetch",
                        lambda device, **kw: calls.append(
                            ("3", str(device), kw)) or {"config": "3"})
    monkeypatch.setattr(tpu_suite, "config4_projection",
                        lambda fs, device, **kw: calls.append(
                            ("4", fs, str(device), kw)) or {"config": "4"})
    monkeypatch.setattr(tpu_suite, "config5_write_eviction",
                        lambda **kw: calls.append(("5", kw))
                        or {"config": "5"})
    out = tmp_path / "rows.json"
    rows = tpu_suite.run_all("fs", "cpu", shard_bytes=128 << 20,
                             cold_write_rate=2e9, out_path=str(out))
    assert rows == [{"config": "2"}, {"config": "3"}, {"config": "4"},
                    {"config": "5"}]
    assert calls == [("2", "fs", "cpu", {"shard_bytes": 64 << 20}),
                     ("3", "cpu", {"file_bytes": 32 << 20}),
                     ("4", "fs", "cpu", {}),
                     ("5", {"cold_write_rate": 2e9})]
    assert json.loads(out.read_text()) == rows


STAGES = ("config2_random_4k", "config3_prefetch", "config4_projection",
          "config5_write_eviction")


@pytest.mark.parametrize("stage", STAGES)
def test_run_all_lets_a_failed_stage_raise(stage, monkeypatch):
    """No fallback: the reference logs a failed stage and goes on; the
    port's run_all raises it."""
    from alluxio_tpu_torch.stress import tpu_suite

    ran = []
    for name in STAGES:
        monkeypatch.setattr(tpu_suite, name,
                            lambda *a, _n=name, **k: ran.append(_n)
                            or {"config": _n})

    def boom(*a, **k):
        raise RuntimeError(f"{stage} failed")

    monkeypatch.setattr(tpu_suite, stage, boom)
    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        tpu_suite.run_all("fs", "cpu", shard_bytes=1 << 20,
                          cold_write_rate=1.0)
    assert ran == list(STAGES[:STAGES.index(stage)])


def test_suite_device_defaults_to_the_card(monkeypatch):
    import torch

    from alluxio_tpu_torch.stress import tpu_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_suite.config3_prefetch(file_bytes=1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_suite.run_all("fs", shard_bytes=1 << 20, cold_write_rate=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_suite.config4_projection("fs")
    from alluxio_tpu_torch.stress import prefetch_bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_bench.run_clairvoyant()


# -- the table bench ----------------------------------------------------------
SMALL_TABLE = dict(partitions=2, rows_per_partition=2000, repeats=1)


@pytest.mark.parametrize("bench", ["run", "run_pushdown"])
def test_table_bench_gives_the_jax_params_and_keys(bench):
    results = {pkg: getattr(_mod(pkg, "stress.table_bench"), bench)(
        **SMALL_TABLE) for pkg in PACKAGES}
    jax, port = results["alluxio_tpu"], results["alluxio_tpu_torch"]
    assert (port.bench, port.params) == (jax.bench, jax.params)
    assert set(port.metrics) == set(jax.metrics)
    # the same seeded files, byte for byte
    assert port.metrics["file_bytes"] == jax.metrics["file_bytes"]
    if bench == "run":
        assert jax.errors == port.errors == 0
        assert port.metrics["rows"] == 4000
        assert 0 < port.metrics["byte_selectivity"] < 0.6
    else:
        # the planned path's table equals the legacy path's (the speed
        # gate is the card's: these tiny files fall under its 2x)
        assert port.metrics["byte_identical"] == 1


@pytest.mark.parametrize("bench", ["run", "run_pushdown"])
def test_table_bench_raises_without_pyarrow(bench, monkeypatch):
    """The reference returns a skipped row; the port raises before it
    builds a cluster."""
    import sys

    from alluxio_tpu_torch.stress import table_bench

    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError):
        getattr(table_bench, bench)(**SMALL_TABLE)


# -- the prefetch benches -----------------------------------------------------
def test_prefetch_bench_moves_cold_corpus_in_both():
    kw = dict(num_workers=2, num_files=2, file_bytes=2 << 20,
              block_size=1 << 20)
    results = {pkg: _mod(pkg, "stress.prefetch_bench").run(**kw)
               for pkg in PACKAGES}
    jax, port = results["alluxio_tpu"], results["alluxio_tpu_torch"]
    assert (port.bench, port.params) == (jax.bench, jax.params)
    assert set(jax.metrics) <= set(port.metrics)
    assert jax.errors == port.errors == 0
    for r in (jax, port):
        assert r.metrics["blocks"] == r.metrics["blocks_at_replication"] == 4
    assert port.metrics["read_back_mismatches"] == 0


def test_prefetch_bench_read_back_tells_files_apart(monkeypatch):
    """A file whose bytes are not its payload counts as a mismatch and an
    error."""
    from alluxio_tpu_torch.client.file_system import FileSystem

    real = FileSystem.read_all
    monkeypatch.setattr(FileSystem, "read_all", lambda self, path: (
        b"\0" if path.endswith("f-00001") else real(self, path)))
    from alluxio_tpu_torch.stress import prefetch_bench

    r = prefetch_bench.run(num_workers=1, num_files=2, file_bytes=1 << 20,
                           block_size=1 << 20)
    assert r.metrics["read_back_mismatches"] == 1
    assert r.errors == 1


@pytest.mark.steal_prone
def test_prefetch_fault_drill_end_to_end():
    """JAX's drill (``tests/test_job_service.py::TestTaskFailover::
    test_fault_drill_end_to_end``) on the port: replication 2, eviction
    pressure and a worker killed mid-load; the plan completes, every
    block ends at replication, and every file reads back right. Unlike
    the reference's drill, the count waits until the master has dropped
    the killed worker (lost-worker detection, every second here) and a
    copy counts only on a live worker: the killed worker's copies must
    have come back elsewhere, not merely still be listed."""
    from alluxio_tpu_torch.stress.prefetch_bench import run

    r = run(num_workers=4, num_files=8, file_bytes=8 << 20,
            block_size=4 << 20, replication=2, pressure=True,
            kill_worker=True)
    assert r.errors == 0
    assert r.metrics["blocks_at_replication"] == r.metrics["blocks"]
    assert r.metrics["evicted_filler_files"] > 0
    assert r.metrics["killed_mid_job"] is True
    assert r.metrics["read_back_mismatches"] == 0
    assert r.params["worker_killed"] is True
    assert r.metrics["detection_wait_s"] > 0


def test_clairvoyant_bench_matches_jax():
    """At the JAX defaults and seed: the same params and metric keys
    (the port's a superset), the same blocks consumed with no miss, and
    every consumed block equal to its file's bytes. Hits and late
    arrivals split by the agent's live heartbeat thread, so their split
    is not held equal, their sum is."""
    from alluxio_tpu.stress import prefetch_bench as jax_bench
    from alluxio_tpu_torch.stress import prefetch_bench

    want = jax_bench.run_clairvoyant()
    got = prefetch_bench.run_clairvoyant(device="cpu")
    assert got.params == want.params
    assert set(want.metrics) <= set(got.metrics)
    for r in (want, got):
        assert r.metrics["misses"] == 0 and r.errors == 0
    assert got.metrics["hits"] + got.metrics["late"] == \
        want.metrics["hits"] + want.metrics["late"] == 64
    assert got.metrics["blocks_per_epoch"] == \
        want.metrics["blocks_per_epoch"] == 32
    assert got.metrics["blocks_checked"] == 64
    assert got.metrics["block_mismatches"] == 0


def test_clairvoyant_bench_checks_the_blocks(monkeypatch):
    """A consumed block that differs from its file fails the check."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.stress import prefetch_bench

    real = DeviceBlockLoader.epoch

    def epoch(self):
        for i, block in enumerate(real(self)):
            if i == 5:
                block = block.clone()
                block[0] ^= 1
            yield block

    monkeypatch.setattr(DeviceBlockLoader, "epoch", epoch)
    r = prefetch_bench.run_clairvoyant(device="cpu", num_files=2,
                                       epochs=1)
    assert r.metrics["block_mismatches"] == 1
    assert r.errors == 1


# -- the worker, master and host benches ---------------------------------------
#: each bench at a toy size (well under a second of measuring, a few MiB),
#: its gate, where it has one, relaxed to the mechanics: the card's run
#: holds the rows to their own gates
TOY_BENCHES = {
    "worker-random": ("worker_bench", "run", dict(
        mode="random", threads=2, duration_s=0.3, shard_bytes=2 << 20,
        num_shards=2)),
    "worker-sequential": ("worker_bench", "run", dict(
        mode="sequential", threads=2, duration_s=0.3, shard_bytes=8 << 20,
        num_shards=2)),
    **{f"master-{op}": ("master_bench", "run", dict(
        op=op, threads=2, duration_s=0.3, fixed_count=20))
       for op in ("CreateFile", "GetStatus", "ListStatus",
                  "ListStatusStream", "DeleteFile", "RenameFile")},
    "master-maxthroughput": ("master_bench", "run_max_throughput", dict(
        op="GetStatus", threads=2, duration_s=0.2, fixed_count=10)),
    "smallread-batch": ("smallread_bench", "run_batch", dict(
        file_mb=1, ops=100, min_speedup=0.0)),
    "smallread-shm": ("smallread_bench", "run_shm", dict(file_mb=1, ops=50)),
    "smallread-native": ("smallread_bench", "run_native", dict(
        file_mb=1, ops=200, min_speedup=0.0)),
    "ufs-cold-read": ("ufs_cold_bench", "run", dict(
        block_mb=1, stripe_kb=256, blocks_per_reader=1, rtt_ms=5.0,
        conn_mbps=64.0, min_speedup=0.0)),
    "remote-warm-read": ("remote_read_bench", "run", dict(
        block_mb=1, stripe_kb=256, blocks=2, rtt_ms=10.0, conn_mbps=64.0,
        stall_ms=200.0, min_speedup=0.0)),
    **{f"metadata-{row}": ("metadata_bench", "run", dict(
        row=row, threads=2, duration_s=0.3, min_speedup=0.0))
       for row in ("striped", "journal", "hot-dir")},
    "metadata-cached": ("metadata_bench", "run", dict(
        row="cached", threads=2, duration_s=0.3, files=8, min_speedup=0.0)),
    "obs-tracing-overhead": ("obs_bench", "run", dict(
        file_mb=1, reads=5, batches=2, span_iterations=1000,
        max_overhead_pct=1e9)),
    "obs-profile-overhead": ("obs_bench", "run_profile_overhead", dict(
        file_mb=1, reads=5, batches=2, sample_interval_ms=5,
        max_overhead_pct=1e9)),
    "obs-critical-path": ("obs_bench", "run_critical_path", dict(
        file_mb=1, reads=20, min_attributed_pct=0.0)),
    "health-ingest-overhead": ("health_bench", "run", dict(
        sources=4, metrics_per_source=10, ticks=4, batches=2,
        max_overhead_pct=1e9)),
    "selfheal-remediation": ("selfheal_bench", "run", dict(
        sources=8, ticks=10, batches=2, max_overhead_pct=1e9)),
}

#: the max-throughput search's step cap (``master_bench.py``'s loop)
MAX_THROUGHPUT_ROUNDS = 8


@pytest.mark.parametrize("name", sorted(TOY_BENCHES))
def test_bench_gives_the_jax_params_and_keys(name):
    module, fn, kw = TOY_BENCHES[name]
    results = {pkg: getattr(_mod(pkg, f"stress.{module}"), fn)(**dict(kw))
               for pkg in PACKAGES}
    jax, port = results["alluxio_tpu"], results["alluxio_tpu_torch"]
    assert port.errors == 0, port.json_line()
    if name == "master-maxthroughput":
        # the binary search's step count follows the ops/s each run
        # achieves: bounded, not compared
        rounds = {pkg: r.params.pop("rounds") for pkg, r in results.items()}
        assert all(1 <= n <= MAX_THROUGHPUT_ROUNDS
                   for n in rounds.values()), rounds
    assert (port.bench, port.params) == (jax.bench, jax.params)
    assert set(port.metrics) == set(jax.metrics)
    headline = [k for k in ("ops_per_s", "mb_per_s", "gb_per_s",
                            "batched_ops_per_s", "native_ops_per_s",
                            "reads_per_s", "striped_batched_ops_per_s",
                            "edge_lock_ops_per_s", "cached_ops_per_s",
                            "max_sustained_ops_per_s", "spans_per_s",
                            "samples", "traces_analyzed",
                            "drain_samples_per_s", "eval_on_us")
                if k in port.metrics]
    assert headline and all(port.metrics[k] > 0 for k in headline)


def test_worker_bench_reuse_fs_cleans_up():
    """The stressbench job's mode: the bench runs through a given client
    under its base path and removes that path afterwards."""
    from alluxio_tpu_torch.stress import worker_bench
    from alluxio_tpu_torch.stress.cluster import bench_cluster

    with bench_cluster(block_size=1 << 20,
                       worker_mem_bytes=32 << 20) as (fs, _cluster):
        r = worker_bench.run(mode="random", threads=1, duration_s=0.2,
                             shard_bytes=1 << 20, num_shards=2,
                             base_path="/dist/t0", _reuse_fs=fs)
        assert r.errors == 0 and r.metrics["ops_per_s"] > 0
        assert not fs.exists("/dist/t0")


# -- the stressbench job ---------------------------------------------------------
@pytest.mark.parametrize("bench", ["worker", "master"])
def test_stressbench_fans_out_over_job_workers(tmp_path, bench):
    """JAX's ``TestDistributedStressBench`` on both packages' clusters:
    the plan runs the bench on every job worker against the live cluster
    through the job worker's own client, and joins the same keys."""
    config = {"type": "stressbench", "bench": bench,
              "options": {"mode": "random", "threads": 2,
                          "duration_s": 1.0, "shard_bytes": 2 << 20,
                          "num_shards": 1} if bench == "worker" else
              {"op": "GetStatus", "threads": 2, "duration_s": 0.5,
               "fixed_count": 20}}
    results = {}
    for pkg in PACKAGES:
        keys = _mod(pkg, "conf").Keys
        status = _mod(pkg, "job.wire").Status
        with _mod(pkg, "minicluster.local_cluster").LocalCluster(
                str(tmp_path / pkg), num_workers=2, start_job_service=True,
                start_worker_heartbeats=True, conf_overrides={
                    keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms"}) as c:
            jc = c.job_client()
            info = jc.wait_for_job(jc.run(dict(config)), timeout_s=120.0)
            assert info.status == status.COMPLETED, info.error_message
            results[pkg] = info.result
            fs = c.file_system()
            try:  # each task removed its fixtures
                assert not fs.exists("/stress-dist/t0")
            finally:
                fs.close()
    jax, port = results["alluxio_tpu"], results["alluxio_tpu_torch"]
    assert port["tasks"] == jax["tasks"] == 2
    assert port["errors"] == 0
    assert (port["bench"], set(port["metrics"])) == \
        (jax["bench"], set(jax["metrics"]))
    assert port["metrics"]["ops_per_s"] > 0
    if bench == "worker":
        assert port["metrics"]["mb_per_s"] > 0
