"""bench-metadata: metadata control-plane scale-out gates (a copy of
``alluxio_tpu/stress/metadata_bench.py``).

Five suite rows, the ratios against the pre-PR configuration:

- ``metadata-striped`` — mixed CreateFile/GetStatus/ListStatus/Delete
  across disjoint per-thread subtrees, striped inode locking + journal
  group commit vs the single tree-wide lock with inline fsync (the
  pre-PR master).  Gate: >= 3x ops/s.
- ``metadata-journal-batch`` — CreateFile-only under the same
  comparison, isolating the durability path.  Gate: >= 1.5x.
- ``metadata-cached-getstatus`` — warm client-metadata-cache GetStatus
  vs the uncached RPC round trip on a live in-process cluster.
  Gate: >= 10x.
- ``metadata-hot-dir`` — CreateFile with EVERY thread targeting ONE
  shared directory (the hot-directory worst case striping cannot
  help): WRITE_EDGE locking vs write-locking the shared parent inode,
  both sides striped + group commit.  Gate: >= 2x ops/s.
- ``metadata-lsm-capacity`` — builds, walks and random-stats a large
  namespace in a subprocess running under an enforced address-space
  cap (``resource.setrlimit``): the HEAP backend must BLOW the cap
  and the LSM backend must complete under it with every lookup
  served.  Gate: LSM ok AND HEAP out-of-memory.

The journal rides a **modeled slow fsync** (``--fsync-ms``, default
3ms — local-disk/NFS class): on tmpfs-backed CI an fsync is nearly
free, which would understate exactly the serialization the pre-PR
master suffers on real media.  The model follows the established
bench practice here (connection-limited worker/UFS models in
bench-remote-read / bench-ufs-cold).  Gates are RATIOS with wide
margins, so scheduler jitter moves both sides together.
"""

from __future__ import annotations

import itertools
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

from alluxio_tpu_torch.journal.system import LocalJournalSystem
from alluxio_tpu_torch.stress.base import BenchResult, drive, percentiles


class _SlowFsyncJournal(LocalJournalSystem):
    """LocalJournalSystem whose fsync costs ``fsync_s`` extra — the
    disk model.  Counts fsyncs so batching is observable."""

    def __init__(self, folder: str, fsync_s: float, **kw) -> None:
        super().__init__(folder, **kw)
        self.fsync_s = fsync_s
        self.fsync_count = 0

    def _fsync(self, fd: int) -> None:
        self.fsync_count += 1
        if self.fsync_s > 0:
            time.sleep(self.fsync_s)
        os.fsync(fd)


class _Master:
    """An in-process FileSystemMaster + journal, pre-PR (coarse +
    inline fsync) or post-PR (striped + group commit) flavor."""

    def __init__(self, base: str, *, coarse: bool, batched: bool,
                 fsync_s: float, batch_time_s: float,
                 edge_locking: bool = True) -> None:
        from alluxio_tpu_torch.master.block_master import BlockMaster
        from alluxio_tpu_torch.master.file_master import FileSystemMaster

        self.journal = _SlowFsyncJournal(base, fsync_s)
        self.journal.start()
        self.journal.gain_primacy()
        if batched:
            self.journal.start_group_commit(batch_time_s)
        self.block_master = BlockMaster(self.journal)
        self.fsm = FileSystemMaster(self.block_master, self.journal,
                                    coarse_locking=coarse,
                                    edge_locking=edge_locking)
        self.fsm.start(None)

    def close(self) -> None:
        self.fsm.stop()
        self.journal.stop()


def _mixed_body(fsm, threads: int):
    """Per-thread cycle over its own subtree: create -> stat -> list ->
    delete.  Disjoint subtrees are the training-shard common case the
    striping targets."""
    for t in range(threads):
        fsm.create_directory(f"/t{t}", recursive=True, allow_exists=True)
    counters = [itertools.count() for _ in range(threads)]

    def body(t: int, i: int) -> int:
        j = next(counters[t])
        seq, phase = j // 4, j % 4
        if phase == 0:
            fsm.create_file(f"/t{t}/x-{seq:08d}")
        elif phase == 1:
            fsm.get_status(f"/t{t}/x-{seq:08d}")
        elif phase == 2:
            fsm.list_status(f"/t{t}")
        else:
            fsm.delete(f"/t{t}/x-{seq:08d}")
        return 0

    return body


def _create_body(fsm, threads: int):
    for t in range(threads):
        fsm.create_directory(f"/t{t}", recursive=True, allow_exists=True)
    counters = [itertools.count() for _ in range(threads)]

    def body(t: int, i: int) -> int:
        fsm.create_file(f"/t{t}/c-{next(counters[t]):09d}")
        return 0

    return body


def _run_mode(make_body, *, coarse: bool, batched: bool, threads: int,
              duration_s: float, fsync_s: float, batch_time_s: float,
              edge_locking: bool = True):
    base = tempfile.mkdtemp(prefix="atpu_mdbench_")
    master = _Master(base, coarse=coarse, batched=batched,
                     fsync_s=fsync_s, batch_time_s=batch_time_s,
                     edge_locking=edge_locking)
    try:
        body = make_body(master.fsm, threads)
        res = drive(threads, body, duration_s=duration_s)
        return res, master.journal.fsync_count
    finally:
        master.close()
        shutil.rmtree(base, ignore_errors=True)


def _ratio_row(bench: str, make_body, *, threads: int, duration_s: float,
               fsync_ms: float, batch_time_ms: float,
               min_speedup: float) -> BenchResult:
    t_start = time.monotonic()
    fsync_s, batch_s = fsync_ms / 1e3, batch_time_ms / 1e3
    base_res, base_fsyncs = _run_mode(
        make_body, coarse=True, batched=False, threads=threads,
        duration_s=duration_s, fsync_s=fsync_s, batch_time_s=batch_s)
    new_res, new_fsyncs = _run_mode(
        make_body, coarse=False, batched=True, threads=threads,
        duration_s=duration_s, fsync_s=fsync_s, batch_time_s=batch_s)
    speedup = new_res.ops_per_s / base_res.ops_per_s \
        if base_res.ops_per_s > 0 else 0.0
    ok = speedup >= min_speedup and base_res.errors == 0 and \
        new_res.errors == 0
    if not ok:
        print(f"[{bench}] speedup {speedup:.2f}x below the "
              f"{min_speedup}x gate (baseline "
              f"{base_res.ops_per_s:.0f} ops/s, striped+batched "
              f"{new_res.ops_per_s:.0f} ops/s, errors "
              f"{base_res.errors}+{new_res.errors})", file=sys.stderr)
    return BenchResult(
        bench=bench,
        params={"threads": threads, "duration_s": duration_s,
                "fsync_ms": fsync_ms, "batch_time_ms": batch_time_ms,
                "min_speedup": min_speedup},
        metrics={"baseline_ops_per_s": round(base_res.ops_per_s, 1),
                 "striped_batched_ops_per_s": round(new_res.ops_per_s, 1),
                 "speedup": round(speedup, 3),
                 "baseline_fsyncs": base_fsyncs,
                 "striped_fsyncs": new_fsyncs,
                 "baseline_" + "p99_us":
                     percentiles(base_res.latencies_s)["p99_us"],
                 "striped_p99_us":
                     percentiles(new_res.latencies_s)["p99_us"],
                 "gate_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def run_striped(*, threads: int = 8, duration_s: float = 2.0,
                fsync_ms: float = 3.0, batch_time_ms: float = 2.0,
                min_speedup: float = 3.0) -> BenchResult:
    return _ratio_row("metadata-striped", _mixed_body, threads=threads,
                      duration_s=duration_s, fsync_ms=fsync_ms,
                      batch_time_ms=batch_time_ms, min_speedup=min_speedup)


def run_journal_batch(*, threads: int = 8, duration_s: float = 2.0,
                      fsync_ms: float = 3.0, batch_time_ms: float = 2.0,
                      min_speedup: float = 1.5) -> BenchResult:
    return _ratio_row("metadata-journal-batch", _create_body,
                      threads=threads, duration_s=duration_s,
                      fsync_ms=fsync_ms, batch_time_ms=batch_time_ms,
                      min_speedup=min_speedup)


def run_cached_getstatus(*, master: Optional[str] = None, threads: int = 4,
                         duration_s: float = 1.5, files: int = 64,
                         min_speedup: float = 10.0) -> BenchResult:
    """Warm client-cache GetStatus vs the uncached RPC round trip on a
    live (in-process by default) cluster."""
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.stress.cluster import bench_cluster

    t_start = time.monotonic()
    with bench_cluster(master, block_size=1 << 20,
                       worker_mem_bytes=64 << 20,
                       conf_overrides={
                           Keys.USER_METADATA_CACHE_ENABLED: True,
                       }) as (fs, _cluster):
        from alluxio_tpu_torch.client.streams import WriteType

        base = "/md-cache-bench"
        fs.create_directory(base, recursive=True, allow_exists=True)
        paths = [f"{base}/f-{i:04d}" for i in range(files)]
        for p in paths:
            fs.write_all(p, b"", write_type=WriteType.MUST_CACHE)

        def uncached(t: int, i: int) -> int:
            fs.fs_master.get_status(paths[i % files])
            return 0

        cold = drive(threads, uncached, duration_s=duration_s)
        for p in paths:  # warm the cache
            fs.get_status(p)
        hits0 = fs._md_hits.count

        def cached(t: int, i: int) -> int:
            fs.get_status(paths[i % files])
            return 0

        warm = drive(threads, cached, duration_s=duration_s)
        hits = fs._md_hits.count - hits0
        try:
            fs.delete(base, recursive=True)
        except Exception:  # noqa: BLE001 cleanup is best-effort
            pass
    speedup = warm.ops_per_s / cold.ops_per_s if cold.ops_per_s else 0.0
    # the warm pass must have been served by the CACHE, not by fast RPCs
    ok = speedup >= min_speedup and hits >= warm.ops and \
        cold.errors == 0 and warm.errors == 0
    if not ok:
        print(f"[metadata-cached-getstatus] speedup {speedup:.2f}x "
              f"(gate {min_speedup}x), cache hits {hits}/{warm.ops}, "
              f"errors {cold.errors}+{warm.errors}", file=sys.stderr)
    return BenchResult(
        bench="metadata-cached-getstatus",
        params={"threads": threads, "duration_s": duration_s,
                "files": files, "min_speedup": min_speedup,
                "master": master or "in-process"},
        metrics={"uncached_ops_per_s": round(cold.ops_per_s, 1),
                 "cached_ops_per_s": round(warm.ops_per_s, 1),
                 "speedup": round(speedup, 3),
                 "cache_hits": hits,
                 "uncached_p99_us": percentiles(cold.latencies_s)["p99_us"],
                 "cached_p99_us": percentiles(warm.latencies_s)["p99_us"],
                 "gate_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def _hot_dir_body(fsm, threads: int):
    """Every thread creates in ONE shared directory — disjoint names,
    shared parent.  Striping is useless here (all paths hash to the
    parent's stripe); only WRITE_EDGE locking lets the siblings'
    journal-fsync waits overlap."""
    fsm.create_directory("/hot", recursive=True, allow_exists=True)
    counters = [itertools.count() for _ in range(threads)]

    def body(t: int, i: int) -> int:
        fsm.create_file(f"/hot/t{t}-{next(counters[t]):09d}")
        return 0

    return body


def run_hot_dir(*, threads: int = 8, duration_s: float = 2.0,
                fsync_ms: float = 3.0, batch_time_ms: float = 2.0,
                min_speedup: float = 2.0) -> BenchResult:
    """WRITE_EDGE vs parent-inode write locking under a single hot
    directory.  BOTH sides run striped + group commit — the ratio
    isolates the edge-locking change, not the striping PR."""
    t_start = time.monotonic()
    fsync_s, batch_s = fsync_ms / 1e3, batch_time_ms / 1e3
    base_res, base_fsyncs = _run_mode(
        _hot_dir_body, coarse=False, batched=True, threads=threads,
        duration_s=duration_s, fsync_s=fsync_s, batch_time_s=batch_s,
        edge_locking=False)
    new_res, new_fsyncs = _run_mode(
        _hot_dir_body, coarse=False, batched=True, threads=threads,
        duration_s=duration_s, fsync_s=fsync_s, batch_time_s=batch_s,
        edge_locking=True)
    speedup = new_res.ops_per_s / base_res.ops_per_s \
        if base_res.ops_per_s > 0 else 0.0
    ok = speedup >= min_speedup and base_res.errors == 0 and \
        new_res.errors == 0
    if not ok:
        print(f"[metadata-hot-dir] speedup {speedup:.2f}x below the "
              f"{min_speedup}x gate (parent-inode-lock "
              f"{base_res.ops_per_s:.0f} ops/s, edge-lock "
              f"{new_res.ops_per_s:.0f} ops/s, errors "
              f"{base_res.errors}+{new_res.errors})", file=sys.stderr)
    return BenchResult(
        bench="metadata-hot-dir",
        params={"threads": threads, "duration_s": duration_s,
                "fsync_ms": fsync_ms, "batch_time_ms": batch_time_ms,
                "min_speedup": min_speedup},
        metrics={"inode_lock_ops_per_s": round(base_res.ops_per_s, 1),
                 "edge_lock_ops_per_s": round(new_res.ops_per_s, 1),
                 "speedup": round(speedup, 3),
                 "inode_lock_fsyncs": base_fsyncs,
                 "edge_lock_fsyncs": new_fsyncs,
                 "inode_lock_p99_us":
                     percentiles(base_res.latencies_s)["p99_us"],
                 "edge_lock_p99_us":
                     percentiles(new_res.latencies_s)["p99_us"],
                 "gate_ok": ok},
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def _capacity_child() -> None:
    """Subprocess body for ``metadata-lsm-capacity``: build a
    ``fanout``-wide directory namespace straight into one metastore
    backend under an enforced ``RLIMIT_AS`` cap, then walk every edge
    and random-stat a sample.  argv (after ``-c``): kind dir inodes
    cap_bytes fanout sample seed.  Prints one JSON line; blowing the
    cap is an expected outcome and reported as ``oom`` (or, when even
    the handler cannot allocate, as a nonzero exit the parent treats
    the same way)."""
    import gc
    import json
    import random
    import resource

    kind, directory = sys.argv[1], sys.argv[2]
    total, cap = int(sys.argv[3]), int(sys.argv[4])
    fanout, sample, seed = (int(sys.argv[5]), int(sys.argv[6]),
                            int(sys.argv[7]))
    resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
    from alluxio_tpu_torch.master.inode import Inode
    from alluxio_tpu_torch.master.metastore import create_inode_store

    out = {"kind": kind, "ok": False, "oom": False, "built": 0}
    store = None
    built, next_id = 0, 1
    try:
        store = create_inode_store(kind, directory)
        t0 = time.monotonic()
        dir_ids = []
        while built < total:
            did = next_id
            next_id += 1
            dname = f"d{len(dir_ids):07d}"
            store.put(Inode(id=did, parent_id=0, name=dname,
                            is_directory=True))
            store.add_child(0, dname, did)
            dir_ids.append(did)
            built += 1
            for f in range(fanout):
                if built >= total:
                    break
                fid = next_id
                next_id += 1
                fname = f"f{f:05d}"
                store.put(Inode(id=fid, parent_id=did, name=fname,
                                length=4096, completed=True))
                store.add_child(did, fname, fid)
                built += 1
        out["built"] = built
        out["build_s"] = round(time.monotonic() - t0, 3)

        t0 = time.monotonic()
        edges = 0
        for parent in [0] + dir_ids:
            for _name, _cid in store.iter_edges(parent):
                edges += 1
        out["edges"] = edges
        out["walk_s"] = round(time.monotonic() - t0, 3)

        rng = random.Random(seed)
        t0 = time.monotonic()
        missing = 0
        for _ in range(sample):
            if store.get(rng.randrange(1, next_id)) is None:
                missing += 1
        out["missing"] = missing
        out["stat_s"] = round(time.monotonic() - t0, 3)
        out["store"] = {k: v for k, v in store.stats().items()
                        if isinstance(v, (int, float, str))}
        out["ok"] = edges == built and missing == 0
    except MemoryError:
        # free the namespace FIRST: json/print below must be able to
        # allocate inside the same rlimit that just fired
        store = None
        gc.collect()
        out["oom"] = True
        out["built"] = built
    out["maxrss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps(out), flush=True)


def run_lsm_capacity(*, inodes: int = 10_000_000, cap_mb: int = 2048,
                     fanout: int = 1000, sample: int = 20_000,
                     seed: int = 7,
                     timeout_s: float = 5400.0) -> BenchResult:
    """The memory-cap gate behind the LSM metastore: the SAME build +
    full-walk + random-stat workload runs once per backend in a fresh
    subprocess capped with ``RLIMIT_AS``.  HEAP must run out of memory
    (proving the cap is real at this namespace size); LSM must finish
    under it with every edge walked and every sampled stat served."""
    import json
    import subprocess

    t_start = time.monotonic()
    env = dict(os.environ)
    # the child imports this module, and through it the metastore, but
    # never torch: the address-space cap must hold the store alone
    child = ("import sys; "
             "from alluxio_tpu_torch.stress.metadata_bench import "
             "_capacity_child; _capacity_child()")
    results = {}
    for kind in ("HEAP", "LSM"):
        base = tempfile.mkdtemp(prefix="atpu_mdcap_")
        try:
            proc = subprocess.run(
                [sys.executable, "-c", child, kind, base, str(inodes),
                 str(cap_mb << 20), str(fanout), str(sample), str(seed)],
                capture_output=True, text=True, timeout=timeout_s,
                env=env)
            lines = (proc.stdout or "").strip().splitlines()
            try:
                results[kind] = json.loads(lines[-1]) if lines else {}
            except json.JSONDecodeError:
                results[kind] = {}
            # a crash before the JSON line (MemoryError inside the
            # handler, rlimit-killed allocator) still means "blew the
            # cap" — record it as such rather than losing the signal
            if proc.returncode != 0 and not results[kind].get("ok"):
                results[kind].setdefault("oom", True)
                results[kind]["exit"] = proc.returncode
        finally:
            shutil.rmtree(base, ignore_errors=True)
    heap, lsm = results["HEAP"], results["LSM"]
    ok = bool(lsm.get("ok")) and bool(heap.get("oom")) and \
        not heap.get("ok")
    if not ok:
        print(f"[metadata-lsm-capacity] gate failed: LSM ok="
              f"{lsm.get('ok')} (built {lsm.get('built')}, edges "
              f"{lsm.get('edges')}, missing {lsm.get('missing')}), "
              f"HEAP oom={heap.get('oom')} ok={heap.get('ok')} under "
              f"{cap_mb} MB", file=sys.stderr)
    metrics = {
        "inodes": inodes, "cap_mb": cap_mb,
        "lsm_ok": bool(lsm.get("ok")),
        "heap_oom": bool(heap.get("oom")),
        "heap_built_before_oom": int(heap.get("built", 0) or 0),
        "lsm_build_s": float(lsm.get("build_s", 0.0) or 0.0),
        "lsm_walk_s": float(lsm.get("walk_s", 0.0) or 0.0),
        "lsm_stat_s": float(lsm.get("stat_s", 0.0) or 0.0),
        "lsm_maxrss_mb": round(
            float(lsm.get("maxrss_kb", 0) or 0) / 1024, 1),
        "heap_maxrss_mb": round(
            float(heap.get("maxrss_kb", 0) or 0) / 1024, 1),
        "gate_ok": ok,
    }
    if lsm.get("build_s"):
        metrics["lsm_build_ops_per_s"] = round(
            int(lsm.get("built", 0)) / float(lsm["build_s"]), 1)
    if lsm.get("stat_s") and sample:
        metrics["lsm_stat_ops_per_s"] = round(
            sample / float(lsm["stat_s"]), 1)
    for k in ("runs", "run_bytes", "flushes", "compactions",
              "compaction_bytes", "cache_hit_ratio"):
        if k in (lsm.get("store") or {}):
            metrics[f"lsm_{k}"] = lsm["store"][k]
    return BenchResult(
        bench="metadata-lsm-capacity",
        params={"inodes": inodes, "cap_mb": cap_mb, "fanout": fanout,
                "sample": sample, "seed": seed},
        metrics=metrics,
        errors=0 if ok else 1,
        duration_s=time.monotonic() - t_start)


def run(*, row: str = "striped", **kw) -> BenchResult:
    if row == "striped":
        return run_striped(**kw)
    if row == "journal":
        return run_journal_batch(**kw)
    if row == "cached":
        return run_cached_getstatus(**kw)
    if row == "hot-dir":
        return run_hot_dir(**kw)
    if row == "lsm-capacity":
        return run_lsm_capacity(**kw)
    raise ValueError(f"unknown metadata bench row {row!r}")
