"""Cluster context for stress benches (a copy of
``alluxio_tpu/stress/cluster.py``): in-process LocalCluster (default,
the reference's ``--in-process`` smoke mode, ``BaseParameters.java:81``)
or a live cluster via ``--master host:port`` (``--cluster`` mode)."""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Dict, Iterator, Optional, Tuple


def wait_cold(fs, block_client, paths, *, timeout_s: float = 60.0) -> None:
    """Wait until no worker holds a block of ``paths``: a free reaches
    the workers on their heartbeats, so a freed corpus is cold only once
    the block master lists no location for any of its blocks."""
    deadline = time.monotonic() + timeout_s
    for path in paths:
        for fbi in fs.fs_master.get_file_block_info_list(path):
            while block_client.get_block_info(
                    fbi.block_info.block_id).locations:
                if time.monotonic() > deadline:
                    raise RuntimeError("corpus never went cold")
                time.sleep(0.02)


def write_cold_corpus(fs, block_client, paths_and_payloads, *,
                      timeout_s: float = 60.0) -> None:
    """Persist ``{path: payload}`` THROUGH to the UFS, then wait until
    every cached copy has been freed — the cold-start precondition the
    prefetch benches and tests measure from. THROUGH frees the cached
    copy asynchronously (the worker heartbeat applies the Free
    command), so writing alone does not make the corpus cold."""
    from alluxio_tpu_torch.client.streams import WriteType

    for path, payload in paths_and_payloads.items():
        fs.write_all(path, payload, write_type=WriteType.THROUGH)
    wait_cold(fs, block_client, paths_and_payloads, timeout_s=timeout_s)


@contextlib.contextmanager
def bench_cluster(master: Optional[str] = None, *, num_workers: int = 1,
                  block_size: int = 32 << 20,
                  worker_mem_bytes: int = 1 << 30,
                  conf_overrides: Optional[Dict] = None,
                  start_job_service: bool = False,
                  start_worker_heartbeats: bool = False,
                  ) -> Iterator[Tuple[object, object]]:
    """Yields ``(fs, cluster_or_None)``. With ``master`` set, attaches a
    FileSystem client to the live cluster; otherwise stands up a scratch
    LocalCluster on /dev/shm (tears it down afterwards)."""
    if master:
        from alluxio_tpu_torch.client.file_system import FileSystem
        from alluxio_tpu_torch.conf import Configuration

        fs = FileSystem(master, conf=Configuration(load_env=False))
        try:
            yield fs, None
        finally:
            fs.close()
        return
    base = tempfile.mkdtemp(
        prefix="atpu_stress_",
        dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        from alluxio_tpu_torch.minicluster import LocalCluster

        with LocalCluster(base, num_workers=num_workers,
                          block_size=block_size,
                          worker_mem_bytes=worker_mem_bytes,
                          conf_overrides=conf_overrides,
                          start_job_service=start_job_service,
                          start_worker_heartbeats=start_worker_heartbeats
                          ) as cluster:
            fs = cluster.file_system()
            try:
                yield fs, cluster
            finally:
                fs.close()
    finally:
        shutil.rmtree(base, ignore_errors=True)
