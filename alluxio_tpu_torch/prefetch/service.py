"""Prefetch service facade: oracle + scheduler + agent as one control loop.

The port of ``alluxio_tpu/prefetch/service.py``. Built from
configuration (``atpu.prefetch.*`` keys) by :meth:`PrefetchService.from_conf`,
or from keyword arguments by :meth:`PrefetchService.from_fs`, bound to a
:class:`~alluxio_tpu_torch.client.torch_io.DeviceBlockLoader` consumer,
and driven either by its own heartbeat thread or by explicit
:meth:`tick` calls (tests).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from alluxio_tpu_torch.conf import Keys
from alluxio_tpu_torch.heartbeat import HeartbeatContext, HeartbeatThread
from alluxio_tpu_torch.prefetch.agent import (
    JobServiceExecutor, PrefetchAgent, WorkerTierExecutor,
)
from alluxio_tpu_torch.prefetch.oracle import (
    AccessOracle, BlockRef, DatasetManifest,
)
from alluxio_tpu_torch.prefetch.scheduler import (
    OUTCOME_HIT, PrefetchScheduler,
)


class PrefetchService:
    """Owns the clairvoyant control loop for one consumer's dataset."""

    def __init__(self, oracle: AccessOracle, scheduler: PrefetchScheduler,
                 agent: PrefetchAgent, *,
                 heartbeat_interval_s: float = 0.1) -> None:
        self.oracle = oracle
        self.scheduler = scheduler
        self.agent = agent
        self._interval = heartbeat_interval_s
        self._thread: Optional[HeartbeatThread] = None
        self._lock = threading.Lock()
        self._closed = False

    # -- construction -------------------------------------------------------
    @classmethod
    def from_conf(cls, conf, fs, paths: Sequence[str], *, seed: int,
                  num_hosts: int = 1, host_index: int = 0,
                  local_host: str = "", job_client=None,
                  worker_client_fn: Optional[Callable] = None
                  ) -> Optional["PrefetchService"]:
        """Assemble from ``atpu.prefetch.*`` keys; None when disabled —
        callers pass that straight to the loader, whose behavior is then
        byte-identical to a loader that never heard of prefetching.
        With ``job_client``, DRAM placements ride load plans through the
        job service instead of direct worker RPCs."""
        if not conf.get_bool(Keys.PREFETCH_ENABLED):
            return None
        return cls.from_fs(
            fs, paths, seed=seed,
            lookahead_blocks=conf.get_int(Keys.PREFETCH_LOOKAHEAD_BLOCKS),
            budget_bytes=conf.get_bytes(Keys.PREFETCH_BUDGET_BYTES),
            hbm_fraction=conf.get_float(Keys.PREFETCH_HBM_FRACTION),
            heartbeat_interval_s=conf.get_duration_s(
                Keys.PREFETCH_HEARTBEAT_INTERVAL),
            num_hosts=num_hosts, host_index=host_index,
            local_host=local_host, job_client=job_client,
            worker_client_fn=worker_client_fn)

    @classmethod
    def from_fs(cls, fs, paths: Sequence[str], *, seed: int,
                lookahead_blocks: int = 16, budget_bytes: int = 256 << 20,
                hbm_fraction: float = 0.25,
                heartbeat_interval_s: float = 0.1, num_hosts: int = 1,
                host_index: int = 0, local_host: str = "",
                job_client=None,
                worker_client_fn: Optional[Callable] = None
                ) -> "PrefetchService":
        """Assemble the loop over ``fs`` (duck-typed: ``get_status``,
        ``fs_master``, ``block_master`` and, when ``worker_client_fn`` is
        None, ``store.worker_client``). With ``job_client``, DRAM
        placements ride load plans through the job service instead of
        direct worker RPCs."""
        manifest = DatasetManifest.from_fs(fs, paths)
        oracle = AccessOracle(manifest, seed, num_hosts=num_hosts,
                              host_index=host_index)
        scheduler = PrefetchScheduler(
            oracle, lookahead_blocks=lookahead_blocks,
            budget_bytes=budget_bytes, hbm_fraction=hbm_fraction)
        if worker_client_fn is None:
            worker_client_fn = fs.store.worker_client
        if job_client is not None:
            executor = JobServiceExecutor(fs.block_master,
                                          worker_client_fn, job_client,
                                          local_host=local_host)
        else:
            executor = WorkerTierExecutor(fs.block_master,
                                          worker_client_fn,
                                          local_host=local_host)
        return cls(oracle, scheduler, PrefetchAgent(scheduler, executor),
                   heartbeat_interval_s=heartbeat_interval_s)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "PrefetchService":
        """Start the heartbeat-driven agent loop."""
        with self._lock:
            if self._closed:
                raise RuntimeError("prefetch service is closed")
            if self._thread is None:
                self._thread = HeartbeatThread(
                    HeartbeatContext.CLIENT_PREFETCH_AGENT, self.agent,
                    self._interval)
                self._thread.start()
        return self

    def tick(self) -> None:
        """One agent tick, synchronously (deterministic test driving)."""
        self.agent.heartbeat()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.stop()  # HeartbeatThread closes the agent (and pins)
        else:
            self.agent.close()

    def __enter__(self) -> "PrefetchService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- consumer (loader) integration --------------------------------------
    def epoch_sequence(self, epoch: int) -> List[BlockRef]:
        return self.oracle.epoch_sequence(epoch)

    def begin_epoch(self, epoch: int) -> int:
        """Rewind the cursor; returns the generation token the epoch's
        consumes must carry (stale-producer fencing)."""
        return self.scheduler.begin_epoch(epoch)

    def bind_hbm(self, adopt_fn: Optional[Callable[[BlockRef], bool]]
                 ) -> None:
        """Bind (or unbind) the loader's device-tier adopt hook."""
        self.agent.bind_hbm(adopt_fn)

    def on_consume(self, ref: BlockRef, *, resident_hint: bool = False,
                   generation: Optional[int] = None) -> str:
        """Classify a consume and move the cursor. Does NOT drop the
        eviction pin — the consumer calls :meth:`release` once its read
        holds the block."""
        return self.scheduler.on_consume(ref, resident_hint=resident_hint,
                                         generation=generation)

    def release(self, ref: BlockRef) -> None:
        """Consume finished: drop the block's eviction pin (no-op when
        none is held)."""
        self.agent.unpin(ref.block_id)

    def invalidate(self, block_id: int) -> None:
        """Residency lost outside the control loop: drop the ready state
        and any pin so the next window replans the block instead of
        mis-classifying its consume as a hit."""
        self.scheduler.on_evicted(block_id)
        self.agent.unpin(block_id)

    def record_stall(self, seconds: float) -> None:
        self.scheduler.record_stall(seconds)

    # -- introspection ------------------------------------------------------
    def wait_ready(self, min_blocks: int, *, timeout_s: float = 30.0,
                   tick: bool = False) -> bool:
        """Wait until at least ``min_blocks`` placements are resident
        (optionally self-driving ticks when no heartbeat thread runs) —
        the warm-up gate before a measured run."""
        deadline = time.monotonic() + timeout_s
        while self.scheduler.ready_count() < min_blocks:
            if time.monotonic() > deadline:
                return False
            if tick:
                self.tick()
            time.sleep(0.005)
        return True

    def stats(self) -> Dict[str, float]:
        return self.scheduler.stats()


__all__ = ["PrefetchService", "OUTCOME_HIT"]
