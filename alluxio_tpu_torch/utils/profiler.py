"""Sampling thread-stack profiler (the microscope's third lens): a copy
of ``alluxio_tpu/utils/profiler.py``.

Phase events say WHAT the read path was blocked on; this says WHERE the
process was executing while it happened. A daemon thread periodically
snapshots every Python thread's stack via ``sys._current_frames()`` and
merges the samples into flame-graph counts — one ``folded-stack ->
count`` table per process, drained onto the metrics heartbeat and kept
per-source on the master (``/api/v1/master/profile``).

Conf-gated (``atpu.profile.enabled``, default off): when disabled
nothing starts, no thread exists, and the serving paths are
byte-identical to a build without this module. Sampling cost is bounded
by the interval, stack depth and table size
(``atpu.profile.sample.interval.ms`` / ``.stack.depth`` /
``.max.stacks``) — the bench gate ``obs-profile-overhead`` holds the
enabled-path tax under 2%. The dominant cost is NOT the stack walk
(~50us warm): every sampler wake forces a GIL handoff against the
running thread, ~1ms observed on a busy read path, so the default
interval stays coarse (~10Hz) and the walk itself memoizes frame
labels by code object.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Optional


class StackSampler:
    """Merged-flame stack sampler for one process."""

    def __init__(self, interval_ms: int = 97, max_stacks: int = 2048,
                 depth: int = 24) -> None:
        self.interval_ms = max(1, int(interval_ms))
        self.max_stacks = max(1, int(max_stacks))
        self.depth = max(1, int(depth))
        self._stacks: Dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: code-object -> "file:func" memo. Formatting every frame of
        #: every thread per sample costs ~1ms of GIL in a busy cluster
        #: process (the obs-profile-overhead gate fails on it); a frame
        #: set repeats almost entirely sample-to-sample, so label
        #: construction must be a dict hit, not string work
        self._labels: Dict[object, str] = {}

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="atpu-stack-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling ------------------------------------------------------------
    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval_ms / 1000.0):
            self.sample_once(skip_ident=me)

    def sample_once(self, skip_ident: Optional[int] = None) -> None:
        """One merged sample of every live thread's stack (public for
        tests: deterministic sampling without the timing thread)."""
        # sys._current_frames() is a single C-level snapshot — no
        # per-thread locking, and frames are read without running any
        # target-thread code
        frames = sys._current_frames()
        folded = []
        labels = self._labels
        depth = self.depth
        for ident, frame in frames.items():
            if ident == skip_ident:
                continue  # the sampler must not profile itself
            parts = []
            f = frame
            while f is not None and len(parts) < depth:
                code = f.f_code
                lab = labels.get(code)
                if lab is None:
                    if len(labels) >= 8192:
                        labels.clear()  # bound; refills in one sample
                    lab = labels[code] = \
                        f"{code.co_filename.rsplit('/', 1)[-1]}:" \
                        f"{code.co_name}"
                parts.append(lab)
                f = f.f_back
            # root-first, innermost last — the flame-graph convention
            parts.reverse()
            folded.append(";".join(parts))
        with self._lock:
            self._samples += 1
            for key in folded:
                n = self._stacks.get(key)
                if n is None and len(self._stacks) >= self.max_stacks:
                    self._dropped += 1
                    continue
                self._stacks[key] = (n or 0) + 1

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"samples": self._samples,
                    "interval_ms": self.interval_ms,
                    "dropped": self._dropped,
                    "stacks": dict(self._stacks)}

    def drain(self) -> Optional[dict]:
        """Snapshot-and-reset for the metrics heartbeat: the master
        accumulates the deltas, so a restart of either side never
        double-counts. Returns None when there is nothing to ship."""
        with self._lock:
            if not self._samples:
                return None
            out = {"samples": self._samples,
                   "interval_ms": self.interval_ms,
                   "dropped": self._dropped,
                   "stacks": self._stacks}
            self._stacks = {}
            self._samples = 0
            self._dropped = 0
        return out


_PROFILER = StackSampler()


def profiler() -> StackSampler:
    return _PROFILER


def apply_profile_conf(conf) -> None:
    """Apply the ``atpu.profile.*`` keys to the process sampler and
    start/stop it to match ``atpu.profile.enabled`` (mirrors
    ``tracing.apply_trace_conf``)."""
    from alluxio_tpu_torch.conf import Keys

    p = _PROFILER
    p.interval_ms = max(1, conf.get_int(Keys.PROFILE_SAMPLE_INTERVAL_MS))
    p.max_stacks = max(1, conf.get_int(Keys.PROFILE_MAX_STACKS))
    p.depth = max(1, conf.get_int(Keys.PROFILE_STACK_DEPTH))
    if conf.get_bool(Keys.PROFILE_ENABLED):
        p.start()
    else:
        p.stop()


def merge_flames(base: dict, delta: dict) -> dict:
    """Accumulate one drained flame delta into a running total (the
    master's per-source store uses this; also handy for tests)."""
    out = dict(base) if base else {"samples": 0, "dropped": 0,
                                   "stacks": {}}
    out["samples"] = int(out.get("samples", 0)) + \
        int(delta.get("samples", 0))
    out["dropped"] = int(out.get("dropped", 0)) + \
        int(delta.get("dropped", 0))
    if "interval_ms" in delta:
        out["interval_ms"] = delta["interval_ms"]
    stacks = dict(out.get("stacks") or {})
    for key, n in (delta.get("stacks") or {}).items():
        stacks[key] = stacks.get(key, 0) + int(n)
    out["stacks"] = stacks
    return out
