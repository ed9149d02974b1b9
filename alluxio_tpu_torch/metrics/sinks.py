"""Metrics sinks: periodic export of registry snapshots (a copy of
``alluxio_tpu/metrics/sinks.py``).

Re-design of ``core/common/src/main/java/alluxio/metrics/sink/
{Sink,ConsoleSink,CsvSink,GraphiteSink,Slf4jSink}.java`` (JMX has no
environment analogue here; the JSON-lines sink is the modern structured
equivalent): a sink receives the flat snapshot each scheduler tick and
writes it somewhere durable/visible. Sinks are configured by name
(``atpu.metrics.sinks=csv,jsonl,console,graphite``) and driven by one
heartbeat.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List

LOG = logging.getLogger(__name__)


class Sink:
    """SPI (reference: ``metrics/sink/Sink.java``)."""

    def report(self, snapshot: Dict[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleSink(Sink):
    def __init__(self, stream=None) -> None:
        self._stream = stream or sys.stderr

    def report(self, snapshot: Dict[str, float]) -> None:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"-- metrics @ {ts} " + "-" * 40, file=self._stream)
        for name, value in sorted(snapshot.items()):
            print(f"{name} = {value}", file=self._stream)
        self._stream.flush()


class CsvSink(Sink):
    """One CSV file per metric under ``directory``, appending
    ``epoch_seconds,value`` rows (reference: CsvSink's per-metric file
    layout, the format Graphite/pandas ingest directly)."""

    def __init__(self, directory: str) -> None:
        self._dir = directory
        os.makedirs(directory, exist_ok=True)

    def report(self, snapshot: Dict[str, float]) -> None:
        now = int(time.time())
        for name, value in snapshot.items():
            safe = name.replace("/", "_")
            path = os.path.join(self._dir, f"{safe}.csv")
            is_new = not os.path.exists(path)
            try:
                with open(path, "a") as f:
                    if is_new:
                        f.write("t,value\n")
                    f.write(f"{now},{value}\n")
            except OSError:  # disk pressure: skip this tick
                LOG.debug("csv sink write failed for %s", name,
                          exc_info=True)


class JsonLinesSink(Sink):
    """One JSON object per tick appended to ``path`` — the structured
    log shape every modern collector tails."""

    def __init__(self, path: str) -> None:
        self._path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def report(self, snapshot: Dict[str, float]) -> None:
        line = json.dumps({"ts": round(time.time(), 3),
                           "metrics": snapshot}, sort_keys=True)
        try:
            with open(self._path, "a") as f:
                f.write(line + "\n")
        except OSError:
            LOG.debug("jsonl sink write failed", exc_info=True)


class GraphiteSink(Sink):
    """Plaintext Graphite/Carbon protocol (reference:
    ``metrics/sink/GraphiteSink.java``): one ``<prefix>.<name> <value>
    <unix-ts>\\n`` line per metric over TCP. The socket reconnects per
    report tick — Carbon treats connections as cheap and a long-lived
    one would silently die across Carbon restarts.

    The TCP send runs on a dedicated sender thread with a bounded
    connect/send deadline: ``report()`` only enqueues, so a dead carbon
    host can never stall the shared sink heartbeat (which would starve
    EVERY other sink for the full connect timeout each tick). The queue
    keeps only the newest pending snapshot — under backpressure stale
    ticks are dropped, latest wins."""

    def __init__(self, host: str, port: int,
                 prefix: str = "alluxio-tpu",
                 timeout_s: float = 5.0) -> None:
        import queue

        self._host = host
        self._port = port
        self._prefix = prefix.rstrip(".")
        self._timeout_s = timeout_s
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._sender = threading.Thread(target=self._run, daemon=True,
                                        name="graphite-sink")
        self._sender.start()

    @staticmethod
    def _sanitize(name: str) -> str:
        # Graphite path segments must not contain spaces; dots are
        # hierarchy separators and kept as-is
        return name.replace(" ", "_")

    def report(self, snapshot: Dict[str, float]) -> None:
        import queue

        ts = int(time.time())
        lines = [f"{self._prefix}.{self._sanitize(n)} {v} {ts}\n"
                 for n, v in sorted(snapshot.items())
                 if isinstance(v, (int, float))]
        if not lines:
            return
        payload = "".join(lines).encode()
        while True:
            try:
                self._queue.put_nowait(payload)
                return
            except queue.Full:  # sender wedged on a dead host
                try:
                    self._queue.get_nowait()
                    LOG.debug("graphite sink backlogged; dropped one "
                              "stale snapshot")
                except queue.Empty:
                    pass

    def _run(self) -> None:
        import socket

        while True:
            payload = self._queue.get()
            if payload is None:
                return
            try:
                with socket.create_connection(
                        (self._host, self._port),
                        timeout=self._timeout_s) as s:
                    s.sendall(payload)
            except OSError:
                LOG.warning("graphite sink send to %s:%s failed",
                            self._host, self._port, exc_info=True)

    def close(self) -> None:
        import queue

        # same drop-oldest discipline as report(): a wedged sender must
        # not let close() block behind a full queue
        while True:
            try:
                self._queue.put_nowait(None)
                break
            except queue.Full:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
        self._sender.join(timeout=self._timeout_s + 1.0)


class SinkManager:
    """Builds sinks from config and reports on a heartbeat tick
    (reference: MetricsSystem's sink scheduling)."""

    def __init__(self, conf, registry) -> None:
        from alluxio_tpu_torch.conf import Keys

        self._registry = registry
        self.sinks: List[Sink] = []
        names = [s.strip() for s in
                 (conf.get(Keys.METRICS_SINKS) or "").split(",")
                 if s.strip()]
        # the host-global DEFAULT paths get a per-process namespace:
        # two processes appending the same file would interleave rows
        # and race the CSV header; an EXPLICITLY configured path is the
        # operator's call and is honored verbatim
        me = f"{registry.instance.lower()}-{os.getpid()}"
        for name in names:
            if name == "console":
                self.sinks.append(ConsoleSink())
            elif name == "csv":
                d = conf.get(Keys.METRICS_SINK_CSV_DIR)
                if d == Keys.METRICS_SINK_CSV_DIR.default:
                    d = os.path.join(d, me)
                self.sinks.append(CsvSink(d))
            elif name == "jsonl":
                p = conf.get(Keys.METRICS_SINK_JSONL_PATH)
                if p == Keys.METRICS_SINK_JSONL_PATH.default:
                    root, ext = os.path.splitext(p)
                    p = f"{root}.{me}{ext}"
                self.sinks.append(JsonLinesSink(p))
            elif name == "graphite":
                addr = conf.get(Keys.METRICS_SINK_GRAPHITE_ADDRESS)
                if not addr:
                    LOG.warning("graphite sink configured without "
                                "atpu.metrics.sink.graphite.address")
                    continue
                host, sep, port = addr.rpartition(":")
                if not sep or not host or not port.isdigit():
                    # a malformed address must fail LOUDLY: silently
                    # defaulting host/port would ship metrics to the
                    # wrong place while the operator believes they
                    # configured carbon
                    LOG.warning("graphite sink skipped: address %r is "
                                "not host:port", addr)
                    continue
                self.sinks.append(GraphiteSink(
                    host, int(port),
                    prefix=conf.get(
                        Keys.METRICS_SINK_GRAPHITE_PREFIX),
                    timeout_s=conf.get_duration_s(
                        Keys.METRICS_SINK_GRAPHITE_TIMEOUT)))
            else:
                LOG.warning("unknown metrics sink %r (known: console, "
                            "csv, jsonl, graphite)", name)

    def heartbeat(self) -> None:
        if not self.sinks:
            return
        snapshot = self._registry.snapshot()
        for sink in self.sinks:
            try:
                sink.report(snapshot)
            except Exception:  # noqa: BLE001 one sink must not kill others
                LOG.warning("metrics sink %s failed",
                            type(sink).__name__, exc_info=True)

    def close(self) -> None:
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # noqa: BLE001
                pass
