"""Read-only HTTP/JSON state endpoint for the worker (a copy of
``alluxio_tpu/worker/web.py``).

Re-design of ``core/server/worker/src/main/java/alluxio/worker/
AlluxioWorkerRestServiceHandler.java`` (the worker web UI's backing
REST API) as a stdlib HTTP server, the worker-side twin of
``master/web.py``.

Routes:
  GET /api/v1/worker/info      id, address, tier topology, uptime
  GET /api/v1/worker/capacity  per-tier and per-dir capacity/used
  GET /api/v1/worker/blocks    block counts per tier (+ recent ids)
  GET /api/v1/worker/metrics   flat metrics snapshot (JSON)
  GET /metrics                 Prometheus text exposition
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

LOG = logging.getLogger(__name__)

_BLOCK_LIST_CAP = 1000  # /blocks id sample cap: bounded response size

def _dashboard_html() -> bytes:
    """Status page (webui-worker stand-in; shared chrome in
    ``utils/statuspage.py``)."""
    from alluxio_tpu_torch.utils.statuspage import render

    return render(
        "alluxio-tpu worker", "/api/v1/worker",
        sections=[("Worker", "info"), ("Tiers", "tiers"),
                  ("Blocks", "blocks")],
        raw_routes=["/api/v1/worker/info", "/capacity", "/blocks",
                    "/metrics"],
        js_body="""
    const info = await j('/info');
    const t = document.getElementById('info');
    for (const k of ['worker_id','host','rpc_port','tiered_identity',
                     'uptime_ms'])
      row(t, [k, String(info[k])]);
    const cap = await j('/capacity');
    const tt = document.getElementById('tiers');
    row(tt, ['tier','capacity','used','dirs'], true);
    for (const x of cap.tiers)
      row(tt, [x.alias, gb(x.capacity), gb(x.used), x.dirs.length]);
    const bl = await j('/blocks');
    const bt = document.getElementById('blocks');
    row(bt, ['tier','count'], true);
    for (const [tier, d] of Object.entries(bl.blocks))
      row(bt, [tier, d.count]);
""")


class WorkerWebServer:
    def __init__(self, worker, port: int = 0,
                 bind_host: str = "0.0.0.0") -> None:
        wp = worker
        start_ms = int(time.time() * 1000)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                LOG.debug("worker web: " + fmt, *args)

            def do_GET(self):  # noqa: N802 (stdlib API)
                try:
                    route = self.path.split("?", 1)[0].rstrip("/")
                    if route == "":
                        self._send(200, _dashboard_html(),
                                   "text/html; charset=utf-8")
                        return
                    if route == "/metrics":
                        from alluxio_tpu_torch.metrics import metrics

                        body = metrics().to_prometheus().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4")
                        return
                    payload = self._route(route)
                    if payload is None:
                        self._send(404, json.dumps(
                            {"error": f"no route {route}"}).encode(),
                            "application/json")
                        return
                    self._send(200, json.dumps(
                        payload, sort_keys=True, default=str).encode(),
                        "application/json")
                except Exception as e:  # noqa: BLE001 - surface as 500
                    LOG.warning("worker web handler failed",
                                exc_info=True)
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")

            def _send(self, code: int, body: bytes,
                      ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, route: str):
                meta = wp.store.meta
                if route == "/api/v1/worker/info":
                    return {
                        "worker_id": wp.worker_id,
                        "host": wp.address.host,
                        "rpc_port": wp.address.rpc_port,
                        "tiered_identity": str(
                            getattr(wp.address, "tiered_identity", "")),
                        "tiers": [t.alias for t in meta.tiers],
                        "start_time_ms": start_ms,
                        "uptime_ms": max(0, int(time.time() * 1000)
                                         - start_ms),
                    }
                if route == "/api/v1/worker/capacity":
                    return {"tiers": [{
                        "alias": t.alias,
                        "ordinal": t.ordinal,
                        "capacity": t.capacity_bytes,
                        "used": t.used_bytes,
                        "dirs": [{
                            "path": d.path,
                            "capacity": d.capacity_bytes,
                            "used": d.used_bytes,
                        } for d in t.dirs],
                    } for t in meta.tiers]}
                if route == "/api/v1/worker/blocks":
                    # block_ids() snapshots under the per-dir lock, so
                    # iteration here is safe against concurrent
                    # eviction/commit without holding the store-wide
                    # allocation lock (an admin poll must not stall the
                    # write path); cross-dir counts may be ~1 op skewed
                    out = {}
                    for t in meta.tiers:
                        count, sample = 0, []
                        for d in t.dirs:
                            ids = d.block_ids()
                            count += len(ids)
                            sample.extend(
                                ids[:_BLOCK_LIST_CAP - len(sample)])
                        out[t.alias] = {"count": count,
                                        "sample": sample}
                    return {"blocks": out}
                if route == "/api/v1/worker/metrics":
                    from alluxio_tpu_torch.metrics import metrics

                    return {"metrics": metrics().snapshot()}
                return None

        self._server = ThreadingHTTPServer((bind_host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="worker-web",
            daemon=True)
        self._thread.start()
        LOG.info("worker web endpoint on port %d", self.port)
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
