"""Read-only HTTP/JSON state endpoint for the master (a copy of
``alluxio_tpu/master/web.py``).

Re-design of ``core/server/master/src/main/java/alluxio/master/meta/
AlluxioMasterRestServiceHandler.java`` (the web UI's backing REST API)
as a stdlib HTTP server: everything ``fsadmin report`` prints, curl-able.

Routes:
  GET /api/v1/master/info      cluster id, uptime, safe mode, version
  GET /api/v1/master/capacity  per-tier capacity/used + worker list
  GET /api/v1/master/metrics   flat metrics snapshot (JSON)
  GET /api/v1/master/mounts    mount table
  GET /api/v1/master/catalog   table-service databases/tables
  GET /api/v1/master/browse    ?path= namespace listing w/ tier residency
  GET /api/v1/master/config    effective configuration + value sources
  GET /api/v1/master/metrics/history  ?name=&source=&resolution=&rate=
                               the metrics history's series
  GET /api/v1/master/health    the health rules' ranked alerts
  GET /api/v1/master/remediation  the remediation engine's audit
  GET /api/v1/master/metastore the metastore's shape
  GET /api/v1/master/masters   the HA quorum view (role, term, applied
                               sequence, lag, last contact per master)
  GET /api/v1/master/trace     ?limit=&prefix=&trace_id=&fanout= stitched
                               spans and per-trace summaries
  GET /api/v1/master/trace/profile  ?trace_id= critical path of a trace,
                               or the per-phase profile of many
  GET /api/v1/master/profile   ?source= merged stack-sampler flames
  GET /api/v1/master/logs      ?n=&level= recent log records (in-process
                               ring)
  GET /metrics                 Prometheus text exposition
  GET /browse /config /logs    HTML pages over the routes above
                               (reference: webui/master's browse/config/
                               logs SPA pages)
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from alluxio_tpu_torch.conf import Keys

LOG = logging.getLogger(__name__)


def _dashboard_html() -> bytes:
    """Status page over the JSON routes (stand-in for the reference's
    webui-master SPA, ``webui/master/``; shared chrome lives in
    ``utils/statuspage.py``)."""
    from alluxio_tpu_torch.utils.statuspage import render

    return render(
        "alluxio-tpu master", "/api/v1/master",
        sections=[("Cluster", "info"), ("Masters", "masters"),
                  ("Workers", "workers"),
                  ("Metastore", "metastore"),
                  ("Mounts", "mounts"), ("Catalog", "catalog"),
                  ("Cluster health", "health"),
                  ("Self-healing", "remediation"),
                  ("Input doctor", "stall")],
        raw_routes=["/api/v1/master/info", "/masters", "/capacity",
                    "/metrics",
                    "/metrics/history", "/health", "/remediation",
                    "/metastore",
                    "/mounts", "/catalog", "/trace", "/browse",
                    "/config", "/logs"],
        js_body="""
    const info = await j('/info');
    const t = document.getElementById('info');
    for (const k of ['cluster_id','rpc_port','safe_mode','live_workers',
                     'uptime_ms'])
      row(t, [k, String(info[k])]);
    // HA quorum view: role/term/applied-seq per master (docs/ha.md)
    const ms = await j('/masters');
    const mst = document.getElementById('masters');
    row(mst, ['address','role','term','applied seq','lag','contact'], true);
    for (const x of ms.masters)
      row(mst, [x.address + (x.address === ms.leader ? ' *' : ''),
                x.role || '?', String(x.term ?? '-'),
                String(x.sequence ?? '-'),
                x.lag_entries != null ? String(x.lag_entries) : '-',
                x.last_contact_s != null
                  ? x.last_contact_s.toFixed(1) + 's' : '-']);
    const cap = await j('/capacity');
    const w = document.getElementById('workers');
    row(w, ['host','state','capacity','used'], true);
    for (const x of cap.workers)
      row(w, [x.host, x.state,
              gb(Object.values(x.capacity).reduce((a,b)=>a+b,0)),
              gb(Object.values(x.used).reduce((a,b)=>a+b,0))]);
    // inode metastore: backend kind, population, LSM write/read debt
    const meta = (await j('/metastore')).stats;
    const met2 = document.getElementById('metastore');
    row(met2, ['kind', String(meta.kind ?? '?')]);
    row(met2, ['inodes', String(meta.inodes ?? 0)]);
    if (meta.cache_hit_ratio != null)
      row(met2, ['cache hit ratio',
                 (100 * meta.cache_hit_ratio).toFixed(1) + '% (' +
                 (meta.cache_entries ?? 0) + ' entries)']);
    if (meta.memtable_bytes != null) {
      row(met2, ['memtable', gb(meta.memtable_bytes) + ' (' +
                 (meta.memtable_entries ?? 0) + ' entries)']);
      row(met2, ['sorted runs', (meta.runs ?? 0) + ' (' +
                 gb(meta.run_bytes ?? 0) + ')']);
      row(met2, ['flushes / compactions', (meta.flushes ?? 0) + ' / ' +
                 (meta.compactions ?? 0) + ' (' +
                 gb(meta.compaction_bytes ?? 0) + ' rewritten)']);
    }
    const m = await j('/mounts');
    const mt = document.getElementById('mounts');
    row(mt, ['path','ufs','read-only'], true);
    for (const x of m.mounts) row(mt, [x.path, x.ufs, x.read_only]);
    const c = await j('/catalog');
    const ct = document.getElementById('catalog');
    row(ct, ['database','tables'], true);
    for (const [db, tables] of Object.entries(c.databases))
      row(ct, [db, tables.join(', ')]);
    // cluster doctor: ranked verdicts from the health-rule engine
    const h = await j('/health');
    const ht = document.getElementById('health');
    row(ht, ['status: ' + h.status, '', '', ''], true);
    row(ht, ['severity', 'rule', 'subject', 'verdict'], true);
    for (const a of h.alerts)
      row(ht, [a.severity, a.rule, a.subject,
               a.summary + ' — ' + a.remediation]);
    if (!h.alerts.length)
      row(ht, ['(no alerts firing — ' + h.rules.length +
               ' rules watching)', '', '', '']);
    // self-healing: the remediation engine's audited timeline
    const rem = await j('/remediation');
    const rt = document.getElementById('remediation');
    if (!rem.enabled) {
      row(rt, ['(remediation disabled — ' +
               'atpu.master.remediation.enabled)', '', '', '']);
    } else {
      row(rt, ['mode: ' + (rem.dry_run ? 'DRY-RUN' : 'active') +
               ', ' + rem.actions_in_window + '/' +
               rem.max_actions_per_window + ' actions in window, ' +
               rem.quarantined.length + ' quarantined',
               '', '', ''], true);
      row(rt, ['when', 'cause', 'action', 'outcome'], true);
      for (const a of rem.audit.slice(-15).reverse())
        row(rt, [new Date(1e3 * a.at).toISOString().slice(11, 19),
                 a.rule + ' on ' + a.subject, a.action,
                 a.outcome + (a.reverted_at ? ' (reverted)' : '')]);
      if (!rem.audit.length)
        row(rt, ['(no actions taken yet)', '', '', '']);
    }
    // input doctor: rank loader input waits by serving tier
    // (Cluster.* roll-up when clients report, else this process's own)
    const met = (await j('/metrics')).metrics;
    const st = document.getElementById('stall');
    row(st, ['tier','waits','stalled (s)','share'], true);
    const buckets = {};
    for (const [k, v] of Object.entries(met)) {
      const m2 = k.match(/^(?:Cluster|Client)\\.InputStall(Us|Count)\\.(\\w+)$/);
      if (!m2) continue;
      const b = buckets[m2[2]] = buckets[m2[2]] || {us: 0, count: 0};
      if (m2[1] === 'Us') b.us = Math.max(b.us, v);
      else b.count = Math.max(b.count, v);
    }
    const totalUs = Object.values(buckets).reduce((a, b) => a + b.us, 0);
    const ranked = Object.entries(buckets).sort((a, b) => b[1].us - a[1].us);
    for (const [name, b] of ranked)
      row(st, [name, String(b.count), (b.us / 1e6).toFixed(3),
               totalUs ? (100 * b.us / totalUs).toFixed(1) + '%' : '-']);
    if (!ranked.length)
      row(st, ['(no input-stall samples recorded)', '', '', '']);
""")


def _page_html(page: str) -> bytes:
    """The browse/config/logs pages (reference: ``webui/master``'s
    Browse / Configuration / Logs SPA pages, as self-contained HTML
    over the JSON routes)."""
    from alluxio_tpu_torch.utils.statuspage import render

    if page == "browse":
        return render(
            "alluxio-tpu browse", "/api/v1/master",
            sections=[("Namespace", "listing")],
            raw_routes=["/api/v1/master/browse?path=/"],
            js_body="""
    const params = new URLSearchParams(location.search);
    const path = params.get('path') || '/';
    const d = await j('/browse?path=' + encodeURIComponent(path));
    const t = document.getElementById('listing');
    const h = document.createElement('h3');
    // textContent only: ?path= is attacker-controlled (reflected XSS
    // via innerHTML otherwise)
    h.textContent = 'path: ' + path + (path === '/' ? '' : ' — ');
    if (path !== '/') {
      const parent = path.slice(0, path.lastIndexOf('/')) || '/';
      const up = document.createElement('a');
      up.href = '/browse?path=' + encodeURIComponent(parent);
      up.textContent = 'up';
      h.appendChild(up);
    }
    t.before(h);
    row(t, ['name','size','in-mem %','persistence','mode','owner',
            'blocks'], true);
    for (const e of d.entries) {
      const tr = row(t, ['', String(e.length), e.folder ? '-' :
                         String(e.in_memory_percentage),
                         e.persistence_state, e.mode, e.owner,
                         String(e.block_count)]);
      const cell = tr.cells[0];
      if (e.folder) {
        const a = document.createElement('a');
        a.href = '/browse?path=' + encodeURIComponent(e.path);
        a.textContent = e.name + '/';
        cell.appendChild(a);
      } else cell.textContent = e.name;
    }
""")
    if page == "config":
        return render(
            "alluxio-tpu configuration", "/api/v1/master",
            sections=[("Effective configuration", "conf")],
            raw_routes=["/api/v1/master/config"],
            js_body="""
    const d = await j('/config');
    const t = document.getElementById('conf');
    row(t, ['property','value','source'], true);
    for (const [k, v] of Object.entries(d.config))
      row(t, [k, v.value, v.source]);
""")
    return render(
        "alluxio-tpu logs", "/api/v1/master",
        sections=[("Recent log records", "logs")],
        raw_routes=["/api/v1/master/logs?n=200&level=WARNING"],
        js_body="""
    const params = new URLSearchParams(location.search);
    const d = await j('/logs?n=' + (params.get('n') || 200) +
                      '&level=' + (params.get('level') || ''));
    const t = document.getElementById('logs');
    row(t, ['time','level','logger','message'], true);
    for (const r of d.records.reverse())
      row(t, [new Date(r.ts_ms).toISOString(), r.level, r.logger,
              r.message]);
""")


class MasterWebServer:
    def __init__(self, master_process, port: int = 0,
                 bind_host: str = "0.0.0.0") -> None:
        self._mp = master_process
        mp = master_process

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: route to logger
                LOG.debug("web: " + fmt, *args)

            def do_GET(self):  # noqa: N802 (stdlib API)
                try:
                    from urllib.parse import parse_qs, urlsplit

                    parts = urlsplit(self.path)
                    route = parts.path.rstrip("/")
                    self.query = {k: v[0] for k, v in
                                  parse_qs(parts.query).items()}
                    if route == "":
                        self._send(200, _dashboard_html(),
                                   "text/html; charset=utf-8")
                        return
                    if route in ("/browse", "/config", "/logs"):
                        self._send(200, _page_html(route[1:]),
                                   "text/html; charset=utf-8")
                        return
                    if route == "/metrics":
                        from alluxio_tpu_torch.metrics import metrics

                        body = metrics().to_prometheus().encode()
                        self._send(200, body, "text/plain; version=0.0.4")
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
                    LOG.warning("web handler failed", exc_info=True)
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, route: str):
                if route == "/api/v1/master/info":
                    import time as _time

                    return {
                        "cluster_id": mp.cluster_id,
                        "cluster_name": mp._conf.get(Keys.CLUSTER_NAME),
                        "start_time_ms": mp.start_time_ms,
                        "uptime_ms": max(0, int(_time.time() * 1000)
                                         - mp.start_time_ms),
                        "safe_mode": mp.in_safe_mode(),
                        "rpc_port": mp.rpc_port,
                        "live_workers": len(
                            mp.block_master.get_worker_infos()),
                    }
                if route == "/api/v1/master/capacity":
                    workers = mp.block_master.get_worker_infos(
                        include_lost=True)
                    return {
                        "capacity": mp.block_master.capacity_bytes_on_tiers(),
                        "used": mp.block_master.used_bytes_on_tiers(),
                        "workers": [{
                            "id": w.id,
                            "host": w.address.host,
                            "state": w.state,
                            "capacity": dict(w.capacity_bytes_on_tiers),
                            "used": dict(w.used_bytes_on_tiers),
                        } for w in workers],
                    }
                if route == "/api/v1/master/metrics":
                    from alluxio_tpu_torch.metrics import metrics

                    snap = metrics().snapshot()
                    mm = getattr(mp, "metrics_master", None)
                    if mm is not None:
                        snap = mm.merged_snapshot(snap)
                    return {"metrics": snap}
                if route == "/api/v1/master/masters":
                    return mp.masters_report()
                if route == "/api/v1/master/metrics/history":
                    mm = getattr(mp, "metrics_master", None)
                    if mm is None or mm.history is None:
                        return {"error": "metrics history is disabled",
                                "series": [], "names": []}
                    return mm.history_report(self.query)
                if route == "/api/v1/master/health":
                    hm = getattr(mp, "health_monitor", None)
                    if hm is None:
                        return {"status": "DISABLED", "alerts": [],
                                "pending": [], "recently_resolved": [],
                                "rules": []}
                    resp = hm.fresh_report()
                    engine = getattr(mp, "remediation", None)
                    if engine is not None:
                        resp["remediation"] = engine.report()
                    return resp
                if route == "/api/v1/master/remediation":
                    engine = getattr(mp, "remediation", None)
                    if engine is None:
                        return {"enabled": False, "audit": [],
                                "quarantined": [], "overlay": {}}
                    return engine.report()
                if route == "/api/v1/master/metastore":
                    return {"stats": dict(
                        mp.fs_master.metastore_stats())}
                if route == "/api/v1/master/mounts":
                    return {"mounts": [
                        {"path": m.alluxio_path, "ufs": m.ufs_uri,
                         "read_only": m.read_only}
                        for m in
                        mp.fs_master.mount_table.mount_points()]}
                if route == "/api/v1/master/catalog":
                    tm = mp.table_master
                    return {"databases": {
                        db: tm.list_tables(db)
                        for db in tm.list_databases()}}
                if route == "/api/v1/master/trace":
                    from alluxio_tpu_torch.utils.tracing import (
                        stitch_spans, tracer,
                    )

                    mm = getattr(mp, "metrics_master", None)
                    stitched = stitch_spans(
                        mm.traces if mm is not None else None,
                        limit=int(self.query.get("limit", "500") or 500),
                        prefix=self.query.get("prefix", ""),
                        trace_id=self.query.get("trace_id", ""),
                        local_source="master")
                    if self.query.get("fanout"):
                        from alluxio_tpu_torch.utils.trace_fanout import (
                            merge_stitched, peer_traces)
                        stitched = merge_stitched(
                            stitched, peer_traces(
                                mp._conf,
                                limit=int(self.query.get("limit", "500")
                                          or 500),
                                prefix=self.query.get("prefix", ""),
                                trace_id=self.query.get("trace_id", "")))
                    return {"enabled": tracer().enabled, **stitched}
                if route == "/api/v1/master/profile":
                    mm = getattr(mp, "metrics_master", None)
                    if mm is None:
                        return {"sources": {}}
                    return mm.flame_report(
                        self.query.get("source", ""))
                if route == "/api/v1/master/trace/profile":
                    from alluxio_tpu_torch.utils.critical_path import (
                        analyze_trace, profile)
                    from alluxio_tpu_torch.utils.tracing import (
                        stitch_spans, tracer,
                    )

                    mm = getattr(mp, "metrics_master", None)
                    trace_id = self.query.get("trace_id", "")
                    stitched = stitch_spans(
                        mm.traces if mm is not None else None,
                        limit=int(self.query.get("limit", "4000")
                                  or 4000),
                        prefix=self.query.get("prefix", ""),
                        trace_id=trace_id,
                        local_source="master")
                    if trace_id:
                        return {"enabled": tracer().enabled,
                                "critical_path":
                                    analyze_trace(stitched["spans"])}
                    return {"enabled": tracer().enabled,
                            "profile": profile(
                                stitched["spans"],
                                root_prefix=self.query.get(
                                    "root_prefix", ""))}
                if route == "/api/v1/master/browse":
                    path = self.query.get("path", "/") or "/"
                    entries = mp.fs_master.list_status(path, wire=True)
                    return {"path": path, "entries": [{
                        "name": e["name"], "path": e["path"],
                        "folder": e["folder"], "length": e["length"],
                        "in_memory_percentage":
                            e["in_memory_percentage"],
                        "persistence_state": e["persistence_state"],
                        "pinned": e["pinned"], "owner": e["owner"],
                        "group": e["group"], "mode": oct(e["mode"]),
                        "block_count": len(e["block_ids"]),
                    } for e in entries]}
                if route == "/api/v1/master/config":
                    from alluxio_tpu_torch.conf.property_key import (
                        REGISTRY, mask_credential)

                    conf = mp._conf
                    # EFFECTIVE configuration: every registered key with
                    # its default, overlaid by whatever is actually set
                    # (reference: the webui Configuration page shows the
                    # full resolved table, not just overrides). Values of
                    # credential-flagged keys — and anything that LOOKS
                    # like a secret — are masked, never serialized
                    # (reference DisplayType.CREDENTIALS masking on the
                    # config webUI/REST endpoint).
                    out = {name: {"value": str(pk.default),
                                  "source": "DEFAULT"}
                           for name, pk in REGISTRY.all_keys().items()}
                    for k, v in conf.to_map().items():
                        out[k] = {"value": str(v),
                                  "source": conf.source(k).name}
                    for k, row in out.items():
                        row["value"] = mask_credential(k, row["value"])
                    return {"config": dict(sorted(out.items()))}
                if route == "/api/v1/master/logs":
                    from alluxio_tpu_torch.utils import weblog

                    n = int(self.query.get("n", "200") or 200)
                    return {"records": weblog.tail(
                        n, level=self.query.get("level", ""))}
                return None

        self._server = ThreadingHTTPServer((bind_host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        from alluxio_tpu_torch.utils import weblog

        weblog.install()  # /logs serves this in-process ring
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="master-web", daemon=True)
        self._thread.start()
        LOG.info("master web endpoint on port %d", self.port)
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
