"""FileSystemAdminShell: ``alluxio-tpu fsadmin <command>``.

A copy of ``alluxio_tpu/shell/fsadmin_shell.py``.

Re-design of ``shell/src/main/java/alluxio/cli/fsadmin/
{FileSystemAdminShell.java,command/*,report/*,doctor/*}``: cluster report,
doctor checks, journal checkpoint, and UFS listing for operators.
"""

from __future__ import annotations

import sys
import time

from alluxio_tpu_torch.conf import Source
from alluxio_tpu_torch.shell.command import (
    Command, CommandError, Shell, human_size, sparkline,
)

ADMIN_SHELL = Shell("fsadmin", "Administer the alluxio-tpu cluster.")


@ADMIN_SHELL.register
class ReportCommand(Command):
    name = "report"
    description = ("Report cluster summary|capacity|ufs|metrics|"
                   "jobservice|stall|readpath|history|health|qos|"
                   "masters.")

    def configure(self, p):
        p.add_argument("category", nargs="?", default="summary",
                       choices=["summary", "capacity", "ufs", "metrics",
                                "jobservice", "stall", "readpath",
                                "history", "health", "qos", "masters",
                                "metastore"])
        p.add_argument("metric", nargs="?", default="",
                       help="history: metric name (omit to list "
                            "recorded names)")
        p.add_argument("--source", default="",
                       help="history: only this reporting source")
        p.add_argument("--resolution", default="raw",
                       choices=["raw", "1m", "10m"],
                       help="history: sample tier to print")
        p.add_argument("--rate", action="store_true",
                       help="history: derive a per-second rate "
                            "(counters)")

    def run(self, args, ctx):
        if args.category == "history":
            return self._history(ctx, args)
        # history-only arguments must not be silently swallowed for the
        # other categories (`report metrics Worker.X` is a usage error,
        # not the full unfiltered dump)
        extras = [what for what, given in (
            (f"metric '{args.metric}'", args.metric),
            ("--source", args.source),
            ("--resolution", args.resolution != "raw"),
            ("--rate", args.rate)) if given]
        if extras:
            ctx.eprint(f"report {args.category} does not take "
                       f"{', '.join(extras)} (history-only)")
            return 2
        if args.category == "health":
            return self._health(ctx, args)
        return getattr(self, f"_{args.category}")(ctx)

    def _summary(self, ctx):
        info = ctx.meta_client().get_master_info()
        cap = ctx.block_client().get_capacity()
        workers = ctx.block_client().get_worker_infos(
            include_quarantined=True)
        started = time.strftime(
            "%m-%d-%Y %H:%M:%S",
            time.localtime(info.get("start_time_ms", 0) / 1000))
        uptime_s = max(0, time.time() - info.get("start_time_ms", 0) / 1000)
        ctx.print("Alluxio-TPU cluster summary:")
        ctx.print(f"    Master Address: {ctx.master_address}")
        ctx.print(f"    Cluster Id: {info.get('cluster_id', '')}")
        ctx.print(f"    Started: {started}")
        ctx.print(f"    Uptime: {int(uptime_s)}s")
        ctx.print(f"    Safe Mode: {info.get('safe_mode', False)}")
        quarantined = sum(1 for w in workers if w.state == "QUARANTINED")
        ctx.print(f"    Live Workers: {len(workers)}"
                  + (f" ({quarantined} quarantined)"
                     if quarantined else ""))
        total = sum(cap["capacity"].values())
        used = sum(cap["used"].values())
        ctx.print(f"    Total Capacity: {human_size(total)}")
        for tier, n in sorted(cap["capacity"].items()):
            ctx.print(f"        Tier: {tier}  Size: {human_size(n)}")
        ctx.print(f"    Used Capacity: {human_size(used)}")
        for tier, n in sorted(cap["used"].items()):
            ctx.print(f"        Tier: {tier}  Size: {human_size(n)}")
        pct = (100.0 * used / total) if total else 0.0
        ctx.print(f"    Free Capacity: {human_size(total - used)} "
                  f"({100 - pct:.1f}% free)")
        return 0

    def _masters(self, ctx):
        """HA quorum view (docs/ha.md): one row per known master —
        role, term, last-applied journal sequence, lag behind the
        furthest member, tailer lag and last contact.  Exits nonzero
        when no primary is visible: a scriptable 'is failover stuck'
        probe."""
        report = ctx.meta_client().get_masters()
        leader = report.get("leader")
        masters = report.get("masters", [])
        ctx.print(f"Masters ({len(masters)} known, "
                  f"leader: {leader or 'NONE'}):")
        ctx.print(f"    {'Address':<24s} {'Role':>8s} {'Term':>6s} "
                  f"{'Applied':>10s} {'Lag':>6s} {'Tailer':>8s} "
                  f"{'Contact':>8s}")
        for m in sorted(masters, key=lambda r: r.get("address", "")):
            # EMBEDDED members without a registry row (per-folder
            # registries): the leader still knows how far they have
            # replicated — show match_index rather than a blank
            seq = m.get("sequence")
            if seq is None:
                seq = m.get("match_index")
            lag = m.get("lag_entries")
            tailer = m.get("tailer_lag_s")
            contact = m.get("last_contact_s")
            mark = " *" if m.get("address") == leader else ""
            ctx.print(
                f"    {str(m.get('address', '?')) + mark:<24s} "
                f"{m.get('role', '?'):>8s} "
                f"{m.get('term', '-'):>6} "
                f"{seq if seq is not None else '-':>10} "
                f"{lag if lag is not None else '-':>6} "
                f"{f'{tailer:.1f}s' if tailer is not None else '-':>8s} "
                f"{f'{contact:.1f}s' if contact is not None else '-':>8s}")
        has_primary = any(m.get("role") == "PRIMARY" for m in masters)
        if not has_primary:
            ctx.eprint("WARN: no PRIMARY visible — failover in "
                       "progress or quorum lost (docs/ha.md)")
        return 0 if has_primary else 1

    def _capacity(self, ctx):
        workers = ctx.block_client().get_worker_infos(
            include_lost=True, include_quarantined=True)
        ctx.print(f"{'Worker Name':<28s} {'Last Heartbeat':>14s} "
                  f"{'Storage':>9s} {'Total':>12s} {'Used':>12s} "
                  f"{'State':>8s}")
        for w in workers:
            first = True
            tiers = sorted(set(list(w.capacity_bytes_on_tiers)
                               + list(w.used_bytes_on_tiers)))
            for tier in tiers or ["-"]:
                total = w.capacity_bytes_on_tiers.get(tier, 0)
                used = w.used_bytes_on_tiers.get(tier, 0)
                namecol = (f"{w.address.host}:{w.address.rpc_port}"
                           if first else "")
                ctx.print(f"{namecol:<28s} "
                          f"{w.last_contact_ms if first else '':>14} "
                          f"{tier:>9s} {human_size(total):>12s} "
                          f"{human_size(used):>12s} "
                          f"{(w.state if first else ''):>8}")
                first = False
        return 0

    def _ufs(self, ctx):
        for m in ctx.fs_client().get_mount_points():
            props = " ".join(f"{k}={v}" for k, v in m.properties.items())
            flags = []
            if m.read_only:
                flags.append("readonly")
            if m.shared:
                flags.append("shared")
            ctx.print(f"{m.ufs_uri} on {m.alluxio_path} "
                      f"(type={m.ufs_type or 'unknown'}"
                      + (", " + ", ".join(flags) if flags else "")
                      + (f", {props}" if props else "") + ")")
        return 0

    def _metrics(self, ctx):
        snap = ctx.meta_client().get_metrics()
        for k in sorted(snap):
            ctx.print(f"{k}  {snap[k]}")
        dropped = snap.get("Master.MetricsReportsDropped", 0)
        if dropped:
            ctx.print(f"WARN: {int(dropped)} metric reports dropped by "
                      f"the source cap — raise "
                      f"atpu.master.metrics.max.sources or hunt the "
                      f"source-name flood")
        blocked = snap.get("Master.MetricsReportsBlocked", 0)
        if blocked:
            ctx.print(f"WARN: {int(blocked)} metric reports refused "
                      f"from lost workers that never re-registered — "
                      f"run `fsadmin report health` and restart or "
                      f"remove the dead workers")
        repl_failed = snap.get("Master.ReplicationJobsFailed", 0)
        if repl_failed:
            ctx.print(f"WARN: {int(repl_failed)} replication job "
                      f"launches failed — is the job service up? "
                      f"deficits persist until launches succeed")
        repl_deferred = snap.get("Master.ReplicationJobsDeferred", 0)
        if repl_deferred:
            ctx.print(f"WARN: {int(repl_deferred)} replication jobs "
                      f"deferred by the in-flight cap "
                      f"(atpu.master.replication.max.inflight; "
                      f"currently "
                      f"{int(snap.get('Master.ReplicationJobsInflight', 0))}"
                      f" in flight) — expected during mass recovery, "
                      f"raise the cap if it never drains")
        native_fb = snap.get("Cluster.NativeFallbacks", 0)
        if native_fb:
            ctx.print(f"WARN: {int(native_fb)} native fastpath batches "
                      f"fell back to the pure-Python read path — a "
                      f"client without a working g++ toolchain loses "
                      f"the GIL-free plan executor quietly; check "
                      f"client hosts against docs/native.md, or set "
                      f"atpu.user.native.fastpath.enabled=false if "
                      f"that is intended")
        shed = snap.get("Master.RpcAdmissionShed", 0)
        if shed:
            # next to the other drop counters on purpose: shed RPCs
            # are load shedding working as designed, but the operator
            # reading drop counts must see them in the same place
            ctx.print(f"WARN: {int(shed)} RPCs shed by admission "
                      f"control (a principal exceeded "
                      f"atpu.master.rpc.admission.rate) — run "
                      f"`fsadmin report qos` for the per-principal "
                      f"breakdown; shed calls are also audit-logged "
                      f"with allowed=false")
        return 0

    def _qos(self, ctx):
        """Multi-tenant QoS posture: admission-control state with the
        per-principal admitted/shed table, plus every Worker.Qos* /
        Client.Qos* metric the cluster aggregates."""
        resp = ctx.meta_client().get_qos()
        adm = resp.get("admission", {})
        if not adm.get("enabled"):
            ctx.print("RPC admission control: DISABLED "
                      "(atpu.master.rpc.admission.enabled)")
        else:
            ctx.print(f"RPC admission control: rate "
                      f"{adm['rate_per_s']:g}/s per principal, burst "
                      f"{adm['burst']:g}, "
                      f"{int(adm.get('admitted_total', 0))} admitted / "
                      f"{int(adm.get('shed_total', 0))} shed")
            ctx.print(f"    exempt methods: "
                      f"{', '.join(adm.get('exempt', [])) or '(none)'}")
            rows = adm.get("principals", [])
            if rows:
                ctx.print(f"    {'principal':<24s} {'admitted':>10s} "
                          f"{'shed':>10s}")
                for r in rows:
                    ctx.print(f"    {r['principal']:<24s} "
                              f"{r['admitted']:>10d} {r['shed']:>10d}"
                              + ("   << throttled" if r["shed"] else ""))
            if adm.get("bucket_evictions"):
                ctx.print(f"    WARN: {adm['bucket_evictions']} "
                          f"principal buckets evicted by the "
                          f"max.principals cap — a principal flood is "
                          f"churning the limiter")
        qos_metrics = resp.get("metrics", {})
        if qos_metrics:
            ctx.print("QoS metrics (cluster-wide):")
            for k in sorted(qos_metrics):
                ctx.print(f"    {k}  {qos_metrics[k]}")
        else:
            ctx.print("No Worker.Qos*/Client.Qos* metrics reported — "
                      "enable atpu.worker.qos.enabled / "
                      "atpu.user.qos.stripe.limit to activate "
                      "data-plane QoS")
        return 0

    def _metastore(self, ctx):
        """Inode metastore posture (docs/metadata.md): backend kind and
        population for every backend; on LSM additionally the write
        path (memtable fill, WAL) and the read-amplification drivers
        (sorted runs, compaction debt) the metastore-compaction-debt
        health rule watches, plus the caching wrapper's hit ratio."""
        stats = ctx.meta_client().get_metastore_info().get("stats", {})
        if not stats:
            ctx.print("No metastore stats reported by this master")
            return 1
        ctx.print(f"Inode metastore: {stats.get('kind', '?')}")
        ctx.print(f"    Inodes: {int(stats.get('inodes', 0)):,}")
        if "cache_hit_ratio" in stats:
            ctx.print(f"    Hot-set cache: {int(stats.get('cache_entries', 0)):,} "
                      f"entries, hit ratio "
                      f"{float(stats.get('cache_hit_ratio', 0.0)):.2%} "
                      f"({int(stats.get('cache_hits', 0)):,} hits / "
                      f"{int(stats.get('cache_misses', 0)):,} misses)")
        if "memtable_bytes" in stats:
            ctx.print(f"    Memtable: {human_size(int(stats.get('memtable_bytes', 0)))} "
                      f"({int(stats.get('memtable_entries', 0)):,} entries), "
                      f"WAL {human_size(int(stats.get('wal_bytes', 0)))}")
            ctx.print(f"    Sorted runs: {int(stats.get('runs', 0))} "
                      f"({human_size(int(stats.get('run_bytes', 0)))} on disk)")
            ctx.print(f"    Flushes: {int(stats.get('flushes', 0))}  "
                      f"Compactions: {int(stats.get('compactions', 0))} "
                      f"({human_size(int(stats.get('compaction_bytes', 0)))} "
                      f"rewritten)")
        if "edges" in stats:
            ctx.print(f"    Edges: {int(stats.get('edges', 0)):,}")
        return 0

    def _history(self, ctx, args):
        """Time-resolved view of one metric: ASCII sparkline over the
        requested resolution plus a rollup table per reporting
        source."""
        mc = ctx.meta_client()
        if not args.metric:
            # same no-silent-swallow rule as run() applies across
            # categories: list mode ignores the series filters, so
            # accepting them would print the full unfiltered name
            # list as if they had applied
            extras = [what for what, given in (
                ("--source", args.source),
                ("--resolution", args.resolution != "raw"),
                ("--rate", args.rate)) if given]
            if extras:
                ctx.eprint(f"report history without a metric name "
                           f"lists recorded metrics and does not take "
                           f"{', '.join(extras)}")
                return 2
            resp = mc.get_metrics_history()
            st = resp.get("stats", {})
            ctx.print(f"{len(resp.get('names', []))} metrics recorded "
                      f"({st.get('series', 0)}/{st.get('max_series', 0)}"
                      f" series, {st.get('points', 0)} points)")
            for n in resp.get("names", []):
                ctx.print(f"    {n}")
            if st.get("dropped_samples"):
                ctx.print(f"WARN: {st['dropped_samples']} samples "
                          f"dropped by the series cap/allowlist")
            return 0
        resp = mc.get_metrics_history(
            args.metric, source=args.source,
            resolution=args.resolution, rate=args.rate)
        series = resp.get("series", [])
        if not series:
            ctx.print(f"no history recorded for '{args.metric}'"
                      + (f" from source '{args.source}'"
                         if args.source else ""))
            return 1
        suffix = "/s" if args.rate else ""
        for s in series:
            pts = s["points"]
            if s["resolution"] == "raw" or args.rate:
                values = [v for _, v in pts]
            else:
                values = [b["mean"] for b in pts]
            head = (f"{s['name']} [{s['source']}] "
                    f"({s['resolution']}, {len(pts)} points)")
            if s.get("ended_at"):
                head += "  [source ENDED — worker lost]"
            ctx.print(head)
            if not values:
                ctx.print("    (empty window)")
                continue
            ctx.print(f"    {sparkline(values)}")
            if s["resolution"] == "raw" or args.rate:
                lo, hi, last = min(values), max(values), values[-1]
            else:
                # true per-bucket extremes and final value, not the
                # means the sparkline plots — a one-bucket spike must
                # not understate the headline max, and the headline
                # last must match the rollup table's last column below
                lo = min(b["min"] for b in pts)
                hi = max(b["max"] for b in pts)
                last = pts[-1]["last"]
            ctx.print(f"    min={lo:.4g}{suffix} "
                      f"max={hi:.4g}{suffix} "
                      f"last={last:.4g}{suffix}")
            if s["resolution"] != "raw" and not args.rate:
                ctx.print(f"    {'bucket':<21s} {'count':>6s} "
                          f"{'mean':>10s} {'min':>10s} {'max':>10s} "
                          f"{'last':>10s}")
                for b in pts[-12:]:
                    when = time.strftime("%m-%d %H:%M:%S",
                                         time.localtime(b["ts"]))
                    ctx.print(f"    {when:<21s} {b['count']:>6d} "
                              f"{b['mean']:>10.4g} {b['min']:>10.4g} "
                              f"{b['max']:>10.4g} {b['last']:>10.4g}")
        return 0

    def _health(self, ctx, args):
        """Ranked verdicts from the master's continuous health-rule
        engine (the cluster doctor)."""
        resp = ctx.meta_client().get_health()
        ctx.print(f"Cluster health: {resp['status']}")
        alerts = resp.get("alerts", [])
        for a in alerts:
            dur = ""
            if a.get("fired_at") and resp.get("evaluated_at"):
                dur = (f" (firing "
                       f"{max(0, resp['evaluated_at'] - a['fired_at']):.0f}s)")
            ctx.print(f"  [{a['severity'].upper()}] {a['rule']} "
                      f"on {a['subject']}{dur}")
            ctx.print(f"      {a['summary']}")
            ctx.print(f"      value {a['value']:.4g} vs threshold "
                      f"{a['threshold']:.4g} over {a['window_s']:.0f}s")
            ctx.print(f"      remediation: {a['remediation']}")
        for a in resp.get("pending", []):
            ctx.print(f"  [pending] {a['rule']} on {a['subject']}: "
                      f"{a['summary']}")
        for a in resp.get("recently_resolved", []):
            ctx.print(f"  [resolved] {a['rule']} on {a['subject']}")
        if not alerts:
            ctx.print(f"  no alerts firing — "
                      f"{len(resp.get('rules', []))} rules watching")
        self._remediation(ctx, resp.get("remediation"))
        return 0 if resp["status"] in ("OK", "WARN") else 1

    @staticmethod
    def _remediation(ctx, rem):
        """Self-healing timeline: every audit row is one
        cause -> action -> resolution line, so the operator reads what
        the engine did (or would do, in dry-run) and why, in order."""
        if not rem:
            return  # engine disabled: report is byte-identical to PR-5
        mode = "DRY-RUN" if rem.get("dry_run") else "active"
        ctx.print(f"Self-healing ({mode}): "
                  f"{rem.get('actions_in_window', 0)}/"
                  f"{rem.get('max_actions_per_window', 0)} actions in "
                  f"window, {len(rem.get('quarantined', []))} "
                  f"quarantined, {len(rem.get('overlay', {}))} tuning "
                  f"overlay key(s) pushed")
        for q in rem.get("quarantined", []):
            state = "probation" if q.get("probation_since") else \
                "quarantined"
            ctx.print(f"  [{state}] {q['subject']} "
                      f"(cause: {q['rule']})")
        for k, v in sorted(rem.get("overlay", {}).items()):
            ctx.print(f"  [overlay] {k} = {v}")
        audit = rem.get("audit", [])
        for a in audit[-12:]:
            when = time.strftime("%m-%d %H:%M:%S",
                                 time.localtime(a["at"]))
            resolution = ""
            if a.get("reverted_at"):
                resolution = (" -> reverted "
                              + time.strftime(
                                  "%H:%M:%S",
                                  time.localtime(a["reverted_at"])))
            elif a.get("resolved_at"):
                resolution = " -> alert resolved"
            ctx.print(f"  {when}  {a['rule']} on {a['subject']} -> "
                      f"{a['action']} [{a['outcome']}]{resolution}")
            ctx.print(f"      {a['summary']}")
        if not audit:
            ctx.print("  no actions audited yet")

    def _stall(self, ctx):
        """Input doctor: ranked per-tier attribution of loader input
        waits (``Client.InputStall*`` metrics, shipped to the master on
        the metrics heartbeat and summed into ``Cluster.*``)."""
        snap = ctx.meta_client().get_metrics()

        def bucket_stats(kind):
            # prefer the cluster roll-up (sums every reporting client);
            # fall back to this master's own Client.* metrics (the
            # in-process / single-node case)
            out = {}
            for prefix in (f"Cluster.InputStall{kind}.",
                           f"Client.InputStall{kind}."):
                for k, v in snap.items():
                    if k.startswith(prefix):
                        out[k[len(prefix):]] = v
                if out:
                    return out
            return out

        waits_us = bucket_stats("Us")
        counts = bucket_stats("Count")
        sizes = bucket_stats("Bytes")
        total_s = sum(waits_us.values()) / 1e6
        ctx.print("Input-stall attribution (input doctor):")
        if not waits_us:
            ctx.print("    no input-stall samples recorded — run a "
                      "DeviceBlockLoader epoch with metrics collection "
                      "enabled (atpu.user.metrics.collection.enabled)")
            # table reads stall no loader; their route split still tells
            # whether planned projections landed on the fast planes
            self._stall_table_routes(ctx, snap)
            return 0
        ctx.print(f"    {'tier':<10s} {'waits':>8s} {'stalled':>12s} "
                  f"{'bytes':>12s} {'share':>7s}")
        named_s = 0.0
        for b, us in sorted(waits_us.items(), key=lambda kv: -kv[1]):
            s = us / 1e6
            if b != "unknown":
                named_s += s
            share = (100.0 * s / total_s) if total_s else 0.0
            ctx.print(f"    {b:<10s} {int(counts.get(b, 0)):>8d} "
                      f"{s:>11.3f}s "
                      f"{human_size(int(sizes.get(b, 0))):>12s} "
                      f"{share:>6.1f}%")
        attributed = (100.0 * named_s / total_s) if total_s else 100.0
        ctx.print(f"    attributed to a named tier: {attributed:.1f}% "
                  f"of {total_s:.3f}s total wait")
        # op-size columns: the same stalls re-cut by read size — a
        # le4k-dominated profile is per-op RPC overhead (see
        # `report readpath`), not bandwidth
        size_us = bucket_stats("SizeUs")
        size_counts = bucket_stats("SizeCount")
        if size_us:
            from alluxio_tpu_torch.metrics.stall import SIZE_BUCKETS

            ctx.print(f"    {'op size':<10s} {'waits':>8s} "
                      f"{'stalled':>12s} {'share':>7s}")
            for b in SIZE_BUCKETS:
                us = size_us.get(b)
                if not us:
                    continue
                s = us / 1e6
                share = (100.0 * s / total_s) if total_s else 0.0
                ctx.print(f"    {b:<10s} "
                          f"{int(size_counts.get(b, 0)):>8d} "
                          f"{s:>11.3f}s {share:>6.1f}%")
        # the small-read plane check: the le4k row re-cut by serving
        # tier. All-shm means the zero-copy plane landed; remote-heavy
        # means batching/co-location is the lever (docs/small_reads.md)
        cross_us = bucket_stats("CrossUs")
        cross_counts = bucket_stats("CrossCount")
        le4k = {k.split(".")[0]: v for k, v in cross_us.items()
                if k.endswith(".le4k") and v}
        if le4k:
            le4k_s = sum(le4k.values()) / 1e6
            ctx.print(f"    le4k by tier (shm vs remote vs ufs, "
                      f"{le4k_s:.3f}s):")
            for t, us in sorted(le4k.items(), key=lambda kv: -kv[1]):
                s = us / 1e6
                share = (100.0 * us / sum(le4k.values()))
                n = int(cross_counts.get(f"{t}.le4k", 0))
                ctx.print(f"      {t:<8s} {n:>8d} {s:>11.3f}s "
                          f"{share:>6.1f}%")
        self._stall_table_routes(ctx, snap)
        # cluster mean first (the fleet view, averaged across reporting
        # clients); the master's own gauge only exists when a loader
        # ran in-process and would shadow the fleet with a stale 0.0
        frac = snap.get("Cluster.InputBoundFraction",
                        snap.get("Client.InputBoundFraction"))
        if frac is not None:
            ctx.print(f"    rolling input-bound fraction: {frac:.2f}")
        top = max(waits_us, key=waits_us.get)
        from alluxio_tpu_torch.metrics.stall import BUCKET_ADVICE

        share = (100.0 * waits_us[top] / 1e6 / total_s) if total_s else 0.0
        ctx.print(f"Verdict: top bottleneck is '{top}' ({share:.0f}% of "
                  f"stall) — "
                  f"{BUCKET_ADVICE.get(top, 'no advice for this tier')}")
        return 0

    @staticmethod
    def _stall_table_routes(ctx, snap):
        # the table-read plane check: planned projection bytes re-cut by
        # serving route. shm-heavy means same-host zero-copy landed;
        # stream-heavy means the range executor never engaged the batch
        # or striped planes (docs/table_reads.md)
        route_bytes = {}
        for prefix in ("Cluster.TableProjectionRouteBytes.",
                       "Client.TableProjectionRouteBytes."):
            for k, v in snap.items():
                if k.startswith(prefix) and v:
                    route_bytes[k[len(prefix):]] = v
            if route_bytes:
                break
        if route_bytes:
            route_total = sum(route_bytes.values())
            ctx.print(f"    table projection by route "
                      f"({human_size(route_total)} planned):")
            for r, nbytes in sorted(route_bytes.items(),
                                    key=lambda kv: -kv[1]):
                share = 100.0 * nbytes / route_total
                ctx.print(f"      {r:<8s} {human_size(int(nbytes)):>12s} "
                          f"{share:>6.1f}%")

    def _readpath(self, ctx):
        """Read-path microscope: ranked per-phase critical-path profile
        over the master's sampled traces (``get_trace_profile``). Run
        with tracing on (``fsadmin trace --on``) while a workload
        reads — the table names what each read was actually blocked
        on, phase by phase (docs/observability.md)."""
        resp = ctx.meta_client().get_trace_profile(root_prefix="atpu.")
        if not resp.get("enabled"):
            ctx.eprint("tracing is off — enable with "
                       "`fsadmin trace --on`, run the workload, then "
                       "re-run this report")
        prof = resp.get("profile") or {}
        n = prof.get("traces_analyzed", 0)
        ctx.print(f"Read-path critical-path profile "
                  f"({n} traces analyzed):")
        if not n:
            ctx.print("    no complete traces stitched yet — spans "
                      "arrive on the metrics heartbeat; wait one "
                      "interval and retry")
            return 0
        ctx.print(f"    wall: total {prof['wall_ms_total']:.1f} ms, "
                  f"p50 {prof['wall_ms_p50']:.2f} ms, "
                  f"p99 {prof['wall_ms_p99']:.2f} ms; "
                  f"{prof['attributed_pct']:.1f}% attributed to "
                  f"named phases")
        ctx.print(f"    {'span/phase':<48s} {'count':>6s} "
                  f"{'total':>10s} {'p50':>8s} {'p99':>8s} "
                  f"{'share':>7s}")
        for row in prof.get("phases", ()):
            ctx.print(f"    {row['key']:<48s} {row['count']:>6d} "
                      f"{row['total_ms']:>8.1f}ms "
                      f"{row['p50_ms']:>6.2f}ms "
                      f"{row['p99_ms']:>6.2f}ms "
                      f"{row['pct']:>6.1f}%")
        return 0

    def _jobservice(self, ctx):
        """Job-service health + activity (reference ``fsadmin report
        jobservice``, ``cli/fsadmin/report/
        JobServiceMetricsCommand.java``)."""
        jc = ctx.job_client()
        workers = jc.list_workers()
        ctx.print(f"Job workers: {len(workers)}")
        for w in sorted(workers, key=lambda w: w["worker_id"]):
            h = w.get("health") or {}
            ctx.print(
                f"  {w['hostname']} (id={w['worker_id']}): "
                f"active {h.get('num_active_tasks', 0)}/"
                f"{h.get('task_pool_size', 0)} tasks, "
                f"{h.get('unfinished_tasks', 0)} unfinished, "
                f"load {h.get('load_avg', 0.0):.2f}")
        jobs = jc.list_jobs()
        by_status: dict = {}
        for j in jobs:
            by_status[j.status] = by_status.get(j.status, 0) + 1
        ctx.print("Status: " + (", ".join(
            f"{s}={n}" for s, n in sorted(by_status.items()))
            or "(no jobs)"))
        newest = sorted(jobs, key=lambda j: j.last_updated_ms,
                        reverse=True)[:10]
        for j in newest:
            err = f" error={j.error_message}" if j.error_message else ""
            ctx.print(f"  job {j.job_id} {j.name or '?'}: "
                      f"{j.status}{err}")
        return 0


@ADMIN_SHELL.register
class DoctorCommand(Command):
    name = "doctor"
    description = "Show configuration and cluster health warnings."

    def configure(self, p):
        p.add_argument("category", nargs="?", default="configuration",
                       choices=["configuration"])

    def run(self, args, ctx):
        # cluster-wide consistency report (ServerConfigurationChecker);
        # degrade gracefully against masters without the RPC
        try:
            report = ctx.meta_client().get_config_report()
        except Exception:  # noqa: BLE001
            report = {"status": "UNAVAILABLE", "errors": [], "warns": []}
        ctx.print(f"Server-side configuration check: {report['status']}")
        for e in report.get("errors", []):
            ctx.print(f"ERROR: {e}")
        for w in report.get("warns", []):
            ctx.print(f"WARN: {w}")
        # local-vs-cluster diff
        server_conf = ctx.meta_client().get_configuration()
        server = server_conf.get("properties", {})
        local = ctx.conf.to_map(min_source=Source.SITE_PROPERTY)
        issues = 0
        for key, val in sorted(server.items()):
            mine = local.get(key)
            if mine is not None and str(mine) != str(val):
                ctx.print(f"WARN: {key} differs: server='{val}' "
                          f"client='{mine}'")
                issues += 1
        if issues == 0 and report["status"] == "PASSED":
            ctx.print("No configuration conflicts found.")
        # quorum health (EMBEDDED journal only; silent elsewhere)
        try:
            q = ctx.meta_client().get_quorum_info()
        except Exception:  # noqa: BLE001 - LOCAL/UFS journal
            q = None
        if q is not None:
            ctx.print(f"Quorum: leader={q['leader']} term={q['term']} "
                      f"members={len(q['members'])}")
            # match_index is only meaningful on a settled LEADER (it
            # resets to 0 at election and is absent on followers) —
            # lag analysis from any other respondent is a false alarm
            me = next((m for m in q["members"]
                       if m["address"] == "self"), None)
            if me is not None and me["role"] == "LEADER":
                for m in q["members"]:
                    if m is me:
                        continue
                    if m["match_index"] + 50 < q["commit_index"]:
                        ctx.print(
                            f"WARN: quorum member {m['node_id']} lags "
                            f"{q['commit_index'] - m['match_index']} "
                            f"entries behind the commit index")
        # process stall telemetry (pause monitor)
        try:
            metrics = ctx.meta_client().get_metrics()
            pauses = metrics.get("Process.SeverePauses", 0)
            maxp = metrics.get("Process.MaxPauseSeconds", 0.0)
            if pauses or (maxp and maxp >= 1.0):
                ctx.print(f"WARN: master stalled (max pause "
                          f"{maxp:.2f}s, severe pauses {int(pauses)}) — "
                          f"GC/CFS/host pressure can trip elections")
        except Exception:  # noqa: BLE001
            pass
        return 0 if report["status"] != "FAILED" else 1


@ADMIN_SHELL.register
class PathConfCommand(Command):
    name = "pathConf"
    description = "Manage per-path configuration defaults."

    def configure(self, p):
        sub = p.add_subparsers(dest="op", required=True)
        sub.add_parser("list")
        show = sub.add_parser("show")
        show.add_argument("path")
        add = sub.add_parser("add")
        add.add_argument("--property", action="append", default=[],
                         dest="props", help="key=value (repeatable)")
        add.add_argument("path")
        rm = sub.add_parser("remove")
        rm.add_argument("--keys", default=None,
                        help="comma-separated keys (all when omitted)")
        rm.add_argument("path")

    def run(self, args, ctx):
        mc = ctx.meta_client()
        if args.op == "list":
            for path in sorted(mc.get_path_conf()["properties"]):
                ctx.print(path)
        elif args.op == "show":
            props = mc.get_path_conf()["properties"].get(args.path, {})
            for k in sorted(props):
                ctx.print(f"{k}={props[k]}")
        elif args.op == "add":
            kv = {}
            for p in args.props:
                if "=" not in p:
                    raise CommandError(
                        f"--property must be key=value, got {p!r}")
                k, _, v = p.partition("=")
                kv[k] = v
            mc.set_path_conf(args.path, kv)
            ctx.print(f"Properties of path {args.path} updated")
        elif args.op == "remove":
            keys = args.keys.split(",") if args.keys else None
            mc.remove_path_conf(args.path, keys)
            ctx.print(f"Properties of path {args.path} removed")
        return 0


@ADMIN_SHELL.register
class JournalCommand(Command):
    name = "journal"
    description = "Journal operations: checkpoint | dump."

    def configure(self, p):
        p.add_argument("op", choices=["checkpoint", "dump", "quorum",
                                      "migrate"])
        p.add_argument("--folder", default=None,
                       help="journal dir for dump/migrate "
                            "(default: configured)")
        p.add_argument("--start", type=int, default=0)
        p.add_argument("--end", type=int, default=None)
        p.add_argument("--transfer", default="",
                       help="quorum: hand leadership to this member id")
        p.add_argument("--to", default="", choices=["", "EMBEDDED", "LOCAL"],
                       help="migrate: target journal flavor (OFFLINE — "
                            "stop every master first)")
        p.add_argument("--dest", default="",
                       help="migrate: destination journal folder "
                            "(default: same folder)")
        p.add_argument("--addresses", default="",
                       help="migrate to EMBEDDED: quorum member "
                            "addresses, comma separated (default: "
                            "atpu.master.embedded.journal.addresses)")
        p.add_argument("--member", default="",
                       help="migrate to LOCAL: source quorum member id "
                            "(default: the freshest)")

    def run(self, args, ctx):
        if args.op == "migrate":
            return self._migrate(args, ctx)
        if args.op == "checkpoint":
            ctx.meta_client().checkpoint()
            ctx.print("Successfully took a checkpoint on the primary master")
            return 0
        if args.op == "quorum":
            mc = ctx.meta_client()
            if args.transfer:
                resp = mc.transfer_quorum_leadership(args.transfer)
                ok = resp.get("transferred")
                ctx.print(f"leadership transfer to {args.transfer}: "
                          f"{'done' if ok else 'FAILED'}")
                return 0 if ok else 1
            info = mc.get_quorum_info()
            ctx.print(f"term {info['term']}  leader {info['leader']}  "
                      f"commit {info['commit_index']}")
            for m in info["members"]:
                ctx.print(f"  {m['node_id']:<24} {m['role']:<9} "
                          f"match={m['match_index']} ({m['address']})")
            return 0
        from alluxio_tpu_torch.conf import Keys
        from alluxio_tpu_torch.journal.tool import dump_journal

        folder = args.folder or str(ctx.conf.get(
            Keys.MASTER_JOURNAL_FOLDER))
        n = dump_journal(folder, ctx.out, start_seq=args.start,
                         end_seq=args.end)
        ctx.print(f"({n} entries)")
        return 0

    def _migrate(self, args, ctx):
        """Offline LOCAL/UFS <-> EMBEDDED conversion (reference:
        ``JournalUpgrader.java:61`` + JournalMigrationIntegrationTest)."""
        from alluxio_tpu_torch.conf import Keys
        from alluxio_tpu_torch.journal import migrate as mig

        folder = args.folder or str(ctx.conf.get(
            Keys.MASTER_JOURNAL_FOLDER))
        dest = args.dest or folder
        try:
            if args.to == "EMBEDDED":
                configured = ctx.conf.get(
                    Keys.MASTER_EMBEDDED_JOURNAL_ADDRESSES) or ""
                if isinstance(configured, (list, tuple)):
                    configured = ",".join(configured)
                addresses = [a.strip() for a in
                             (args.addresses or str(configured)).split(",")
                             if a.strip()]
                out = mig.local_to_embedded(folder, dest, addresses)
                ctx.print(
                    f"migrated LOCAL journal {folder} -> EMBEDDED "
                    f"{dest} ({len(out['members'])} members, checkpoint "
                    f"seq {out['checkpoint_seq']}, {out['entries']} "
                    f"tail entries)")
            elif args.to == "LOCAL":
                out = mig.embedded_to_local(folder, dest,
                                            node_id=args.member)
                ctx.print(
                    f"migrated EMBEDDED member {out['source_member']} "
                    f"-> LOCAL {dest} (checkpoint seq "
                    f"{out['checkpoint_seq']}, {out['entries']} tail "
                    f"entries)")
            else:
                ctx.print("journal migrate needs --to EMBEDDED|LOCAL")
                return 1
        except mig.MigrationError as e:
            ctx.print(f"migration failed: {e}")
            return 1
        return 0


@ADMIN_SHELL.register
class BackupCommand(Command):
    name = "backup"
    description = "Write a full metadata backup on the primary master."

    def configure(self, p):
        p.add_argument("directory", nargs="?", default=None)

    def run(self, args, ctx):
        resp = ctx.meta_client().backup(args.directory)
        ctx.print(f"Backup Host: {ctx.master_address}")
        ctx.print(f"Backup URI: {resp['backup_uri']}")
        ctx.print(f"Backup Entry Count: {resp['entry_count']}")
        return 0


@ADMIN_SHELL.register
class GetConfCommand(Command):
    name = "getConf"
    description = "Print cluster configuration (optionally one key)."

    def configure(self, p):
        p.add_argument("--source", action="store_true",
                       help="also print each property's source")
        p.add_argument("key", nargs="?")

    def run(self, args, ctx):
        from alluxio_tpu_torch.conf.property_key import mask_credential

        resp = ctx.meta_client().get_configuration(sources=args.source)
        props = resp["properties"]
        srcs = resp.get("sources") or {}
        # display surface: mask credential values (reference
        # DisplayType.CREDENTIALS handling in GetConfCommand)
        props = {k: mask_credential(k, v) for k, v in props.items()}
        if args.key:
            if args.key in props:
                suffix = (f"  (source: {srcs[args.key]})"
                          if args.key in srcs else "")
                ctx.print(f"{props[args.key]}{suffix}")
                return 0
            try:
                v = ctx.conf.get(args.key)
            except KeyError:
                v = None
            if v is None:
                ctx.eprint(f"{args.key} is not set")
                return 1
            ctx.print(mask_credential(args.key, v))
            return 0
        for k in sorted(props):
            suffix = f"  (source: {srcs[k]})" if k in srcs else ""
            ctx.print(f"{k}={props[k]}{suffix}")
        return 0


@ADMIN_SHELL.register
class MetricsCommand(Command):
    name = "metrics"
    description = "Print master metrics matching an optional filter."

    def configure(self, p):
        p.add_argument("filter", nargs="?", default="")

    def run(self, args, ctx):
        snap = ctx.meta_client().get_metrics()
        for k in sorted(snap):
            if args.filter in k:
                ctx.print(f"{k}  {snap[k]}")
        return 0


@ADMIN_SHELL.register
class LogLevelCommand(Command):
    name = "logLevel"
    description = ("Get or set the master's runtime log level "
                   "(reference: cli/LogLevel.java).")

    def configure(self, p):
        p.add_argument("--logName", default="",
                       help="logger name (default: root)")
        p.add_argument("--level", default="",
                       help="new level (DEBUG/INFO/WARNING/ERROR); "
                            "omit to read the current level")

    def run(self, args, ctx):
        mc = ctx.meta_client()
        if args.level:
            resp = mc.set_log_level(args.level, logger=args.logName)
            ctx.print(f"{resp['logger']} -> {resp['level']}")
        else:
            resp = mc.get_log_level(args.logName)
            ctx.print(f"{resp['logger']} = {resp['level']}")
        return 0


@ADMIN_SHELL.register
class TraceCommand(Command):
    name = "trace"
    description = ("Toggle span tracing and dump recent master spans "
                   "(spans also serve at /api/v1/master/trace).")

    def configure(self, p):
        g = p.add_mutually_exclusive_group()
        g.add_argument("--on", action="store_true",
                       help="enable tracing (clears the ring)")
        g.add_argument("--off", action="store_true",
                       help="disable tracing")
        p.add_argument("--limit", type=int, default=25,
                       help="spans to print (most recent first)")
        p.add_argument("--prefix", default="",
                       help="only spans whose name starts with this")
        p.add_argument("--critical-path", default="", metavar="TRACE_ID",
                       help="print one trace's blocking chain with "
                            "per-phase attribution")
        p.add_argument("--no-fanout", action="store_true",
                       help="query only one master instead of every "
                            "configured HA member")

    def run(self, args, ctx):
        mc = ctx.meta_client()
        if args.on:
            mc.set_trace_enabled(True, clear=True)
            ctx.print("tracing enabled")
            return 0
        if args.off:
            mc.set_trace_enabled(False)
            ctx.print("tracing disabled")
            return 0
        from alluxio_tpu_torch.utils.trace_fanout import (
            master_endpoints, merge_stitched, peer_traces)

        # spans land on whichever master each node heartbeats to (PR-11
        # standby metrics reads): on an HA list, ask every member
        fanout = (not args.no_fanout
                  and len(master_endpoints(ctx.conf)) > 1)
        if args.critical_path:
            return self._critical_path(ctx, mc, args.critical_path,
                                       fanout)
        resp = mc.get_trace(limit=args.limit, prefix=args.prefix)
        if fanout:
            resp = {"enabled": resp["enabled"],
                    **merge_stitched(resp, peer_traces(
                        ctx.conf, limit=args.limit,
                        prefix=args.prefix))}
        ctx.print(f"tracing: {'on' if resp['enabled'] else 'off'} "
                  f"({len(resp['spans'])} spans)")
        for s in resp["spans"][:args.limit]:
            dur = s["duration_ms"]
            shown = "-" if dur is None else f"{round(dur, 2)}"
            tid = (s.get("trace_id") or "")[:8]
            ctx.print(f"  {s['name']:<40} {shown:>9} ms  "
                      f"trace={tid} src={s.get('source', 'local')} "
                      f"thread={s['thread']}"
                      + (f"  ERROR {s['error']}" if s["error"] else ""))
        for t in resp.get("traces", [])[:10]:
            dur = t.get("duration_ms")
            ctx.print(f"  trace {t['trace_id'][:8]}: {t['spans']} spans "
                      f"across {','.join(t['sources'])} "
                      f"root={t.get('root') or '?'} "
                      f"({'-' if dur is None else round(dur, 2)} ms)")
        return 0

    def _critical_path(self, ctx, mc, trace_id, fanout):
        """Blocking-chain view of one trace. With fan-out the spans are
        merged from every HA member first and analyzed locally —
        otherwise the master runs the analysis server-side."""
        if fanout:
            from alluxio_tpu_torch.utils.critical_path import analyze_trace
            from alluxio_tpu_torch.utils.trace_fanout import (
                merge_stitched, peer_traces)

            base = mc.get_trace(limit=4000, trace_id=trace_id)
            merged = merge_stitched(base, peer_traces(
                ctx.conf, limit=4000, trace_id=trace_id))
            cp = analyze_trace(merged["spans"])
        else:
            cp = mc.get_trace_profile(
                trace_id=trace_id).get("critical_path")
        if not cp:
            ctx.eprint(f"no spans recorded for trace {trace_id} — is "
                       f"tracing on, and has a metrics heartbeat "
                       f"shipped the spans yet?")
            return 1
        ctx.print(f"trace {cp['trace_id'][:16]}: root {cp['root']} "
                  f"({cp['wall_ms']:.2f} ms wall, "
                  f"{cp['attributed_pct']:.1f}% attributed to named "
                  f"phases)")
        ctx.print("  blocking chain (critical path):")
        for row in cp.get("spans_on_path", ()):
            phases = row.get("phases") or {}
            detail = ", ".join(f"{k}={v:.2f}ms" for k, v in
                               sorted(phases.items(),
                                      key=lambda kv: -kv[1]))
            ctx.print(f"    +{row['start_off_ms']:>8.2f}ms "
                      f"{row['span']:<40s} "
                      f"src={row.get('source') or '?':<10s} "
                      f"self={row['self_ms']:.2f}ms"
                      + (f"  [{detail}]" if detail else ""))
        ctx.print("  top segments:")
        segs = sorted(cp.get("segments", {}).items(),
                      key=lambda kv: -kv[1])
        for key, ms in segs[:15]:
            share = (100.0 * ms / cp["wall_ms"]) if cp["wall_ms"] else 0.0
            ctx.print(f"    {key:<48s} {ms:>8.2f}ms {share:>5.1f}%")
        return 0


def main(argv=None) -> int:
    return ADMIN_SHELL.run(sys.argv[1:] if argv is None else argv)
