"""Master-side RPC services: a copy of ``alluxio_tpu/rpc/master_service.py``
for a single master.

Left out with the slices that bring them: the audit wrapper and the
active-sync RPCs of the FS service; the standby services. The meta RPCs
whose component is not ported yet (admission, backup, Raft quorum)
answer as the JAX ones do when that component is ``None``.

Re-design of the reference's master service handlers
(``file/FileSystemMaster{Client,Worker,Job}ServiceHandler.java``,
``block/BlockMasterClientServiceHandler`` + ``grpc/file_system_master.proto
:475-676``, ``grpc/block_master.proto:120-286``, ``grpc/meta_master.proto``):
thin translation between wire dicts and the master objects, with per-RPC
metrics (the reference's ``RpcUtils`` wrappers).
"""

from __future__ import annotations

from alluxio_tpu_torch.conf import Configuration, Source
from alluxio_tpu_torch.master.block_master import BlockMaster
from alluxio_tpu_torch.master.file_master import FileSystemMaster
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.rpc.core import ServiceDefinition
from alluxio_tpu_torch.utils.wire import WorkerNetAddress

FS_SERVICE = "atpu.FileSystemMaster"
BLOCK_SERVICE = "atpu.BlockMaster"
META_SERVICE = "atpu.MetaMaster"


def _timed(name: str, fn, journal=None):
    """Per-RPC timing + (when a journal is given) deferred durability:
    every journal context the handler opens applies state immediately
    but fsyncs ONCE here, after all master locks are released — one
    group-committed flush per mutating RPC instead of one per context
    (reference: RpcUtils wrappers + AsyncJournalWriter)."""
    timer = metrics().timer(f"Master.rpc.{name}")  # resolve once

    if journal is None:
        def wrapper(req):
            with timer.time():
                return fn(req)
    else:
        def wrapper(req):
            with timer.time(), journal.deferred_durability():
                return fn(req)

    return wrapper


def fs_master_service(fsm: FileSystemMaster) -> ServiceDefinition:
    svc = ServiceDefinition(FS_SERVICE)

    def u(name, fn, register=True):
        """Wrap ``fn`` with timing; ``register=False`` returns the
        wrapped callable instead of registering a unary method (stream
        handlers reuse the same discipline for their resolve step)."""
        timed = _timed(name, fn, journal=fsm._journal)
        if register:
            svc.unary(name, timed)
        return timed

    u("set_acl", lambda r: (fsm.set_acl(
        r["path"], r.get("entries", []),
        default=r.get("default", False),
        recursive=r.get("recursive", False)), {})[-1])
    u("get_acl", lambda r: fsm.get_acl(r["path"]))

    def _get_status(r):
        # stamp BEFORE the lookup: the payload is then at least as new
        # as the stamp, so any later mutation carries a larger version
        # and reaches the client as a heartbeat invalidation — the
        # client metadata cache's coherence invariant (docs/metadata.md)
        v = fsm.invalidations.version
        out = fsm.get_status(
            r["path"], sync_interval_ms=r.get("sync_interval_ms",
                                              -1)).to_wire()
        out["md_version"] = v
        return out

    u("get_status", _get_status)
    u("exists", lambda r: {"exists": fsm.exists(r["path"])})
    def _list_status_stream(r: dict):
        """Partial-response listing (reference: the streamed ListStatus
        of ``file_system_master.proto:475-590``): the full listing
        resolves once against the version-guarded cache, then ships in
        batches so a million-entry directory never rides one frame.
        Columnar-requesting clients get struct-of-arrays batches
        (sliced views of the memoized transpose — same encode win as
        the unary columnar path); recursive listings fall back to row
        dicts. Timed like the unary RPCs: the listing resolves before
        the first chunk goes out; batching itself is transport work.

        ``paged=True`` (non-recursive only) switches to cursor paging:
        every batch is its own ``list_status_page`` call — own short
        lock scope, straight off the store's range scan — so a
        million-entry LSM directory streams without the master ever
        materializing it (weakly consistent across pages, stamped with
        ``md_version`` per page)."""
        batch = max(1, int(r.get("batch_size", 500)))
        if r.get("paged") and not r.get("recursive"):
            cursor = r.get("start_after")
            offset = 0
            while True:
                page = fsm.list_status_page(r["path"], start_after=cursor,
                                            limit=batch)
                yield {"infos": page["infos"], "offset": offset,
                       "md_version": page["md_version"],
                       "next": page["next"]}
                if page["next"] is None:
                    return
                offset += len(page["infos"])
                cursor = page["next"]
        res = _timed_resolve(r)
        if isinstance(res, dict):  # columnar {"n": N, "cols": {...}}
            cols, n = res["cols"], res.get("n", 0)
            keys = list(cols)
            for i in range(0, n, batch):
                yield {"cols": {k: cols[k][i:i + batch] for k in keys},
                       "offset": i, "total": n}
        else:
            for i in range(0, len(res), batch):
                yield {"infos": res[i:i + batch],
                       "offset": i, "total": len(res)}

    def _resolve(r: dict):
        if r.get("columnar") and not r.get("recursive"):
            return fsm.list_status(
                r["path"], sync_interval_ms=r.get("sync_interval_ms",
                                                  -1), columnar=True)
        return fsm.list_status(
            r["path"], recursive=r.get("recursive", False),
            sync_interval_ms=r.get("sync_interval_ms", -1), wire=True)

    _timed_resolve = u("list_status_stream.resolve", _resolve,
                         register=False)
    svc.stream_out("list_status_stream", _list_status_stream)
    def _list_status(r):
        v = fsm.invalidations.version  # stamp-before-lookup, as above
        if r.get("columnar"):
            out = {"columnar": fsm.list_status(
                r["path"], recursive=r.get("recursive", False),
                sync_interval_ms=r.get("sync_interval_ms", -1),
                columnar=True)}
        else:
            out = {"infos": fsm.list_status(
                r["path"], recursive=r.get("recursive", False),
                sync_interval_ms=r.get("sync_interval_ms", -1), wire=True)}
        out["md_version"] = v
        return out

    u("list_status", _list_status)
    u("create_file", lambda r: fsm.create_file(
        r["path"], block_size_bytes=r.get("block_size_bytes"),
        recursive=r.get("recursive", True), ttl=r.get("ttl", -1),
        ttl_action=r.get("ttl_action", "DELETE"), mode=r.get("mode"),
        owner=r.get("owner", ""), group=r.get("group", ""),
        replication_min=r.get("replication_min", 0),
        replication_max=r.get("replication_max", -1),
        cacheable=r.get("cacheable", True),
        persist_on_complete=r.get("persist_on_complete", False),
        overwrite=r.get("overwrite", False)).to_wire())
    u("create_directory", lambda r: fsm.create_directory(
        r["path"], recursive=r.get("recursive", True),
        allow_exists=r.get("allow_exists", False),
        mode=r.get("mode")).to_wire())
    u("get_new_block_id", lambda r: {
        "block_id": fsm.get_new_block_id_for_file(r["path"])})
    u("complete_file", lambda r: (
        fsm.complete_file(r["path"], length=r.get("length"),
                          ufs_fingerprint=r.get("ufs_fingerprint", "")),
        {})[-1])
    u("delete", lambda r: (
        fsm.delete(r["path"], recursive=r.get("recursive", False),
                   alluxio_only=r.get("alluxio_only", False)), {})[-1])
    u("rename", lambda r: (fsm.rename(r["src"], r["dst"]), {})[-1])
    u("free", lambda r: {"freed_blocks": fsm.free(
        r["path"], recursive=r.get("recursive", False),
        forced=r.get("forced", False))})
    u("mount", lambda r: (fsm.mount(
        r["path"], r["ufs_uri"], read_only=r.get("read_only", False),
        shared=r.get("shared", False),
        properties=r.get("properties")), {})[-1])
    u("unmount", lambda r: (fsm.unmount(r["path"]), {})[-1])
    u("get_mount_points", lambda r: {
        "mounts": [m.to_wire() for m in fsm.get_mount_points()]})
    u("set_attribute", lambda r: (fsm.set_attribute(
        r["path"], pinned=r.get("pinned"),
        pinned_media=r.get("pinned_media"), ttl=r.get("ttl"),
        ttl_action=r.get("ttl_action"), mode=r.get("mode"),
        owner=r.get("owner"), group=r.get("group"),
        replication_min=r.get("replication_min"),
        replication_max=r.get("replication_max"),
        recursive=r.get("recursive", False),
        xattr=r.get("xattr")), {})[-1])
    u("get_file_block_info_list", lambda r: {"infos": [
        i.to_wire() for i in fsm.get_file_block_info_list(r["path"])]})
    u("schedule_async_persistence", lambda r: (
        fsm.schedule_async_persistence(r["path"]), {})[-1])
    u("get_pinned_file_ids", lambda r: {
        "ids": sorted(fsm.get_pinned_file_ids())})
    u("sync_metadata", lambda r: {"changed": fsm.sync_metadata(r["path"])})
    u("mark_persisted", lambda r: (
        fsm.mark_persisted(r["path"],
                           ufs_fingerprint=r.get("ufs_fingerprint", "")),
        {})[-1])
    u("commit_persist", lambda r: {"fingerprint": fsm.commit_persist(
        r["path"], r["temp_ufs_path"],
        expected_id=r.get("expected_id", 0))})
    u("file_system_heartbeat", lambda r: (
        fsm.file_system_heartbeat(r["worker_id"],
                                  r.get("persisted_files", [])), {})[-1])
    return svc


def block_master_service(bm: BlockMaster) -> ServiceDefinition:
    svc = ServiceDefinition(BLOCK_SERVICE)

    def u(name, fn):
        svc.unary(name, _timed(name, fn, journal=bm._journal))

    u("get_worker_id", lambda r: {"worker_id": bm.get_worker_id(
        WorkerNetAddress.from_wire(r["address"]))})
    u("register", lambda r: (bm.worker_register(
        r["worker_id"], r["capacity"], r["used"], r["blocks"],
        WorkerNetAddress.from_wire(r["address"]) if r.get("address")
        else None), {})[-1])
    u("heartbeat", lambda r: bm.worker_heartbeat(
        r["worker_id"], r["used"], r.get("added", {}),
        r.get("removed", []), r.get("metrics")))
    u("commit_block", lambda r: (bm.commit_block(
        r["worker_id"], r["used_on_tier"], r["tier"], r["block_id"],
        r["length"]), {})[-1])
    u("get_block_info", lambda r: bm.get_block_info(r["block_id"]).to_wire())
    u("get_block_infos", lambda r: {"infos": [
        b.to_wire() for b in bm.get_block_infos(r["block_ids"])]})
    u("report_device_blocks", lambda r: (bm.report_device_blocks(
        r["host"], {int(k): v for k, v in r["mesh_blocks"].items()}),
        {})[-1])
    u("device_block_map", lambda r: {"map": {
        str(bid): m for bid, m in bm.device_block_map().items()}})
    # wire default EXCLUDES quarantined workers: remote callers of this
    # listing are placement choosers (write policy, UFS read-through
    # pick, prefetch agent) and quarantine works by disappearing from
    # their view; admin surfaces opt back in with include_quarantined
    u("get_worker_infos", lambda r: {"infos": [
        w.to_wire() for w in bm.get_worker_infos(
            include_lost=r.get("include_lost", False),
            include_quarantined=r.get("include_quarantined", False))]})
    u("get_capacity", lambda r: {"capacity": bm.capacity_bytes_on_tiers(),
                                 "used": bm.used_bytes_on_tiers()})
    return svc


def meta_master_service(conf: Configuration, *, cluster_id: str = "",
                        start_time_ms: int = 0,
                        safe_mode_fn=lambda: False,
                        journal=None,
                        path_properties=None,
                        config_checker=None,
                        permission_checker=None,
                        metrics_master=None,
                        health_monitor=None,
                        remediation_engine=None,
                        invalidation_log=None,
                        metastore_stats_fn=None,
                        role_fn=lambda: "PRIMARY") -> ServiceDefinition:
    """Config distribution + cluster info + admin ops
    (reference: ``meta_master.proto:143-211`` — cluster-default config,
    config-hash handshake ``ConfigHashSync.java:36``, and the checkpoint
    trigger used by ``fsadmin journal checkpoint``).

    Admin ops (backup / checkpoint / path-conf mutation) are gated behind
    superuser, as the reference gates them behind admin privilege. The
    JAX service's ``admission`` and ``masters_fn`` arguments are not
    taken: their RPCs answer as the JAX ones do without them."""
    from alluxio_tpu_torch.utils.exceptions import (
        FailedPreconditionError, InvalidArgumentError,
    )

    svc = ServiceDefinition(META_SERVICE)

    def _require_admin() -> None:
        if permission_checker is not None:
            from alluxio_tpu_torch.security.user import authenticated_user

            permission_checker.check_superuser(authenticated_user())
    svc.unary("get_configuration", lambda r: {
        "properties": conf.to_map(min_source=Source.SITE_PROPERTY),
        "sources": {k: conf.source(k).name for k in
                    conf.to_map(min_source=Source.SITE_PROPERTY)}
        if r.get("sources") else {},
        "hash": conf.hash()})
    svc.unary("get_config_hash", lambda r: {"hash": conf.hash()})
    svc.unary("get_master_info", lambda r: {
        "cluster_id": cluster_id, "start_time_ms": start_time_ms,
        "safe_mode": bool(safe_mode_fn()), "role": str(role_fn())})
    # metastore backend shape (`fsadmin report metastore`, statuspage)
    svc.unary("get_metastore_info", lambda r: {
        "stats": dict(metastore_stats_fn())
        if metastore_stats_fn is not None else {}})

    def _get_masters(r):
        # no quorum view without HA (JAX: masters_fn None)
        raise FailedPreconditionError(
            "this master does not serve a quorum view")

    svc.unary("get_masters", _get_masters)

    def _set_log_level(r):
        """Runtime log-level control (reference:
        ``shell/src/main/java/alluxio/cli/LogLevel.java`` — the logLevel
        CLI flips log4j levels over the web port at runtime)."""
        import logging as _logging

        _require_admin()
        name = r.get("logger") or ""
        level = r["level"].upper()
        if level not in ("DEBUG", "INFO", "WARNING", "WARN", "ERROR",
                         "CRITICAL", "NOTSET"):
            raise InvalidArgumentError(f"unknown log level {level!r}")
        level = "WARNING" if level == "WARN" else level
        _logging.getLogger(name or None).setLevel(level)
        return {"logger": name or "root", "level": level}

    def _get_log_level(r):
        import logging as _logging

        logger = _logging.getLogger(r.get("logger") or None)
        return {"logger": logger.name,
                "level": _logging.getLevelName(
                    logger.getEffectiveLevel())}

    svc.unary("set_log_level", _set_log_level)
    svc.unary("get_log_level", _get_log_level)

    def _set_trace_enabled(r):
        from alluxio_tpu_torch.utils.tracing import (
            set_tracing_enabled, tracer,
        )

        _require_admin()
        on = bool(r.get("enabled"))
        set_tracing_enabled(on)
        if r.get("clear"):
            tracer().clear()
        return {"enabled": on}

    def _get_trace(r):
        from alluxio_tpu_torch.utils.tracing import stitch_spans, tracer

        stitched = stitch_spans(
            metrics_master.traces if metrics_master is not None else None,
            limit=int(r.get("limit") or 500),
            prefix=r.get("prefix") or "",
            trace_id=r.get("trace_id") or "",
            local_source="master")
        return {"enabled": tracer().enabled, **stitched}

    def _get_trace_profile(r):
        """Critical-path analysis over stitched traces: one trace id ->
        its blocking chain; no id -> the aggregate per-phase read-path
        profile."""
        from alluxio_tpu_torch.utils.critical_path import (
            analyze_trace, profile,
        )
        from alluxio_tpu_torch.utils.tracing import stitch_spans, tracer

        trace_id = r.get("trace_id") or ""
        stitched = stitch_spans(
            metrics_master.traces if metrics_master is not None else None,
            limit=int(r.get("limit") or 4000),
            prefix=r.get("prefix") or "",
            trace_id=trace_id,
            local_source="master")
        if trace_id:
            return {"enabled": tracer().enabled,
                    "critical_path": analyze_trace(stitched["spans"])}
        return {"enabled": tracer().enabled,
                "profile": profile(
                    stitched["spans"],
                    root_prefix=r.get("root_prefix") or "",
                    max_traces=int(r.get("max_traces") or 256))}

    svc.unary("set_trace_enabled", _set_trace_enabled)
    svc.unary("get_trace", _get_trace)
    svc.unary("get_trace_profile", _get_trace_profile)

    def _get_metrics(r):
        snap = metrics().snapshot()
        if metrics_master is not None:
            snap = metrics_master.merged_snapshot(snap)
        return {"metrics": snap}

    def _metrics_heartbeat(r):
        """Worker/client metric snapshots -> cluster aggregation
        (reference: DefaultMetricsMaster + metric_master.proto).
        Requires an authenticated caller — an anonymous client must not
        be able to forge sources and inflate Cluster.* aggregates."""
        if metrics_master is not None:
            if permission_checker is not None:
                from alluxio_tpu_torch.security.user import (
                    authenticated_user,
                )
                from alluxio_tpu_torch.utils.exceptions import (
                    UnauthenticatedError,
                )

                if authenticated_user() is None:
                    raise UnauthenticatedError(
                        "metrics_heartbeat requires an authenticated user")
            resp = metrics_master.handle_heartbeat(r)
            if remediation_engine is not None:
                # piggyback the retuning overlay: no extra RPC, and
                # every reporting client converges within one
                # heartbeat interval of a push or revert
                overlay, version = remediation_engine.heartbeat_overlay()
                if overlay:
                    resp["conf_overlay"] = overlay
                resp["conf_overlay_version"] = version
            if invalidation_log is not None and \
                    r.get("want_md_invalidations"):
                # metadata-cache push invalidation rides the same
                # channel: prefixes invalidated since the client's
                # applied version
                resp["md_invalidations"] = invalidation_log.since(
                    r.get("md_cache_version"))
            return resp
        return {}

    def _get_metrics_history(r):
        """Time-resolved series out of the master's history store.
        Without a ``name`` it lists the recorded metric names + store
        stats; with one it returns matching series at the requested
        resolution, optionally derived as a per-second rate."""
        if metrics_master is None or metrics_master.history is None:
            raise FailedPreconditionError(
                "metrics history is disabled on this master "
                "(atpu.master.metrics.history.enabled)")
        return metrics_master.history_report(r)

    def _get_health(r):
        """Ranked health verdicts from the continuous rule engine.
        ``evaluate`` (default true) runs a fresh evaluation pass first
        so the report never serves a stale lifecycle state."""
        if health_monitor is None:
            raise FailedPreconditionError(
                "the health-rule engine is disabled on this master "
                "(atpu.master.health.enabled)")
        resp = health_monitor.fresh_report(bool(r.get("evaluate", True)))
        if remediation_engine is not None:
            # the remediation timeline rides the health report: cause
            # (alert) and effect (action) belong on one screen
            resp["remediation"] = remediation_engine.report()
        return resp

    def _get_qos(r):
        snap = metrics().snapshot()
        if metrics_master is not None:
            snap = metrics_master.merged_snapshot(snap)
        return {"admission": {"enabled": False},
                "metrics": {k: v for k, v in snap.items()
                            if "Qos" in k or "RpcAdmission" in k}}

    svc.unary("get_metrics", _get_metrics)
    svc.unary("metrics_heartbeat", _metrics_heartbeat)
    svc.unary("get_metrics_history", _get_metrics_history)
    svc.unary("get_health", _get_health)
    svc.unary("get_qos", _get_qos)

    def _checkpoint(r):
        _require_admin()
        if journal is None:
            raise FailedPreconditionError(
                "this master has no journal to checkpoint")
        journal.checkpoint()
        return {}

    svc.unary("checkpoint", _checkpoint)

    def _quorum_info(r):
        """Quorum membership/roles (reference: journal_master.proto
        GetQuorumInfo behind ``fsadmin journal quorum``)."""
        raise FailedPreconditionError(
            "quorum info requires the EMBEDDED journal")

    def _transfer_leadership(r):
        _require_admin()
        raise FailedPreconditionError(
            "leadership transfer requires the EMBEDDED journal")

    svc.unary("get_quorum_info", _quorum_info)
    svc.unary("transfer_quorum_leadership", _transfer_leadership)

    def _backup(r):
        _require_admin()
        raise FailedPreconditionError(
            "this master's journal does not support backups")

    svc.unary("backup", _backup)

    def _set_path_conf(r):
        _require_admin()
        path_properties.add(r["path"], r["properties"])
        return {}

    def _remove_path_conf(r):
        _require_admin()
        path_properties.remove(r["path"], r.get("keys"))
        return {}

    if path_properties is not None:
        svc.unary("set_path_conf", _set_path_conf)
        svc.unary("remove_path_conf", _remove_path_conf)
        svc.unary("get_path_conf", lambda r: {
            "properties": path_properties.get_all(),
            "hash": path_properties.hash()})
    if config_checker is not None:
        svc.unary("register_node_conf", lambda r: (
            config_checker.register(r["node_id"], r.get("config", {})),
            {})[-1])
        svc.unary("get_config_report", lambda r: config_checker.report())
    return svc
