"""DistributedCp/Mv: copy or move files across mounts/UFSes (a copy of
``alluxio_tpu/job/plans/migrate.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/migrate/
MigrateDefinition.java``: executors are picked per source file (hashed over
job workers); each task streams one file source -> destination through the
FS client, honoring ``overwrite`` and the write type; ``delete_source``
turns copy into move.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.utils.exceptions import (
    AlreadyExistsError, InvalidArgumentError, UnavailableError,
)
from alluxio_tpu_torch.utils.uri import AlluxioURI


class MigrateDefinition(PlanDefinition):
    name = "migrate"
    relocatable = True  # copy/move work is worker-agnostic

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        src = config.get("source")
        dst = config.get("destination")
        if not src or not dst:
            raise InvalidArgumentError(
                "migrate job requires 'source' and 'destination'")
        if not workers:
            raise UnavailableError("no job workers registered")
        src_info = ctx.fs_master.get_status(src)
        pairs: List[Tuple[str, str]] = []
        if src_info.folder:
            base = AlluxioURI(src).path
            for info in ctx.fs_master.list_status(src, recursive=True):
                if info.folder:
                    continue
                rel = info.path[len(base):].lstrip("/")
                pairs.append((info.path, AlluxioURI(dst).join(rel).path))
        else:
            dst_path = dst
            try:
                dst_info = ctx.fs_master.get_status(dst)
                if dst_info.folder:
                    dst_path = AlluxioURI(dst).join(
                        AlluxioURI(src).name).path
            except Exception:  # noqa: BLE001 - dst may not exist yet
                pass
            pairs.append((src_info.path, dst_path))
        ordered = sorted(workers, key=lambda w: w.worker_id)
        assignments: Dict[int, List[dict]] = collections.defaultdict(list)
        for i, (s, d) in enumerate(pairs):
            w = ordered[i % len(ordered)]
            assignments[w.worker_id].append({"source": s, "destination": d})
        return [(wid, files) for wid, files in assignments.items()]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        overwrite = bool(config.get("overwrite", False))
        write_type = config.get("write_type")
        delete_source = bool(config.get("delete_source", False))
        migrated = []
        for item in task_args:
            src, dst = item["source"], item["destination"]
            if ctx.fs.exists(dst):
                if not overwrite:
                    raise AlreadyExistsError(
                        f"{dst} exists and overwrite=False")
                ctx.fs.delete(dst)
            parent = AlluxioURI(dst).parent()
            if parent is not None and not ctx.fs.exists(parent.path):
                ctx.fs.create_directory(parent.path, recursive=True,
                                        allow_exists=True)
            with ctx.fs.open_file(src) as fin, \
                    ctx.fs.create_file(dst, write_type=write_type) as fout:
                while True:
                    chunk = fin.read(4 << 20)
                    if not chunk:
                        break
                    fout.write(chunk)
            if delete_source:
                ctx.fs.delete(src)
            migrated.append(dst)
        return {"migrated": migrated}

    def join(self, config: Dict[str, Any],
             task_results: List[Any]) -> Any:
        files = sorted({f for r in task_results
                        for f in (r or {}).get("migrated", [])})
        return {"migrated": files, "num_files": len(files)}
