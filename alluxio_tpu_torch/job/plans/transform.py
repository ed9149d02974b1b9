"""Table transform (compact) job plan (a copy of
``alluxio_tpu/job/plans/transform.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/transform/
{CompactDefinition,CompactTask}.java`` + ``format/parquet``: coalesce a
partition's many small Parquet files into ``num_files`` outputs so scan
jobs open fewer objects. One task per partition, assigned round-robin
over job workers; each task reads through the caching FS client (cold
data caches into the co-located worker) and writes the compacted files
back through the namespace.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.utils.exceptions import (
    InvalidArgumentError, UnavailableError,
)


class TransformDefinition(PlanDefinition):
    name = "transform"

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        table = config.get("table_wire")
        if not table:
            raise InvalidArgumentError(
                "transform job requires 'table_wire'")
        if not workers:
            raise UnavailableError("no job workers registered")
        out_root = config["output_root"]
        assignments: List[Tuple[int, Any]] = []
        for i, part in enumerate(table["partitions"]):
            w = workers[i % len(workers)]
            out_dir = f"{out_root}/{part['spec']}" if part["spec"] \
                else out_root
            assignments.append((w.worker_id, [{
                "location": part["location"], "output_dir": out_dir}]))
        return assignments

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        import pyarrow as pa
        import pyarrow.parquet as pq

        from alluxio_tpu_torch.table.reader import read_columns

        num_files = int(config.get("num_files", 1))
        write_type = config.get("write_type", "CACHE_THROUGH")
        compacted = []
        for item in task_args:
            loc, out_dir = item["location"], item["output_dir"]
            paths = [f"{loc}/{info.name}"
                     for info in ctx.fs.list_status(loc)
                     if not info.folder and info.name.endswith(".parquet")]
            if not paths:
                continue
            table = read_columns(ctx.fs, paths)
            if not ctx.fs.exists(out_dir):
                ctx.fs.create_directory(out_dir, recursive=True,
                                        allow_exists=True)
            rows_per = -(-table.num_rows // num_files)
            for i in range(num_files):
                chunk = table.slice(i * rows_per, rows_per)
                if chunk.num_rows == 0:
                    break
                sink = pa.BufferOutputStream()
                pq.write_table(chunk, sink)
                out_path = f"{out_dir}/part-{i:05d}.parquet"
                ctx.fs.write_all(out_path,
                                 sink.getvalue().to_pybytes(),
                                 write_type=write_type)
                compacted.append(out_path)
        return {"outputs": compacted}
