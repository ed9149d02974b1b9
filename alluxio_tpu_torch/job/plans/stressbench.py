"""StressBench job: fan a stress benchmark out over the job workers (a
copy of ``alluxio_tpu/job/plans/stressbench.py``).

Re-design of ``job/server/src/main/java/alluxio/job/plan/stress/
StressBenchDefinition.java`` + the ``--cluster`` mode of
``stress/shell/.../cli/Benchmark.java:133``: the job master assigns the
same bench spec to every job worker; each runs it against the LIVE
cluster through its own client and returns its JSON summary; join
aggregates throughput (sum) and latency (worst percentiles) — the
distributed counterpart of running a stress CLI on N client hosts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from alluxio_tpu_torch.job.plan import (
    PlanDefinition, RegisteredJobWorker, RunTaskContext, SelectContext,
)
from alluxio_tpu_torch.utils.exceptions import (
    InvalidArgumentError, UnavailableError,
)

#: bench name -> runner; each runs against an EXISTING cluster via the
#: job worker's own FileSystem client
_BENCHES = ("worker", "master")


class StressBenchDefinition(PlanDefinition):
    name = "stressbench"

    def select_executors(self, config: Dict[str, Any],
                         workers: List[RegisteredJobWorker],
                         ctx: SelectContext) -> List[Tuple[int, Any]]:
        bench = config.get("bench")
        if bench not in _BENCHES:
            raise InvalidArgumentError(
                f"stressbench requires 'bench' in {_BENCHES}")
        if not workers:
            raise UnavailableError("no job workers registered")
        n = int(config.get("cluster_limit", 0)) or len(workers)
        chosen = sorted(workers, key=lambda w: w.worker_id)[:n]
        return [(w.worker_id, {"task_index": i, "n_tasks": len(chosen)})
                for i, w in enumerate(chosen)]

    def run_task(self, config: Dict[str, Any], task_args: Any,
                 ctx: RunTaskContext) -> Any:
        import json

        bench = config["bench"]
        opts = dict(config.get("options", {}))
        # each task works under its own namespace dir so N workers
        # don't contend on one parent inode
        idx = task_args["task_index"]
        base = opts.pop("base_path", "/stress-dist")
        if bench == "worker":
            from alluxio_tpu_torch.stress import worker_bench

            result = worker_bench.run(
                mode=opts.pop("mode", "random"), master=None,
                _reuse_fs=ctx.fs, base_path=f"{base}/t{idx}", **opts)
        else:
            from alluxio_tpu_torch.stress import master_bench

            result = master_bench.run(
                op=opts.pop("op", "CreateFile"),
                base_path=f"{base}/t{idx}", _reuse_fs=ctx.fs, **opts)
        return json.loads(result.json_line())

    def join(self, config: Dict[str, Any],
             task_results: List[Any]) -> Any:
        results = [r for r in task_results if r]
        if not results:
            return {}
        agg: Dict[str, Any] = {
            "bench": results[0]["bench"],
            "tasks": len(results),
            "errors": sum(r.get("errors", 0) for r in results),
            "metrics": {},
        }
        m0 = results[0].get("metrics", {})
        for k in m0:
            vals = [r["metrics"].get(k, 0) for r in results
                    if isinstance(r["metrics"].get(k), (int, float))]
            if not vals:
                continue
            if k.endswith(("_us",)):  # latency: worst across tasks
                agg["metrics"][k] = max(vals)
            elif k in ("ops_per_s", "mb_per_s", "gb_per_s"):
                agg["metrics"][k] = round(sum(vals), 2)  # throughput
            else:
                agg["metrics"][k] = vals[0]
        return agg
