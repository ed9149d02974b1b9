"""The port's job service without a cluster, against the JAX package's
(modelled on the unit cases of ``tests/test_job_service.py``).

- the job wire types pack to the same msgpack bytes in both packages, and
  a record decoded by either re-encodes to the same bytes;
- each plan's ``select_executors`` picks the same executors and task
  arguments (or raises the same error) in both packages (replicate's
  targets start at the block id's place in the JAX order, the port's one
  difference), over the same
  seeded cluster view: files and their blocks, the block workers that
  are live, where each block is cached, the registered job workers;
- one ``JobMaster`` of each package, on a manual clock and over the same
  seeded view, given the same seeded script of runs, worker
  registrations, heartbeats with task updates, clock steps, lost-worker
  detection (with reassignment), cancels and status reads, answers
  alike at every step, errors included;
- the task failover of ``_PlanCoordinator`` (the JAX cases, on both);
- the port's registry holds the JAX plans, and ``stressbench``'s ``join``
  aggregates the same seeded task summaries to the same result.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
HOSTS = ("h0", "h1", "h2", "h3")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _outcome(fn):
    """A call's result, or its error as (class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("error", type(e).__name__, str(e))


# -- wire ---------------------------------------------------------------------
def _wire_records(seed: int):
    rng = np.random.default_rng(seed)
    statuses = ("CREATED", "RUNNING", "COMPLETED", "FAILED", "CANCELED")

    def task(i):
        return {"job_id": int(rng.integers(1, 1 << 40)), "task_id": i,
                "worker_id": int(rng.integers(0, 9)),
                "status": statuses[int(rng.integers(0, 5))],
                "error_message": "" if rng.random() < 0.5 else f"err {i}",
                "result": {"loaded_blocks": [int(b) for b in
                                             rng.integers(0, 1 << 33, 3)]},
                "args": [{"path": f"/p/{i}", "block_id": int(rng.integers(
                    0, 1 << 33)), "persisted": bool(rng.random() < 0.5)}]}

    job = {"job_id": int(rng.integers(1, 1 << 40)), "name": "load",
           "status": statuses[int(rng.integers(0, 5))],
           "error_message": "x" * int(rng.integers(0, 4)),
           "result": {"num_blocks": int(rng.integers(0, 100))},
           "tasks": [task(i) for i in range(int(rng.integers(0, 4)))],
           "children": [int(c) for c in rng.integers(1, 99, 2)],
           "last_updated_ms": int(rng.integers(0, 1 << 45))}
    health = {"worker_id": int(rng.integers(1, 9)), "hostname": "h1",
              "load_avg": float(rng.random()), "task_pool_size": 8,
              "num_active_tasks": int(rng.integers(0, 8)),
              "unfinished_tasks": int(rng.integers(0, 8))}
    command = {"kind": "run", "job_id": job["job_id"], "task_id": 3,
               "job_config": {"type": "load", "path": "/p"},
               "task_args": task(7)["args"]}
    return {"JobInfo": job, "TaskInfo": task(0),
            "JobWorkerHealth": health, "JobCommand": command}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["JobInfo", "TaskInfo", "JobWorkerHealth",
                                  "JobCommand"])
def test_wire_bytes_equal_both_ways(kind, seed):
    d = _wire_records(seed)[kind]
    blobs = {}
    for pkg in PACKAGES:
        cls = getattr(_mod(pkg, "job.wire"), kind)
        pack = _mod(pkg, "rpc.core").pack
        blobs[pkg] = pack(cls.from_wire(d).to_wire())
    assert blobs["alluxio_tpu"] == blobs["alluxio_tpu_torch"]
    # decoded by either package, re-encoded by the other: the same bytes
    for src, dst in (PACKAGES, PACKAGES[::-1]):
        obj = getattr(_mod(src, "job.wire"), kind).from_wire(
            _mod(src, "rpc.core").unpack(blobs[src]))
        again = getattr(_mod(dst, "job.wire"), kind).from_wire(obj.to_wire())
        assert _mod(dst, "rpc.core").pack(again.to_wire()) == blobs[src]


# -- a seeded cluster view ----------------------------------------------------
def _layout(seed: int) -> dict:
    """Wire dicts of a namespace, its blocks and the block workers."""
    rng = np.random.default_rng(seed)
    live = sorted(rng.choice(HOSTS, size=3, replace=False).tolist())

    def address(host):
        return {"host": "localhost", "rpc_port": 1000 + HOSTS.index(host),
                "tiered_identity": {"tiers": [{"tier": "host",
                                               "value": host}]}}

    workers = [{"id": 10 + HOSTS.index(h), "address": address(h)}
               for h in live]
    infos, fbis, blocks = {}, {}, {}
    next_block = [1 << 24]

    def add_dir(path):
        infos[path] = {"file_id": len(infos) + 1, "path": path,
                       "name": path.rsplit("/", 1)[1], "folder": True}

    def add_file(path):
        n = int(rng.integers(1, 5))
        infos[path] = {"file_id": len(infos) + 1, "path": path,
                       "name": path.rsplit("/", 1)[1],
                       "ufs_path": f"/ufs{path}", "mount_id": 1,
                       "persisted": bool(rng.random() < 0.7),
                       "length": n * 4096, "completed": True}
        fbis[path] = []
        for j in range(n):
            bid = next_block[0]
            next_block[0] += 1
            k = int(rng.integers(0, 3))
            held = rng.choice(HOSTS, size=k, replace=False).tolist()
            info = {"block_id": bid, "length": 4096,
                    "locations": [{"worker_id": 10 + HOSTS.index(h),
                                   "address": address(h)} for h in held]}
            blocks[bid] = info
            fbis[path].append({"block_info": info, "offset": j * 4096})

    for d in ("/data", "/data/a", "/data/b", "/dst"):
        add_dir(d)
    for i in range(int(rng.integers(3, 7))):
        add_file(f"/data/{'ab'[i % 2]}/f{i}")
    add_file("/single")
    return {"workers": workers, "infos": infos, "fbis": fbis,
            "blocks": blocks, "live": live}


class _FsView:
    def __init__(self, pkg, layout):
        wire = _mod(pkg, "utils.wire")
        self._err = _mod(pkg, "utils.exceptions")
        self._infos = {p: wire.FileInfo.from_wire(d)
                       for p, d in layout["infos"].items()}
        self._fbis = {p: [wire.FileBlockInfo.from_wire(f) for f in fs]
                      for p, fs in layout["fbis"].items()}

    def get_status(self, path):
        if path not in self._infos:
            raise self._err.FileDoesNotExistError(f"{path} does not exist")
        return self._infos[path]

    def list_status(self, path, recursive=False):
        base = path.rstrip("/") + "/"
        return [i for p, i in sorted(self._infos.items())
                if p.startswith(base)
                and (recursive or "/" not in p[len(base):])]

    def get_file_block_info_list(self, path):
        return self._fbis.get(path, [])


class _BlockView:
    def __init__(self, pkg, layout):
        wire = _mod(pkg, "utils.wire")
        self._err = _mod(pkg, "utils.exceptions")
        self._blocks = {b: wire.BlockInfo.from_wire(d)
                        for b, d in layout["blocks"].items()}
        self._workers = [wire.WorkerInfo.from_wire(w)
                         for w in layout["workers"]]

    def get_block_info(self, block_id):
        if block_id not in self._blocks:
            raise self._err.BlockDoesNotExistError(f"block {block_id}")
        return self._blocks[block_id]

    def get_worker_infos(self, include_lost=False,
                         include_quarantined=False):
        return list(self._workers)


def _job_workers(pkg, hostnames):
    plan = _mod(pkg, "job.plan")
    health = _mod(pkg, "job.wire").JobWorkerHealth
    return [plan.RegisteredJobWorker(
        worker_id=i + 1, hostname=h,
        health=health(worker_id=i + 1, hostname=h))
        for i, h in enumerate(hostnames)]


def _select_configs(plan: str, layout: dict, rng) -> list:
    bids = sorted(layout["blocks"])
    no_copy = [b for b in bids if not layout["blocks"][b]["locations"]]
    pick = [int(b) for b in rng.choice(bids, size=3)]
    files = sorted(p for p, d in layout["infos"].items()
                   if not d.get("folder"))
    if plan == "stressbench":
        return [{"bench": "worker"}, {"bench": "master"},
                {"bench": "master", "cluster_limit": 1},
                {"bench": "worker", "cluster_limit": int(rng.integers(1, 9))},
                {"bench": "prefetch"}, {}]
    if plan == "load":
        return [{"path": "/data", "replication": r} for r in (1, 2, 3)] + [
            {"path": "/single"}, {"path": "/data/a", "recursive": False},
            {"replication": 1}, {"path": "/missing"}]
    if plan == "replicate":
        return [{"block_id": b, "replicas": r} for b in pick
                for r in (1, 2)] + [
            {"block_id": b} for b in no_copy[:2]] + [
            {"block_id": b, "ufs": {"ufs_path": "/u", "offset": 0,
                                    "length": 4096}} for b in no_copy[:1]] + [
            {"replicas": 1}, {"block_id": 1}]
    if plan == "evict":
        return [{"block_id": b, "replicas": r} for b in pick
                for r in (1, 2)] + [{}]
    if plan == "move":
        return [{"block_id": b, "destination_host": h} for b in pick[:2]
                for h in ("h0", "h2", "elsewhere")] + [{"block_id": 1}]
    if plan == "persist":
        return [{"path": p, "inode_id": i} for i, p in enumerate(files)] + [
            {}, {"path": "/missing"}]
    if plan == "transform":
        tables = []
        for n in (0, 1, 3, 5):
            specs = [f"year={2000 + int(y)}" for y in
                     rng.choice(30, size=n, replace=False)] if n != 1 \
                else [""]
            tables.append({"name": f"t{n}", "location": f"/wh/t{n}",
                           "partitions": [
                               {"spec": sp, "location":
                                f"/wh/t{n}/{sp}" if sp else f"/wh/t{n}",
                                "values": {}} for sp in specs]})
        return [{"table_wire": t, "output_root": f"{t['location']}/_out"}
                for t in tables] + [{"output_root": "/x"},
                                    {"table_wire": {}, "output_root": "/x"}]
    if plan == "migrate":
        return [{"source": "/data", "destination": "/out"},
                {"source": "/data/a", "destination": "/dst"},
                {"source": "/single", "destination": "/dst"},
                {"source": "/single", "destination": "/new"},
                {"source": "/missing", "destination": "/x"},
                {"source": "/single"}]
    raise AssertionError(plan)


def _spread(want, cfg, select):
    """The JAX replicate selection with the port's one difference: the
    ordered non-holders (all of them, from the JAX plan asked for more
    copies than there are workers) start at the block id modulo their
    count (``alluxio_tpu_torch/job/plans/replicate.py``)."""
    if want[0] != "ok" or not want[1]:
        return want
    full = select(dict(cfg, replicas=1 << 10))[1]
    start = cfg["block_id"] % len(full)
    return ("ok", (full[start:] + full[:start])[:int(cfg.get("replicas", 1))])


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
@pytest.mark.parametrize("plan", ["load", "replicate", "evict", "move",
                                  "persist", "migrate", "transform",
                                  "stressbench"])
def test_select_executors_equal(plan, seed):
    layout = _layout(seed)
    rng = np.random.default_rng(seed)
    configs = _select_configs(plan, layout, rng)
    # job workers: every host (one without a live block worker among
    # them), a subset, and none
    rosters = [list(HOSTS), sorted(rng.choice(HOSTS, 2, replace=False)
                                   .tolist()), []]
    got = {}
    for pkg in PACKAGES:
        registry = _mod(pkg, "job.plan").default_registry()
        ctx = _mod(pkg, "job.plan").SelectContext(_FsView(pkg, layout),
                                                  _BlockView(pkg, layout))
        definition = registry.get(plan)
        got[pkg] = [_outcome(lambda: definition.select_executors(
            dict(cfg, type=plan), _job_workers(pkg, roster), ctx))
            for cfg in configs for roster in rosters]
        if plan == "replicate" and pkg == "alluxio_tpu":
            got[pkg] = [_spread(want, cfg, lambda c: _outcome(
                lambda: definition.select_executors(
                    dict(c, type=plan), _job_workers(pkg, roster), ctx)))
                for want, (cfg, roster) in zip(got[pkg], [
                    (c, r) for c in configs for r in rosters])]
    assert got["alluxio_tpu"] == got["alluxio_tpu_torch"]
    # the views are not trivial: some selections pick executors
    assert any(o[0] == "ok" and o[1] for o in got["alluxio_tpu_torch"])


# -- the job master under one seeded script -----------------------------------
def _task_result(job_type: str, task_args):
    if job_type == "load":
        return {"loaded_blocks": [b["block_id"] for b in task_args]}
    if job_type == "migrate":
        return {"migrated": [f["destination"] for f in task_args]}
    return {"done": True}


def _job_configs(layout, rng):
    bids = sorted(layout["blocks"])
    return [
        {"type": "load", "path": "/data", "replication": 2},
        {"type": "load", "path": "/single"},
        {"type": "load"},
        {"type": "migrate", "source": "/data", "destination": "/out"},
        {"type": "persist", "path": "/single", "inode_id": 3},
        {"type": "replicate", "block_id": int(rng.choice(bids)),
         "replicas": 2},
        {"type": "evict", "block_id": int(rng.choice(bids))},
        {"type": "move", "block_id": int(rng.choice(bids)),
         "destination_host": "h1"},
        {"type": "workflow", "jobs": [
            {"type": "migrate", "source": "/single",
             "destination": "/wf"},
            {"type": "persist", "path": "/single"}]},
    ]


def _script(master, pkg, layout, seed, steps=160):
    """Drives ``master`` and yields each step's outcome. The choices depend
    only on the seed and on earlier outcomes, so two masters that answer
    alike get the same script."""
    wire = _mod(pkg, "job.wire")
    rng = np.random.default_rng(seed)
    configs = _job_configs(layout, rng)
    clock = master._clock
    workers, job_ids = [], []
    inbox = {}  # worker id -> [(job_id, task_id, type, args)]
    for step in range(steps):
        action = rng.choice(["register", "run", "heartbeat", "heartbeat",
                             "heartbeat", "tick", "detect", "cancel",
                             "status", "list", "stranger"],
                            p=[.06, .14, .14, .14, .14, .1, .06, .04, .08,
                               .05, .05])
        if action == "register" or not workers:
            host = str(rng.choice(HOSTS))
            out = _outcome(lambda: master.register_worker(host))
            workers.append(out[1])
            inbox[out[1]] = []
        elif action == "run":
            cfg = configs[int(rng.integers(0, len(configs)))]
            out = _outcome(lambda: master.run(dict(cfg)))
            if out[0] == "ok":
                job_ids.append(out[1])
        elif action == "heartbeat":
            wid = int(rng.choice(workers))
            updates = []
            for job_id, task_id, typ, args in list(inbox.get(wid, [])):
                r = rng.random()
                if r < 0.5:
                    status = "COMPLETED"
                elif r < 0.6:
                    status = "FAILED"
                elif r < 0.8:
                    status = "RUNNING"
                else:
                    continue
                updates.append({
                    "job_id": job_id, "task_id": task_id, "status": status,
                    "result": _task_result(typ, args)
                    if status == "COMPLETED" else None,
                    "error_message": "boom" if status == "FAILED" else ""})
                if status != "RUNNING":
                    inbox[wid].remove((job_id, task_id, typ, args))
            health = wire.JobWorkerHealth(
                worker_id=wid, hostname="h", load_avg=0.5,
                task_pool_size=8, num_active_tasks=len(updates)).to_wire()
            out = _outcome(lambda: master.heartbeat(wid, health, updates))
            for cmd in out[1] if out[0] == "ok" else []:
                if cmd["kind"] == "run":
                    inbox.setdefault(wid, []).append(
                        (cmd["job_id"], cmd["task_id"],
                         cmd["job_config"]["type"], cmd["task_args"]))
                elif cmd["kind"] == "cancel":
                    inbox[wid] = [t for t in inbox.get(wid, [])
                                  if t[:2] != (cmd["job_id"],
                                               cmd["task_id"])]
                elif cmd["kind"] == "register":
                    inbox.pop(wid, None)
        elif action == "tick":
            ms = int(rng.integers(100, 900))
            clock.add_time_ms(ms)
            out = ("tick", ms)
        elif action == "detect":
            out = _outcome(master.detect_lost_workers)
            alive = {w.worker_id for w in master.workers()}
            workers = [w for w in workers if w in alive]
        elif action == "cancel":
            jid = int(rng.choice(job_ids)) if job_ids and rng.random() < .8 \
                else 999
            out = _outcome(lambda: master.cancel(jid))
        elif action == "status":
            jid = int(rng.choice(job_ids)) if job_ids and rng.random() < .9 \
                else 998
            out = _outcome(lambda: master.get_status(jid).to_wire())
        elif action == "list":
            out = _outcome(lambda: [j.to_wire() for j in master.list_jobs()])
        else:  # a heartbeat from a worker the master does not know
            out = _outcome(lambda: master.heartbeat(4242, {}, []))
        yield step, action, out
    yield "end", "jobs", [j.to_wire() for j in master.list_jobs()]
    yield "end", "workers", sorted(
        (w.worker_id, w.hostname, tuple(sorted(w.health.to_wire().items())))
        for w in master.workers())


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_job_master_scripts_equal(seed, monkeypatch):
    # the JAX replicate plan picks its targets by the port's rule (the
    # one difference, held by test_select_executors_equal), so that the
    # job masters' answers can be compared step by step
    jax_replicate = _mod("alluxio_tpu", "job.plan").default_registry() \
        .get("replicate")
    select = jax_replicate.select_executors

    def spread(config, workers, ctx):
        want = _outcome(lambda: select(config, workers, ctx))
        if want[0] == "error":
            return select(config, workers, ctx)  # raises the same error
        return _spread(want, config,
                       lambda c: _outcome(lambda: select(c, workers, ctx)))[1]

    monkeypatch.setattr(jax_replicate, "select_executors", spread)
    layout = _layout(seed)
    masters = {}
    for pkg in PACKAGES:
        masters[pkg] = _mod(pkg, "job.master").JobMaster(
            _FsView(pkg, layout), _BlockView(pkg, layout), capacity=3,
            clock=_mod(pkg, "utils.clock").ManualClock(1_000_000),
            worker_timeout_ms=1000)
    scripts = [_script(masters[pkg], pkg, layout, seed) for pkg in PACKAGES]
    seen = set()
    for theirs, mine in zip(*scripts):
        assert theirs == mine
        seen.add((mine[1], mine[2][0] if isinstance(mine[2], tuple)
                  else ""))
    # the script reached the paths it is there for
    for want in (("run", "ok"), ("run", "error"), ("heartbeat", "ok"),
                 ("status", "error"), ("detect", "ok")):
        assert want in seen, want


# -- task failover (the JAX unit cases, on both packages) ---------------------
def _jw(pkg, wid):
    return _job_workers(pkg, [f"h{w}" for w in range(1, wid + 1)])[-1]


def _fake_plan(executors, join=lambda results: None, relocatable=True):
    class _Plan:
        name = "fake"

        def select_executors(self, config, workers, ctx):
            return executors

        def join(self, config, results):
            return join(results)

    _Plan.relocatable = relocatable
    return _Plan()


def _coordinator(pkg, job_id, plan, workers, dispatch=lambda *a: None):
    coord = _mod(pkg, "job.master")._PlanCoordinator(
        job_id, {}, plan, _mod(pkg, "utils.clock").ManualClock())
    coord.start(workers, None, dispatch)
    return coord


@pytest.mark.parametrize("pkg", PACKAGES)
class TestTaskFailover:
    def test_reassign_tasks_of_lost_worker(self, pkg):
        sent = []
        plan = _fake_plan([(1, {"n": 0}), (1, {"n": 1}), (2, {"n": 2})],
                          join=lambda rs: {"joined": sorted(rs)})
        coord = _coordinator(pkg, 7, plan, [_jw(pkg, 1), _jw(pkg, 2)],
                             lambda wid, cmd: sent.append((wid, cmd)))
        assert len(sent) == 3 and coord.info.status == "RUNNING"
        coord.reassign_tasks_of_worker(
            1, [_jw(pkg, 2)], lambda wid, cmd: sent.append((wid, cmd)))
        redispatched = sent[3:]
        assert [w for w, _ in redispatched] == [2, 2]
        assert all(t.worker_id == 2 for t in coord.tasks.values())
        assert coord.info.status == "RUNNING"
        for _, cmd in redispatched:
            coord.on_task_update(cmd.task_id, "COMPLETED",
                                 cmd.task_args["n"], "")
        coord.on_task_update(2, "COMPLETED", 2, "")
        assert coord.info.status == "COMPLETED"
        assert coord.info.result == {"joined": [0, 1, 2]}

    def test_retry_cap_fails_task(self, pkg):
        coord = _coordinator(pkg, 8, _fake_plan([(1, {})]), [_jw(pkg, 1)])
        cap = _mod(pkg, "job.master")._PlanCoordinator.MAX_TASK_RETRIES
        for _loss in range(cap + 1):
            wid = coord.tasks[0].worker_id
            coord.reassign_tasks_of_worker(
                wid, [_jw(pkg, wid + 1)], lambda *a: None)
        assert coord.info.status == "FAILED"
        assert "retried" in coord.tasks[0].error_message

    def test_no_live_workers_fails_job(self, pkg):
        coord = _coordinator(pkg, 9, _fake_plan([(1, {})]), [_jw(pkg, 1)])
        coord.reassign_tasks_of_worker(1, [], lambda *a: None)
        assert coord.info.status == "FAILED"

    def test_host_affine_plans_fail_instead_of_relocating(self, pkg):
        sent = []
        coord = _coordinator(
            pkg, 11, _fake_plan([(1, {})], relocatable=False),
            [_jw(pkg, 1)], lambda wid, cmd: sent.append(wid))
        coord.reassign_tasks_of_worker(
            1, [_jw(pkg, 2)], lambda wid, cmd: sent.append(wid))
        assert coord.info.status == "FAILED"
        assert "host-affine" in coord.tasks[0].error_message
        assert sent == [1]

    def test_real_plan_relocatability_flags(self, pkg):
        registry = _mod(pkg, "job.plan").default_registry()
        flags = {name: registry.get(name).relocatable
                 for name in ("load", "replicate", "persist", "migrate",
                              "evict", "move")}
        assert flags == {"load": True, "replicate": True, "persist": True,
                         "migrate": True, "evict": False, "move": False}

    def test_reassignment_prefers_uninvolved_workers(self, pkg):
        sent = []
        plan = _fake_plan([(1, {"n": 0}), (2, {"n": 1})])
        coord = _coordinator(
            pkg, 10, plan, [_jw(pkg, 1), _jw(pkg, 2), _jw(pkg, 3)],
            lambda wid, cmd: sent.append(wid))
        coord.reassign_tasks_of_worker(1, [_jw(pkg, 2), _jw(pkg, 3)],
                                       lambda wid, cmd: sent.append(wid))
        assert sent[2:] == [3]


# -- the registry -------------------------------------------------------------
def test_registry_names_equal_jax():
    jax_names = _mod("alluxio_tpu", "job.plan").default_registry().names()
    port = _mod("alluxio_tpu_torch", "job.plan").default_registry()
    assert port.names() == jax_names
    assert "stressbench" in port.names()


def _bench_rows(seed: int, bench: str) -> list:
    """Seeded per-task JSON summaries as a stress bench returns them: the
    worker bench's keys, or the master bench's."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(int(rng.integers(1, 5))):
        lat = sorted(float(x) for x in rng.exponential(300.0, 4))
        metrics = {"ops_per_s": float(rng.uniform(1, 1e5)),
                   "p50_us": lat[0], "p95_us": lat[1], "p99_us": lat[2],
                   "max_us": lat[3]}
        if bench == "worker":
            metrics["mb_per_s"] = float(rng.uniform(1, 1e4))
        rows.append({"bench": f"{bench}-x", "params": {"threads": 2},
                     "metrics": metrics,
                     "errors": int(rng.integers(0, 3)),
                     "duration_s": float(rng.uniform(0.1, 5))})
    if rng.random() < 0.5:
        rows.insert(int(rng.integers(0, len(rows))), None)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("bench", ["worker", "master"])
def test_stressbench_join_equal(bench, seed):
    rows = _bench_rows(seed, bench)
    got = [_mod(pkg, "job.plan").default_registry().get("stressbench").join(
        {"type": "stressbench", "bench": bench}, list(rows))
        for pkg in PACKAGES]
    assert got[1] == got[0]
    assert got[0]["tasks"] == sum(1 for r in rows if r)
    assert _mod("alluxio_tpu_torch", "job.plan").default_registry().get(
        "stressbench").join({"bench": bench}, [None]) == {}
