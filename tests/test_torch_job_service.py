"""The job service on the port's cluster, against the JAX package's (the
scenarios of ``tests/test_job_service.py``, one body serving both
clusters).

Each scenario runs on a ``LocalCluster(start_job_service=True)`` of two
workers with heartbeats, once from each package: distributed load with
replication 1 and 2, migrate (cp, mv, overwrite refused), persist (an
explicit job, ``ASYNC_THROUGH`` through the master's persistence
scheduler, a rename before and after the persist, a nested mount, the
inode pin), replicate and evict, a workflow, replication control (heal,
trim, a lost block worker), task failover after a job worker is lost,
and the job master's own behaviours. Then: each package's
``JobMasterClient`` drives the other's job master.
(``tests/test_torch_local_cluster.py`` checks that no job-service thread
outlives the port's cluster: this module's clusters live beside it.)
"""

import importlib
import time

import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster(pkg: str, base: str, **overrides):
    keys = _mod(pkg, "conf").Keys
    conf = {keys.WORKER_BLOCK_HEARTBEAT_INTERVAL: "50ms"}
    conf.update({getattr(keys, k): v for k, v in overrides.items()})
    return _mod(pkg, "minicluster").LocalCluster(
        base, num_workers=2, start_job_service=True,
        start_worker_heartbeats=True, conf_overrides=conf)


class _Env:
    """A started cluster and its client, with the package beside them."""

    def __init__(self, pkg, cluster):
        self.pkg = pkg
        self.cluster = cluster
        self.fs = cluster.file_system()
        self.jc = cluster.job_client()

    def exc(self, name):
        return getattr(_mod(self.pkg, "utils.exceptions"), name)

    def run(self, config, timeout_s=60.0):
        return self.jc.wait_for_job(self.jc.run(config), timeout_s=timeout_s)

    def hosts(self, block_id):
        info = self.cluster.block_client().get_block_info(block_id)
        return {loc.address.tiered_identity.value("host")
                for loc in info.locations}

    def block_ids(self, path):
        return [f.block_info.block_id for f in
                self.cluster.fs_client().get_file_block_info_list(path)]

    def wait_hosts(self, block_id, predicate, timeout_s=10.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if predicate(self.hosts(block_id)):
                return
            time.sleep(0.02)
        raise AssertionError(f"block {block_id} locations never satisfied "
                             f"the predicate; now {self.hosts(block_id)}")

    def wait_uncached(self, path):
        for bid in self.block_ids(path):
            self.wait_hosts(bid, lambda hosts: not hosts)

    def wait_persisted(self, path, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while not self.fs.get_status(path).persisted:
            assert time.monotonic() < deadline, f"{path} never persisted"
            time.sleep(0.05)


def _start(pkg, base, **overrides):
    cluster = _cluster(pkg, base, **overrides).start()
    return _Env(pkg, cluster)


def _stop(env):
    env.fs.close()
    env.cluster.stop()


@pytest.fixture(scope="module", params=PACKAGES)
def env(request, tmp_path_factory):
    """One cluster per package for the scenarios that do not kill a
    worker (each works under paths of its own)."""
    e = _start(request.param, str(tmp_path_factory.mktemp(request.param)))
    yield e
    _stop(e)


@pytest.fixture(params=PACKAGES)
def own_env(request, tmp_path):
    """A cluster of the test's own, for the scenarios that kill a worker.
    Its client stays open: closing it would call on the dead worker until
    the RPC retry budget runs out (as the JAX test, which never closes)."""
    e = _start(request.param, str(tmp_path))
    yield e
    e.cluster.stop()


# -- distributed load ---------------------------------------------------------
def test_load_persisted_file(env):
    data = b"x" * (3 * (1 << 20) + 17)  # 3+ blocks
    env.fs.write_all("/cold", data, write_type="CACHE_THROUGH")
    env.fs.free("/cold", forced=True)
    env.wait_uncached("/cold")
    assert env.fs.get_status("/cold").persisted
    info = env.run({"type": "load", "path": "/cold", "replication": 1})
    assert info.status == "COMPLETED", info.error_message
    assert info.result["num_blocks"] == 4
    assert all(env.hosts(b) for b in env.block_ids("/cold"))
    assert env.fs.read_all("/cold") == data


def test_port_load_times_each_commit_wait_and_fetch(tmp_path):
    """The port's load samples ``Job.LoadCommitWait`` once a loaded block
    and its worker ``Worker.UfsFetchTime`` once a fetch (timers the
    reference lacks; the card's smoke run splits the load's seconds by
    them)."""
    from alluxio_tpu_torch.metrics import metrics

    e = _start("alluxio_tpu_torch", str(tmp_path))
    try:
        e.fs.write_all("/timed", b"t" * (3 << 20), write_type="CACHE_THROUGH")
        e.fs.free("/timed", forced=True)
        e.wait_uncached("/timed")
        timers = [metrics().timer(n) for n in ("Job.LoadCommitWait",
                                               "Worker.UfsFetchTime")]
        before = [t.histogram()[1:] for t in timers]
        info = e.run({"type": "load", "path": "/timed", "replication": 1})
        assert info.status == "COMPLETED", info.error_message
        for t, (s0, n0) in zip(timers, before):
            s1, n1 = t.histogram()[1:]
            assert n1 - n0 == info.result["num_blocks"] == 3
            assert s1 > s0
    finally:
        _stop(e)


def test_load_replication_2(env):
    env.fs.write_all("/r2", b"y" * (1 << 20), write_type="CACHE_THROUGH")
    env.fs.free("/r2", forced=True)
    env.wait_uncached("/r2")
    info = env.run({"type": "load", "path": "/r2", "replication": 2})
    assert info.status == "COMPLETED", info.error_message
    assert env.hosts(env.block_ids("/r2")[0]) == {"localhost-w0",
                                                  "localhost-w1"}


def test_load_already_loaded_is_noop(env):
    env.fs.write_all("/warm", b"z" * 1024, write_type="CACHE_THROUGH")
    info = env.run({"type": "load", "path": "/warm", "replication": 1})
    assert info.status == "COMPLETED"


# -- migrate ------------------------------------------------------------------
def test_distributed_cp(env):
    env.fs.create_directory("/src")
    for i in range(4):
        env.fs.write_all(f"/src/f{i}", f"file-{i}".encode() * 100)
    info = env.run({"type": "migrate", "source": "/src",
                    "destination": "/dst"})
    assert info.status == "COMPLETED", info.error_message
    assert info.result["num_files"] == 4
    for i in range(4):
        assert env.fs.read_all(f"/dst/f{i}") == f"file-{i}".encode() * 100
        assert env.fs.exists(f"/src/f{i}")


def test_distributed_mv(env):
    env.fs.write_all("/mv-src", b"move me")
    info = env.run({"type": "migrate", "source": "/mv-src",
                    "destination": "/mv-dst", "delete_source": True})
    assert info.status == "COMPLETED", info.error_message
    assert env.fs.read_all("/mv-dst") == b"move me"
    assert not env.fs.exists("/mv-src")


def test_overwrite_false_fails(env):
    env.fs.write_all("/ow-a", b"1")
    env.fs.write_all("/ow-b", b"2")
    info = env.run({"type": "migrate", "source": "/ow-a",
                    "destination": "/ow-b"})
    assert info.status == "FAILED"


# -- persist ------------------------------------------------------------------
def test_async_persist_job(env):
    env.fs.write_all("/p", b"persist me" * 1000)  # MUST_CACHE default
    assert not env.fs.get_status("/p").persisted
    info = env.run({"type": "persist", "path": "/p"})
    assert info.status == "COMPLETED", info.error_message
    assert env.fs.get_status("/p").persisted


def test_async_through_persists_via_scheduler(env):
    """ASYNC_THROUGH completes without a persist call: the master's
    persistence scheduler drains the request into a persist job; the UFS
    file then holds the payload."""
    payload = b"async" * 5000
    env.fs.write_all("/ap", payload, write_type="ASYNC_THROUGH")
    env.wait_persisted("/ap")
    assert env.fs.read_all("/ap") == payload
    with open(env.fs.get_status("/ap").ufs_path, "rb") as f:
        assert f.read() == payload


def test_rename_before_persist_keeps_durability(env):
    env.fs.create_directory("/rp", recursive=True)
    env.fs.write_all("/rp/f", b"rename me" * 1000,
                     write_type="ASYNC_THROUGH")
    env.fs.rename("/rp", "/rp-moved")
    env.wait_persisted("/rp-moved/f")
    assert not env.fs.exists("/rp/f")
    assert not env.fs.exists("/rp")


def test_rename_after_persist_moves_ufs_tree(env):
    env.fs.create_directory("/d", recursive=True)
    env.fs.write_all("/d/f", b"durable" * 500, write_type="ASYNC_THROUGH")
    env.wait_persisted("/d/f")
    assert env.fs.get_status("/d").persistence_state == "PERSISTED"
    env.fs.rename("/d", "/d2")
    assert not env.fs.exists("/d/f")
    assert not env.fs.exists("/d")
    assert env.fs.get_status("/d2/f").persisted
    assert env.fs.read_all("/d2/f") == b"durable" * 500


def test_rename_into_unpersisted_parent_then_rename_parent(env):
    env.fs.create_directory("/p2", recursive=True)  # not persisted
    env.fs.create_directory("/d0", recursive=True)
    env.fs.write_all("/d0/f", b"x" * 600, write_type="ASYNC_THROUGH")
    env.wait_persisted("/d0/f")
    env.fs.rename("/d0", "/p2/d")
    assert env.fs.get_status("/p2").persistence_state == "PERSISTED"
    env.fs.rename("/p2", "/moved2")
    assert not env.fs.exists("/p2")
    assert not env.fs.exists("/p2/d")
    assert env.fs.get_status("/moved2/d/f").persisted
    assert env.fs.read_all("/moved2/d/f") == b"x" * 600


def test_user_dir_survives_last_persisted_file_delete(env, tmp_path):
    """A mounted UFS (a local directory here; the JAX case mounts its
    in-memory object store, which the port does not have)."""
    store = tmp_path / f"bcrumb-{env.pkg}"
    store.mkdir()
    env.fs.mount("/os", str(store))
    env.fs.create_directory("/os/d", recursive=True)
    env.fs.write_all("/os/d/f", b"y" * 300, write_type="CACHE_THROUGH")
    env.fs.write_all("/os/d/cacheonly", b"z" * 100, write_type="MUST_CACHE")
    env.fs.delete("/os/d/f")
    assert env.fs.exists("/os/d")
    assert env.fs.read_all("/os/d/cacheonly") == b"z" * 100
    env.fs.unmount("/os")


def test_nested_mount_persist_stops_at_mount_point(env, tmp_path):
    store = tmp_path / f"nmt-{env.pkg}"
    store.mkdir()
    env.fs.create_directory("/nm", recursive=True)  # cache-only
    env.fs.mount("/nm/inner", str(store))
    env.fs.write_all("/nm/inner/f", b"n" * 200, write_type="CACHE_THROUGH")
    assert env.fs.get_status("/nm/inner/f").persisted
    assert env.fs.get_status("/nm").persistence_state != "PERSISTED"
    assert env.fs.exists("/nm")
    assert (store / "f").read_bytes() == b"n" * 200
    env.fs.unmount("/nm/inner")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_persistence_scheduler_skips_an_inflight_file(pkg):
    """A persist request for a file whose job is still running (the file
    asked for again before its job ended) must not start a second job
    for it. The JAX scheduler queues the popped id without looking at
    its in-flight jobs and submits two; the port's submits one."""
    from types import SimpleNamespace

    class Fsm:
        def __init__(self):
            self.requests = [{7}, {7}]

        def pop_persist_requests(self):
            return self.requests.pop(0) if self.requests else set()

        @staticmethod
        def current_path_of(inode_id):
            return f"/f{inode_id}"

    class Jobs:
        def __init__(self):
            self.submitted = []

        def run(self, config):
            self.submitted.append(config)
            return len(self.submitted)

        @staticmethod
        def get_status(job_id):
            return SimpleNamespace(status="RUNNING", error_message="")

    jobs = Jobs()
    sched = _mod(pkg, "master.persistence").PersistenceScheduler(Fsm(), jobs)
    sched.heartbeat()
    sched.heartbeat()
    assert [c["inode_id"] for c in jobs.submitted] == \
        ([7, 7] if pkg == "alluxio_tpu" else [7])
    assert sched.inflight_count == len(jobs.submitted)


def test_persist_now_rejects_wrong_inode(env):
    env.fs.write_all("/pin", b"x" * 100)
    real_id = env.fs.get_status("/pin").file_id
    with pytest.raises(env.exc("FileDoesNotExistError")):
        env.fs.persist_now("/pin", expected_id=real_id + 999)


# -- replicate, evict, workflow -----------------------------------------------
def test_replicate_block(env):
    env.fs.write_all("/rep", b"r" * 4096)
    bid = env.block_ids("/rep")[0]
    assert len(env.hosts(bid)) == 1
    info = env.run({"type": "replicate", "block_id": bid, "replicas": 1})
    assert info.status == "COMPLETED", info.error_message
    assert len(env.hosts(bid)) == 2


def test_evict_block(env):
    env.fs.write_all("/ev", b"e" * 4096, write_type="CACHE_THROUGH")
    bid = env.block_ids("/ev")[0]
    info = env.run({"type": "evict", "block_id": bid, "replicas": 1})
    assert info.status == "COMPLETED", info.error_message
    env.wait_hosts(bid, lambda hosts: not hosts)


def test_sequential_workflow(env):
    env.fs.write_all("/wf-src", b"w" * 2048)
    info = env.run({"type": "workflow", "jobs": [
        {"type": "migrate", "source": "/wf-src", "destination": "/wf-mid"},
        {"type": "migrate", "source": "/wf-mid", "destination": "/wf-dst"},
    ]})
    assert info.status == "COMPLETED", info.error_message
    assert env.fs.read_all("/wf-dst") == b"w" * 2048
    assert len(info.children) == 2


# -- replication control ------------------------------------------------------
def test_under_replicated_file_heals(env):
    env.fs.write_all("/heal", b"h" * 8192)
    env.fs.set_attribute("/heal", replication_min=2)
    env.wait_hosts(env.block_ids("/heal")[0], lambda hosts: len(hosts) == 2)


def test_over_replicated_file_trims(env):
    env.fs.write_all("/trim", b"t" * 8192, write_type="CACHE_THROUGH")
    bid = env.block_ids("/trim")[0]
    env.run({"type": "replicate", "block_id": bid, "replicas": 1})
    env.wait_hosts(bid, lambda hosts: len(hosts) == 2)
    env.fs.set_attribute("/trim", replication_max=1)
    env.wait_hosts(bid, lambda hosts: len(hosts) == 1)


def test_uncached_persisted_block_comes_back_from_the_ufs(env):
    """A persisted file with no cached copy and ``replication_min`` 1: the
    port's checker re-replicates its block from the UFS. The reference's
    launches replicate jobs that fail for want of a cached copy, again
    every heartbeat, and the block never comes back (the fault that made
    the prefetch bench's worker-kill drill fail when eviction pressure
    had dropped the surviving copy of a block)."""
    path = "/heal-cold"
    env.fs.write_all(path, b"c" * 8192, write_type="CACHE_THROUGH")
    env.fs.free(path, forced=True)
    env.wait_uncached(path)
    assert env.fs.get_status(path).persisted
    env.fs.set_attribute(path, replication_min=1)
    bid = env.block_ids(path)[0]
    if env.pkg == "alluxio_tpu_torch":
        env.wait_hosts(bid, lambda hosts: len(hosts) == 1)
        assert env.fs.read_all(path) == b"c" * 8192
        return
    checker = env.cluster.master.replication_checker
    deadline = time.monotonic() + 10.0
    failed = None
    while failed is None and time.monotonic() < deadline:
        job_id = checker._inflight.get(bid)
        if job_id is not None and job_id >= 0:
            info = env.jc.get_status(job_id)
            if info.status == "FAILED":
                failed = info
        time.sleep(0.02)
    assert failed is not None, "the reference's checker launched no job"
    assert "no cached copy to replicate from" in failed.error_message
    assert not env.hosts(bid)


def test_lost_worker_triggers_re_replication(own_env):
    """Kill a block worker holding one of two copies: the checker restores
    replication_min on a third worker and its job worker."""
    env = own_env
    env.fs.write_all("/elastic", b"e" * 8192)
    env.fs.set_attribute("/elastic", replication_min=2)
    bid = env.block_ids("/elastic")[0]
    env.wait_hosts(bid, lambda hosts: len(hosts) == 2)
    cluster = env.cluster
    cluster.add_worker()
    jw = _mod(env.pkg, "job.process").make_job_worker(
        cluster.conf, cluster.job_master.address, cluster.master.address,
        "localhost-w2")
    jw.start()
    cluster.job_workers.append(jw)
    victim = cluster.workers[1]
    victim.stop()
    cluster.master.block_master.forget_worker(victim.worker.worker_id)
    env.wait_hosts(bid, lambda hosts: len(hosts) == 2
                   and "localhost-w1" not in hosts, timeout_s=15.0)


# -- task failover ------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES)
def test_lost_job_worker_tasks_fail_over(pkg, tmp_path):
    """A job worker stops with load tasks queued for it: the job master
    expires it and hands its tasks to the live job worker, and the load
    completes with every block cached on that worker's host."""
    env = _start(pkg, str(tmp_path), JOB_MASTER_WORKER_TIMEOUT="1500ms",
                 JOB_MASTER_LOST_WORKER_INTERVAL="100ms")
    try:
        env.fs.write_all("/fo", b"f" * (4 << 20), write_type="CACHE_THROUGH")
        env.fs.free("/fo", forced=True)
        env.wait_uncached("/fo")
        lost = env.cluster.job_workers[1]
        lost.stop()
        info = env.run({"type": "load", "path": "/fo", "replication": 1})
        assert info.status == "COMPLETED", info.error_message
        assert info.result["num_blocks"] == 4
        live = env.cluster.job_workers[0].worker_id
        assert {t.worker_id for t in info.tasks} == {live}
        assert all(env.hosts(b) == {"localhost-w0"}
                   for b in env.block_ids("/fo"))
        assert [w["hostname"] for w in env.jc.list_workers()] == \
            ["localhost-w0"]
    finally:
        _stop(env)


# -- the job master's behaviours ----------------------------------------------
def test_status_of_unknown_job(env):
    with pytest.raises(env.exc("JobDoesNotExistError")):
        env.jc.get_status(99999)


def test_list_jobs_and_types(env):
    assert "load" in env.jc.list_plan_types()
    env.fs.write_all("/lj", b"x")
    job_id = env.jc.run({"type": "persist", "path": "/lj"})
    env.jc.wait_for_job(job_id)
    assert any(j.job_id == job_id for j in env.jc.list_jobs())


def test_bad_job_config_fails_cleanly(env):
    info = env.run({"type": "load"})  # missing path
    assert info.status == "FAILED"
    assert "path" in info.error_message


def test_cancel_a_running_job(env):
    env.fs.write_all("/cx", b"c" * 1024)
    info = env.run({"type": "workflow", "jobs": []})
    assert info.status == "COMPLETED"
    env.jc.cancel(info.job_id)  # a finished job stays as it was
    assert env.jc.get_status(info.job_id).status == "COMPLETED"
    with pytest.raises(env.exc("JobDoesNotExistError")):
        env.jc.cancel(424242)


# -- each package's client against the other's job master ---------------------
@pytest.mark.parametrize("server,client", [PACKAGES, PACKAGES[::-1]])
def test_client_drives_the_other_job_master(server, client, tmp_path):
    env = _start(server, str(tmp_path))
    try:
        jc = _mod(client, "rpc.job_service").JobMasterClient(
            env.cluster.job_master.address)
        mine = _mod(client, "job.wire").JobInfo
        env.fs.write_all("/xw", b"q" * (2 << 20), write_type="CACHE_THROUGH")
        env.fs.free("/xw", forced=True)
        env.wait_uncached("/xw")
        info = jc.wait_for_job(jc.run({"type": "load", "path": "/xw"}))
        assert isinstance(info, mine)
        assert info.status == "COMPLETED", info.error_message
        assert info.result["num_blocks"] == 2
        # the client's decode of the job equals the server's own record
        theirs = env.jc.get_status(info.job_id)
        assert info.to_wire() == theirs.to_wire()
        assert "load" in jc.list_plan_types()
        assert sorted(w["hostname"] for w in jc.list_workers()) == \
            ["localhost-w0", "localhost-w1"]
        with pytest.raises(getattr(_mod(client, "utils.exceptions"),
                                   "JobDoesNotExistError")):
            jc.get_status(31337)
    finally:
        _stop(env)


# -- a job worker stops while its task blocks ---------------------------------
class _OneRunJobMaster:
    """A job master client whose first heartbeat hands the worker one
    task of the ``block`` plan."""

    def __init__(self, pkg):
        self._pkg = pkg
        self._sent = False

    def register_worker(self, hostname):
        return 1

    def heartbeat(self, worker_id, health, updates):
        if self._sent:
            return []
        self._sent = True
        cmd = _mod(self._pkg, "job.wire").JobCommand(
            kind="run", job_id=1, task_id=0, job_config={"type": "block"})
        return [cmd.to_wire()]


class _BlockingPlan:
    name = "block"

    def __init__(self):
        import threading

        self.started = threading.Event()
        self.release = threading.Event()

    def run_task(self, job_config, task_args, ctx):
        self.started.set()
        self.release.wait(30.0)
        return None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_job_worker_stop_returns_while_a_task_blocks(pkg):
    """``JobWorker.stop()`` returns within 2 s while a task it runs
    blocks (JAX's does; the port's joined its pool behind the task until
    the task ended). The port's ``join`` then waits for the task and
    joins the pool's threads."""
    plan = _BlockingPlan()
    registry = _mod(pkg, "job.plan").PlanRegistry()
    registry.register(plan)
    jw = _mod(pkg, "job.worker").JobWorker(
        _OneRunJobMaster(pkg), None, "h", registry=registry,
        heartbeat_interval_s=0.05)
    jw.start()
    try:
        assert plan.started.wait(10.0), "the task never started"
        t = time.monotonic()
        jw.stop()
        assert time.monotonic() - t < 2.0
    finally:
        plan.release.set()
    if pkg == "alluxio_tpu_torch":
        jw.join()
        assert not any(th.is_alive() for th in jw._executor._pool._threads)
