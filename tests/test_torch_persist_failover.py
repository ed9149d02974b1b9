"""Async persistence across a change of master, on the CPU: the repair
behind ``tests/test_torch_shell_tools.py::
test_new_primary_persists_after_a_failover``.

- A file completed ASYNC_THROUGH on a master whose persistence scheduler
  has not taken its request yet, then the master restarted on the same
  journal: the new master persists it. The request queue lives in
  memory, so the port's new scheduler starts from the journal's
  TO_BE_PERSISTED files (reference: ``DefaultFileSystemMaster.start`` on
  gaining primacy); JAX's starts empty, and the file stayed
  TO_BE_PERSISTED for good. The same holds for a master that steps down
  and is elected again, or a failover to another master.
- A persist job that fails while the cluster settles is retried after a
  delay that doubles, ``MAX_ATTEMPTS`` jobs in all; JAX's scheduler
  resubmits at once and gives up after three jobs, which a
  new primary whose worker has not re-registered yet (no block location,
  so the job fails) used up within seconds.
"""

import time
from types import SimpleNamespace

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)
from tests.testutils import torch_shell as ts

PORT, JAX = "alluxio_tpu_torch", "alluxio_tpu"


def test_restarted_master_persists_what_its_predecessor_queued(tmp_path):
    from alluxio_tpu_torch.minicluster import LocalCluster

    with LocalCluster(str(tmp_path), num_workers=1, start_job_service=True,
                      start_worker_heartbeats=True) as cluster:
        # no scheduler takes the request before the restart
        cluster.master.detach_job_service()
        fs = cluster.file_system()
        try:
            fs.write_all("/q", b"q" * 3000, write_type="ASYNC_THROUGH")
            assert fs.get_status("/q").persistence_state == \
                "TO_BE_PERSISTED"
        finally:
            fs.close()
        cluster.restart_master()
        fs = cluster.file_system()
        try:
            deadline = time.monotonic() + 30
            while fs.get_status("/q").persistence_state != "PERSISTED":
                assert time.monotonic() < deadline, "never persisted"
                time.sleep(0.1)
        finally:
            fs.close()
        ufs = tmp_path / "underFSStorage" / "q"
        assert ufs.read_bytes() == b"q" * 3000


def test_requeue_takes_completed_unpersisted_files_only(tmp_path):
    from alluxio_tpu_torch.minicluster import LocalCluster

    with LocalCluster(str(tmp_path), num_workers=1,
                      start_worker_heartbeats=True) as cluster:
        fsm = cluster.master.fs_master
        fs = cluster.file_system()
        try:
            fs.write_all("/async", b"a" * 100, write_type="ASYNC_THROUGH")
            fs.write_all("/through", b"t" * 100,
                         write_type="CACHE_THROUGH")
            fs.write_all("/cached", b"c" * 100, write_type="MUST_CACHE")
            open_file = fs.create_file("/open", write_type="ASYNC_THROUGH")
            fsm.pop_persist_requests()
            assert fsm.requeue_unpersisted() == 1
            ids = fsm.pop_persist_requests()
            assert {str(fsm.current_path_of(i)) for i in ids} == {"/async"}
            open_file.close()
        finally:
            fs.close()


class _Fsm:
    def __init__(self):
        self.requests = [{7}]

    def pop_persist_requests(self):
        return self.requests.pop(0) if self.requests else set()

    @staticmethod
    def current_path_of(inode_id):
        return f"/f{inode_id}"


class _Jobs:
    """Each submitted job fails until ``fail_until`` jobs were run."""

    def __init__(self, fail_until: int):
        self.submitted = []
        self.fail_until = fail_until

    def run(self, config):
        self.submitted.append(config)
        return len(self.submitted)

    def get_status(self, job_id):
        failed = job_id <= self.fail_until
        return SimpleNamespace(status="FAILED" if failed else "COMPLETED",
                               error_message="no single worker holds "
                                             "all cached blocks")


@pytest.mark.parametrize("pkg", ts.PACKAGES)
def test_failed_persist_backs_off_and_retries(pkg):
    """Four jobs fail, the fifth completes, one 0.5 s tick at a time:
    JAX's scheduler submits three jobs on three ticks and gives up; the
    port's waits 1, 2, 4 and 8 s after each failure it sees and gets the
    file persisted by the fifth."""
    jobs = _Jobs(fail_until=4)
    mod = ts.mod(pkg, "master.persistence")
    now = [0.0]
    if pkg == PORT:
        sched = mod.PersistenceScheduler(_Fsm(), jobs, clock=lambda: now[0])
    else:
        sched = mod.PersistenceScheduler(_Fsm(), jobs)
    submitted_at = []
    for _ in range(80):
        n = len(jobs.submitted)
        sched.heartbeat()
        if len(jobs.submitted) > n:
            submitted_at.append(now[0])
        now[0] += 0.5
    if pkg == JAX:
        assert submitted_at == [0.0, 0.5, 1.0]
    else:
        assert submitted_at == [0.0, 1.5, 4.0, 8.5, 17.0]
    assert sched.inflight_count == 0


def test_failed_persist_gives_up_after_max_attempts():
    jobs = _Jobs(fail_until=10 ** 6)
    now = [0.0]
    sched = ts.mod(PORT, "master.persistence").PersistenceScheduler(
        _Fsm(), jobs, clock=lambda: now[0])
    for _ in range(4000):
        sched.heartbeat()
        now[0] += 0.5
    assert len(jobs.submitted) == sched.MAX_ATTEMPTS
    # 1 + 2 + ... + 32 s, then 60 s for each of the rest
    gaps = sum(min(2 ** (a - 1), 60) for a in range(1, sched.MAX_ATTEMPTS))
    assert 600 < gaps < 720
    assert sched.inflight_count == 0
