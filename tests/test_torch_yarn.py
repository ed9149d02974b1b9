"""The port's YARN integration (``alluxio_tpu_torch/yarn/``) against the
JAX package's, on the CPU.

- every case of JAX's ``tests/test_yarn_integration.py`` (the allocator's
  negotiation, the RM REST lifecycle, the AM's allocate-then-launch flow,
  the CLI, ``build_command``), run on each package;
- the wire: every request each package makes to ``FakeResourceManager``
  over seeded allocator rounds, an AM run, and a CLI submit, status and
  kill is the same (the AM command's package name masked);
- the launch fault of the reference: a JAX plan's command exits 0 and
  nothing listens on its master port, while the port's plans, launched
  by ``SubprocessLauncher``, give a master that answers and a worker that
  registers.
"""

from __future__ import annotations

import contextlib
import io
import random
import signal
import subprocess

import pytest

from tests.testutils.fake_yarn import FakeResourceManager
from tests.testutils.torch_deploy import (
    JAX, PACKAGES, PORT, ROOT, RecordingLauncher, ScriptedRm, listening,
    masked, mod, one_host_conf, python_on_path, record_wire,
)
from tests.testutils.torch_ha import wait_for
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

both = pytest.mark.parametrize("pkg", PACKAGES)


def _yarn(pkg):
    return mod(pkg, "yarn")


# -- ContainerAllocator (JAX's TestContainerAllocator) ------------------------
@both
class TestContainerAllocator:
    def test_spreads_to_target_across_hosts(self, pkg):
        rm = ScriptedRm(pkg, ["h0", "h1", "h2"])
        got = _yarn(pkg).ContainerAllocator("worker", 3, 1, rm).allocate()
        assert sorted(c.host for c in got) == ["h0", "h1", "h2"]
        assert rm.released == []

    def test_per_host_cap_releases_excess(self, pkg):
        rm = ScriptedRm(pkg, ["h0", "h1", "h2"],
                        rounds=[["h0", "h0", "h0"], ["h1", "h2"]])
        got = _yarn(pkg).ContainerAllocator("worker", 3, 1, rm).allocate()
        assert sorted(c.host for c in got) == ["h0", "h1", "h2"]
        assert len(rm.released) == 2

    def test_capped_hosts_leave_request_pool(self, pkg):
        rm = ScriptedRm(pkg, ["h0", "h1"], rounds=[["h0", "h0"], ["h1"]])
        _yarn(pkg).ContainerAllocator("worker", 3, 2, rm).allocate()
        assert rm.requests[1]["hosts"] == ["h1"]

    def test_not_enough_hosts_fails_fast(self, pkg):
        rm = ScriptedRm(pkg, ["h0"])
        with pytest.raises(_yarn(pkg).NotEnoughHostsError):
            _yarn(pkg).ContainerAllocator("worker", 3, 1, rm).allocate()
        assert rm.requests == []

    def test_stingy_rm_exhausts_attempts(self, pkg):
        rm = ScriptedRm(pkg, ["h0", "h1"], rounds=[])
        with pytest.raises(mod(pkg, "yarn.allocator").AllocationFailedError):
            _yarn(pkg).ContainerAllocator("worker", 2, 1, rm,
                                          max_attempts=3).allocate()
        assert len(rm.requests) == 3

    def test_preferred_host_pins_and_any_relaxes(self, pkg):
        alloc = mod(pkg, "yarn.allocator")
        rm = ScriptedRm(pkg, ["h0", "h1"])
        alloc.ContainerAllocator("master", 1, 1, rm,
                                 preferred_host="h1").allocate()
        assert rm.requests[0] == {"count": 1, "hosts": ["h1"],
                                  "relax": False, "memory_mb": 1024}
        rm2 = ScriptedRm(pkg, ["h0", "h1"])
        alloc.ContainerAllocator("master", 1, 1, rm2,
                                 preferred_host=alloc.ANY_HOST).allocate()
        assert rm2.requests[0]["relax"] is True

    def test_excess_beyond_target_released(self, pkg):
        rm = ScriptedRm(pkg, ["h0", "h1", "h2"],
                        rounds=[["h0", "h1", "h2"]])
        got = _yarn(pkg).ContainerAllocator("worker", 2, 1, rm).allocate()
        assert len(got) == 2
        assert len(rm.released) == 1


# -- YarnRestClient (JAX's TestYarnRestClient) --------------------------------
@both
class TestYarnRestClient:
    def test_submission_lifecycle(self, pkg):
        with FakeResourceManager() as rm:
            cli = _yarn(pkg).YarnRestClient(rm.endpoint)
            app_id = cli.new_application()
            assert app_id.startswith("application_")
            cli.submit(app_id, "atpu-cluster",
                       f"env python -m {pkg}.yarn.am",
                       memory_mb=2048, env={"ATPU_HOME": "/srv/atpu"})
            assert cli.state(app_id) == "ACCEPTED"
            rm.set_app_state(app_id, "RUNNING")
            assert cli.wait_for_state(app_id, ["RUNNING"],
                                      timeout=5) == "RUNNING"
            cli.kill(app_id)
            assert cli.state(app_id) == "KILLED"
            ctx = rm.apps[app_id]["ctx"]
            assert ctx["am-container-spec"]["commands"]["command"] \
                .endswith("yarn.am")
            assert ctx["resource"]["memory"] == 2048

    def test_node_hosts_filters_non_running(self, pkg):
        with FakeResourceManager(["a", "b", "c"]) as rm:
            rm.node_states["b"] = "LOST"
            assert _yarn(pkg).YarnRestClient(rm.endpoint).node_hosts() == \
                ["a", "c"]

    def test_http_error_surfaces(self, pkg):
        with FakeResourceManager() as rm:
            cli = _yarn(pkg).YarnRestClient(rm.endpoint)
            with pytest.raises(mod(pkg, "yarn.client").YarnRestError):
                cli.state("application_does_not_exist")

    def test_container_request_and_release_wire(self, pkg):
        with FakeResourceManager(["a", "b"]) as rm:
            cli = _yarn(pkg).YarnRestClient(rm.endpoint)
            got = cli.request_containers(2, ["a", "b"], True,
                                         memory_mb=4096, vcores=2)
            assert [c.host for c in got] == ["a", "b"]
            cli.release(got[0].container_id)
            assert rm.released == [got[0].container_id]
            req = rm.container_requests[0]
            assert req["relax-locality"] is True
            assert req["resource"] == {"memory": 4096, "vCores": 2}


# -- ApplicationMaster (JAX's TestApplicationMaster) --------------------------
@both
class TestApplicationMaster:
    def test_allocates_and_launches_cluster(self, pkg):
        am_mod = mod(pkg, "yarn.am")
        with FakeResourceManager(["nm-0", "nm-1", "nm-2"]) as rm:
            cli = _yarn(pkg).YarnRestClient(rm.endpoint)
            launcher = RecordingLauncher()
            am = _yarn(pkg).ApplicationMaster(
                am_mod.ClusterSpec(num_workers=3, max_workers_per_host=1,
                                   conf={"atpu.master.rpc.port": "19998"}),
                cli, launcher)
            plans = am.run()
        assert len(plans) == 4
        roles = [p.env["ATPU_ROLE"] for p in plans]
        assert roles.count("master") == 1
        assert roles.count("worker") == 3
        master_host = am.master_container.host
        worker_hosts = [c.host for c in am.worker_containers]
        assert len(set(worker_hosts)) == 3
        for p in plans:
            assert f"ATPU_MASTER_HOSTNAME={master_host}" in p.command
            assert "ATPU_MASTER_RPC_PORT=19998" in p.command
        for p in plans[1:]:
            assert "ATPU_WORKER_RAMDISK_SIZE=2048MB" in p.command
        sized = [r["resource"]["memory"]
                 for r in rm.container_requests]
        assert sized[0] == 2048 and sized[-1] == 4096
        assert launcher.plans == plans
        if pkg == PORT:
            # the port's plans name the role the shell launches
            assert [p.command.rsplit(" ", 2)[1:] for p in plans] == [
                ["alluxio_tpu_torch.shell.main", role] for role in roles]

    def test_master_host_pin(self, pkg):
        with FakeResourceManager(["nm-0", "nm-1"]) as rm:
            cli = _yarn(pkg).YarnRestClient(rm.endpoint)
            am = _yarn(pkg).ApplicationMaster(
                mod(pkg, "yarn.am").ClusterSpec(num_workers=1,
                                                master_host="nm-1"),
                cli, RecordingLauncher())
            am.run()
            assert am.master_container.host == "nm-1"


# -- the CLI and build_command (JAX's TestCli and its command test) -----------
@both
class TestCli:
    def test_submit_status_kill_roundtrip(self, pkg, capsys):
        main = mod(pkg, "yarn.__main__").main
        with FakeResourceManager() as rm:
            assert main(["--rm", rm.endpoint, "submit",
                         "--workers", "2", "--queue", "prod",
                         "-C", "atpu.master.rpc.port=19998"]) == 0
            app_id = capsys.readouterr().out.strip()
            assert app_id.startswith("application_")
            ctx = rm.apps[app_id]["ctx"]
            assert ctx["queue"] == "prod"
            cmd = ctx["am-container-spec"]["commands"]["command"]
            assert "--workers 2" in cmd
            assert "-C atpu.master.rpc.port=19998" in cmd
            assert cmd.startswith(f"python -m {pkg}.yarn.am ")
            assert main(["--rm", rm.endpoint, "status", app_id]) == 0
            assert capsys.readouterr().out.strip() == "ACCEPTED"
            assert main(["--rm", rm.endpoint, "kill", app_id]) == 0
            assert rm.apps[app_id]["state"] == "KILLED"


class TestBuildCommand:
    @both
    def test_env_assignment_quoting(self, pkg):
        cmd = mod(pkg, "yarn.am").build_command(
            f"{pkg}.worker.process", {"atpu.worker.tag": "a b"})
        assert cmd == ("env ATPU_WORKER_TAG='a b' "
                       f"python -m {pkg}.worker.process")

    def test_role_argument_follows_the_module(self):
        """The port's ``build_command`` only: the role follows the
        module."""
        cmd = mod(PORT, "yarn.am").build_command(
            "alluxio_tpu_torch.shell.main", {"atpu.worker.tag": "a b"},
            "worker")
        assert cmd == ("env ATPU_WORKER_TAG='a b' "
                       "python -m alluxio_tpu_torch.shell.main worker")


# -- the wire ------------------------------------------------------------------
def _rm_script(pkg: str, seed: int) -> tuple:
    """A seeded sequence against a fresh ``FakeResourceManager``: scripted
    allocator rounds over REST, an AM run, a CLI submit, status and kill.
    Returns (the recorded wire with the package masked, the outcomes)."""
    yarn = _yarn(pkg)
    alloc = mod(pkg, "yarn.allocator")
    main = mod(pkg, "yarn.__main__").main
    rng = random.Random(seed)
    hosts = [f"nm-{i}" for i in range(4)]
    outcomes = []
    with FakeResourceManager(hosts) as rm:
        wire = record_wire(rm)
        cli = yarn.YarnRestClient(rm.endpoint)
        for target, cap in ((3, 1), (4, 2)):
            # an over-offer on one host first: the excess is released
            rm.scripted_rounds = [["nm-0"] * 5] + [
                [rng.choice(hosts) for _ in range(rng.randint(0, 4))]
                for _ in range(rng.randint(1, 6))]
            try:
                got = yarn.ContainerAllocator(
                    "worker", target, cap, cli, max_attempts=5,
                    memory_mb=rng.choice([1024, 4096])).allocate()
                outcomes.append([c.host for c in got])
            except (alloc.AllocationFailedError,
                    alloc.NotEnoughHostsError) as e:
                outcomes.append(type(e).__name__)
        rm.scripted_rounds = None
        rm.node_states["nm-3"] = "LOST"
        am = yarn.ApplicationMaster(
            mod(pkg, "yarn.am").ClusterSpec(
                num_workers=2, conf={"atpu.master.rpc.port": "19998"}),
            cli, RecordingLauncher())
        am.run()
        outcomes.append([am.master_container.host,
                         [c.host for c in am.worker_containers]])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            outcomes.append(main(["--rm", rm.endpoint, "submit",
                                  "--workers", "2", "--name", "deploy",
                                  "-C", "atpu.worker.tag=a b"]))
            app_id = out.getvalue().strip()
            for cmd in ("status", "kill", "status"):
                outcomes.append(main(["--rm", rm.endpoint, cmd, app_id]))
        outcomes += [out.getvalue().split(), rm.apps[app_id]["state"]]
    return masked(wire, pkg, rm.endpoint), outcomes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rm_wire_is_equal_across_packages(seed):
    want = _rm_script(JAX, seed)
    got = _rm_script(PORT, seed)
    assert got == want
    wire, outcomes = got
    assert outcomes[-1] == "KILLED"
    assert [m for m, _, _ in wire].count("PUT") == 1
    assert any(p.endswith("/release") for _, p, _ in wire)
    submitted = [b for m, p, b in wire if p.endswith("/cluster/apps")]
    assert submitted[0]["am-container-spec"]["commands"]["command"] \
        .startswith("python -m <pkg>.yarn.am --rm <rm> ")


# -- the launch fault of the reference -----------------------------------------
def _launch_plans(pkg: str, tmp_path, monkeypatch):
    """An AM of ``pkg`` against a fake RM whose one host is this one,
    its plans launched by ``SubprocessLauncher``: (the launcher, the
    conf the plans carry)."""
    base = tmp_path / "c"
    conf = one_host_conf(str(base))
    monkeypatch.setenv("PATH", python_on_path(str(tmp_path / "bin")))
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    yarn_am = mod(pkg, "yarn.am")
    launcher = yarn_am.SubprocessLauncher()
    with FakeResourceManager(["localhost"]) as rm:
        plans = yarn_am.ApplicationMaster(
            yarn_am.ClusterSpec(num_workers=1, conf=conf),
            _yarn(pkg).YarnRestClient(rm.endpoint), launcher).run()
    assert [p.env["ATPU_ROLE"] for p in plans] == ["master", "worker"]
    return launcher, conf


def _stop_all(launcher) -> None:
    for p in launcher.procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in launcher.procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


@both
def test_am_plans_serve_in_the_port_not_in_the_reference(pkg, tmp_path,
                                                          monkeypatch):
    """JAX: each plan's command exits 0 within 60 s and nothing listens
    on the master's port. The port: the master answers and the worker
    registers within 60 s; both then stop on SIGTERM."""
    launcher, conf = _launch_plans(pkg, tmp_path, monkeypatch)
    port = int(conf["atpu.master.rpc.port"])
    try:
        if pkg == JAX:
            wait_for(lambda: all(p.poll() is not None
                                 for p in launcher.procs), 60.0,
                     "the JAX plans' commands to exit")
            assert [p.returncode for p in launcher.procs] == [0, 0]
            assert not listening(port)
            return
        clients = mod(pkg, "rpc.clients")
        meta = clients.MetaMasterClient(f"localhost:{port}",
                                        fastpath=False, retry_duration_s=0.5)

        blocks = clients.BlockMasterClient(f"localhost:{port}",
                                           fastpath=False,
                                           retry_duration_s=0.5)

        def answers(call):
            try:
                return bool(call())
            except Exception:  # noqa: BLE001 - not serving yet
                return False

        wait_for(lambda: answers(meta.get_master_info), 60.0,
                 "the port's master to answer")
        wait_for(lambda: answers(blocks.get_worker_infos), 60.0,
                 "the port's worker to register")
        assert [w.address.rpc_port for w in blocks.get_worker_infos()] == \
            [int(conf["atpu.worker.rpc.port"])]
        assert all(p.poll() is None for p in launcher.procs)
    finally:
        _stop_all(launcher)
    assert [p.poll() for p in launcher.procs] == [0, 0]
    assert not listening(port)
