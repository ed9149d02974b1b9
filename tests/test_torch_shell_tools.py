"""The port's operator tools against the JAX package's, on the CPU, and
the three repairs that came before the shells.

- ``validateConf``, ``validateEnv``, ``runOperation`` and ``format``:
  JAX's ``tests/test_shell.py`` (``TestValidateConf``, ``TestFormat``)
  and ``tests/test_validate_env.py`` (the task framework and the env
  tasks), run through both packages on the same seeded script against
  each package's ``LocalCluster`` (``tests/testutils/torch_shell.py``);
  what they print must be equal once the masked values are masked, and
  ``runOperation``'s measured seconds and rate and a directory's free
  space too (``validateHms`` is held against JAX's in
  ``tests/test_torch_shell.py``);
- the master web server's ``/config`` lists every key of the registry
  with credentials masked, as JAX's does;
- repair (a): both loaders take ``atpu.tpu.prefetch.buffer.batches``
  from the file system's conf;
- repair (b): a launched master attaches the replication checker and the
  persistence scheduler to the job master its conf names, so on the
  port's process cluster an ASYNC_THROUGH file reaches PERSISTED (also
  written after a failover, on the new primary), while on JAX's it stays
  unpersisted (a difference from the reference, which has the gap);
- repair (c): the copied credential mask agrees with JAX's.
"""

import contextlib
import io
import json
import logging
import os
import re
import socket
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils import torch_shell as ts  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PORT, JAX = "alluxio_tpu_torch", "alluxio_tpu"
BOOT_S = 60.0
_TIMING = re.compile(r"in [\d.]+s \([\d.]+ op/s\)")
_FREE = re.compile(r"\d+ MiB free")


def _validate_clean(pkg, cluster, fs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ts.mod(pkg, "shell.validate").main(
            [], conf=ts.shell_conf(pkg, cluster))
    return rc, ts.mask(out.getvalue(), ts.cluster_ports(cluster))


def _validate_site(pkg, cluster, fs):
    site = os.path.join(cluster._base, "site.properties")
    with open(site, "w") as f:
        f.write("# comment\n"
                "atpu.worker.tieredstroe.levels=2\n"
                "atpu.worker.tieredstore.levels=many\n"
                "atpu.worker.tieredstore.level1.alias=SSD\n"
                "atpu.fuse.mount.point=/mnt/x\n"
                "atpu.tpu.prefetch.buffer.batches=4\n"
                "some.external.prop=1\n"
                "not a key value line\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ts.mod(pkg, "shell.validate").main(
            ["--site", site], conf=ts.shell_conf(pkg, cluster))
    return rc, out.getvalue()


def _validate_semantic(pkg, cluster, fs):
    conf = ts.shell_conf(pkg, cluster)
    conf.set("atpu.master.embedded.journal.election.timeout.min", "1s")
    conf.set("atpu.master.embedded.journal.election.timeout.max", "500ms")
    return ts.mod(pkg, "shell.validate").validate(conf)


def _env_conf(pkg, cluster):
    """The cluster's conf with its web and worker ports at ports the
    cluster serves: a default port might be taken or not by whatever else
    runs on the host."""
    conf = ts.shell_conf(pkg, cluster)
    conf.set("atpu.master.web.port", cluster.master.rpc_port)
    conf.set("atpu.worker.rpc.port", cluster.workers[0].port)
    return conf


def _env_mask(text: str, cluster) -> str:
    # a directory's free space is the host's, measured
    return _FREE.sub("<FREE> MiB free",
                     ts.mask(text, ts.cluster_ports(cluster)))


def _env_rows(pkg, cluster, fs):
    env = ts.mod(pkg, "shell.validate_env")
    rows = env.env_tool(_env_conf(pkg, cluster),
                        conf_dir=cluster._base).run_all()
    return [(r.name, r.state, _env_mask(r.message, cluster),
             _env_mask(r.advice, cluster)) for r in rows]


def _env_cli(pkg, cluster, fs):
    out = io.StringIO()
    rc = ts.mod(pkg, "shell.validate_env").main_env(
        ["--conf-dir", cluster._base], conf=_env_conf(pkg, cluster),
        out=out)
    return rc, _env_mask(out.getvalue(), cluster)


def _runop(*argv):
    def step(pkg, cluster, fs):
        out = io.StringIO()
        rc = ts.mod(pkg, "shell.run_operation").main(
            list(argv), conf=ts.shell_conf(pkg, cluster), out=out)
        return rc, _TIMING.sub("in <S>s (<RATE> op/s)", out.getvalue())

    return step


def _runop_tree(pkg, cluster, fs):
    """Which operation numbers made a file, and their sizes (which
    thread took which number is the scheduler's)."""
    return sorted((int(i.name.rsplit("-", 1)[1]), i.length)
                  for i in fs.list_status("/RunOperationDir"))


SETUPS = {"validate_clean": _validate_clean,
          "validate_site": _validate_site,
          "validate_semantic": _validate_semantic,
          "env_rows": _env_rows, "env_cli": _env_cli,
          "runop_create": _runop("-op", "CreateFile", "-n", "200", "-t",
                                 "4", "-s", "1024"),
          "runop_empty": _runop("-op", "CreateAndDeleteEmptyFile", "-n",
                                "20", "-t", "2", "-d", "/RunOpEmpty"),
          "runop_list": _runop("-op", "ListStatus", "-n", "10", "-d",
                               "/RunOpEmpty"),
          "runop_bad": _runop("-op", "ListStatus", "-t", "0"),
          "runop_tree": _runop_tree}
SCRIPT = [("py", name) for name in SETUPS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("shtools") / "c")
    return {pkg: ts.run_script(pkg, base, SCRIPT, SETUPS, cluster_kwargs={
        "start_job_service": False,
        "conf_overrides": {"atpu.master.fastpath.dir": base}})
        for pkg in ts.PACKAGES}


@pytest.mark.parametrize("sid", [ts.step_id(i, s)
                                 for i, s in enumerate(SCRIPT)])
def test_tool_matches_jax(runs, sid):
    assert runs[PORT][sid] == runs[JAX][sid]


def test_tools_did_what_the_jax_tests_check(runs):
    got = {k.split(" ", 2)[2]: v for k, v in runs[PORT].items()}
    rc, out = got["validate_clean"]
    assert rc == 0 and "0 error(s)" in out
    rc, out = got["validate_site"]
    assert rc == 1
    assert "tieredstroe" in out and "unknown property" in out
    assert "many" in out and out.count("ERROR") == 2
    assert out.count("WARN") == 2
    errors, _ = got["validate_semantic"]
    assert any("election timeout" in e for e in errors)
    rows = {r[0]: r for r in got["env_rows"]}
    assert rows["ssh.masters"][1] == "SKIPPED"
    assert rows["cluster.conf"][1] in ("OK", "WARNING")
    assert rows["native.lib"][1] in ("OK", "WARNING")
    assert got["env_cli"][0] == 0
    assert got["runop_create"] == (0, "CreateFile: 200/200 ok in <S>s "
                                      "(<RATE> op/s)\n")
    assert got["runop_bad"][0] == 2
    assert got["runop_tree"] == [(n, 1024) for n in range(200)]
    assert got["runop_empty"] == (0, "CreateAndDeleteEmptyFile: 20/20 ok "
                                     "in <S>s (<RATE> op/s)\n")


# -- the pieces that need no cluster ------------------------------------------
def _env(pkg):
    return ts.mod(pkg, "shell.validate_env")


def test_validation_framework_matches_jax():
    """A task that raises becomes a FAILED row; ``print_results`` exits 0
    with warnings and 1 with a failure (JAX's ``TestTaskFramework``)."""
    seen = []
    for pkg in ts.PACKAGES:
        env = _env(pkg)
        tool = env.ValidationTool("t")
        tool.add("boom", lambda: 1 / 0)
        tool.add("fine", lambda env=env: env.TaskResult("fine", env.OK,
                                                        "yes"))
        rows = [(r.name, r.state, r.message) for r in tool.run_all()]
        buf = io.StringIO()
        codes = (env.print_results("t", [env.TaskResult("a", env.OK),
                                         env.TaskResult("b", env.WARNING,
                                                        "w")], out=buf),
                 env.print_results("t", [env.TaskResult("a", env.FAILED,
                                                        "x")], out=buf))
        seen.append((rows, codes, buf.getvalue()))
    assert seen[1] == seen[0]
    assert seen[0][0][0][1] == "FAILED" and "ZeroDivisionError" in \
        seen[0][0][0][2]
    assert seen[0][1] == (0, 1)


def test_env_port_and_dir_tasks_match_jax(tmp_path):
    """JAX's ``TestEnvTasks``: a free port is OK and a serving one warns;
    a writable tier directory is made and OK, an empty path skips, a
    read-only one fails (root may write it anyway: either outcome, the
    same in both)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    seen = []
    try:
        for pkg in ts.PACKAGES:
            env = _env(pkg)
            ro = tmp_path / f"ro-{pkg}"
            ro.mkdir()
            ro.chmod(0o500)
            try:
                rows = [env._check_port("p", "127.0.0.1", 0),
                        env._check_port("p", "127.0.0.1",
                                        srv.getsockname()[1]),
                        env._check_dir("d", str(tmp_path / pkg / "tier0"),
                                       1 << 10),
                        env._check_dir("d", "", 1),
                        env._check_dir("d", str(ro), 1 << 10)]
            finally:
                ro.chmod(0o700)
            seen.append([(r.name, r.state, re.sub(
                r"\d+ MiB", "<MIB>", r.message.replace(pkg, "<PKG>")))
                for r in rows])
            assert (tmp_path / pkg / "tier0").is_dir()
    finally:
        srv.close()
    assert seen[1] == seen[0]
    assert [r[1] for r in seen[0][:4]] == ["OK", "WARNING", "OK",
                                           "SKIPPED"]
    assert "already serving" in seen[0][1][2]


@pytest.mark.parametrize("target", ["master", "worker", "all", "bogus"])
def test_format_matches_jax(tmp_path, target, monkeypatch, capsys):
    """``format`` wipes the journal folder and the worker's directories
    named by the configuration (JAX's ``TestFormat``), here through
    ``main`` with the directories under ``tmp_path`` only."""
    seen = []
    for pkg in ts.PACKAGES:
        root = tmp_path / pkg
        journal = root / "journal"
        journal.mkdir(parents=True)
        (journal / "seg1").write_text("x")
        (root / "wdata" / "blk").mkdir(parents=True)
        (root / "wdata" / "blk" / "b1").write_text("y")
        for key, value in (("ATPU_MASTER_JOURNAL_FOLDER", journal),
                           ("ATPU_WORKER_DATA_FOLDER", root / "wdata"),
                           ("ATPU_WORKER_TIEREDSTORE_LEVELS", 1),
                           ("ATPU_WORKER_TIEREDSTORE_LEVEL0_DIRS_PATH",
                            root / "tier0")):
            monkeypatch.setenv(key, str(value))
        rc = ts.mod(pkg, "shell.format").main([target])
        out = capsys.readouterr()
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        seen.append((rc, out.out.replace(str(root), "<ROOT>"),
                     out.err, left))
    assert seen[1] == seen[0]
    assert seen[0][0] == (1 if target == "bogus" else 0)
    if target in ("master", "all"):
        assert "journal/seg1" not in seen[0][3]
    if target in ("worker", "all"):
        assert "wdata/blk" not in seen[0][3] and "tier0" in seen[0][3]


# -- the master web server's /config ------------------------------------------
def _config_route(pkg, base):
    lc = ts.mod(pkg, "minicluster.local_cluster")
    with ts.fresh_metrics(pkg), lc.LocalCluster(
            base, num_workers=0, conf_overrides={
                "atpu.master.web.enabled": True,
                "atpu.master.web.port": 0,
                "atpu.security.login.token": "s3cret",
                "atpu.tpu.prefetch.buffer.batches": 4}) as c:
        url = f"http://127.0.0.1:{c.master.web_port}/api/v1/master/config"
        with urllib.request.urlopen(url, timeout=10) as resp:
            rows = json.loads(resp.read())["config"]
        with urllib.request.urlopen(url.replace("/api/v1/master", ""),
                                    timeout=10) as resp:
            page = resp.read().decode()
    registry = ts.mod(pkg, "conf.property_key").REGISTRY.all_keys()
    return rows, set(registry), page


def test_config_route_matches_jax(tmp_path):
    got = {pkg: _config_route(pkg, str(tmp_path / pkg))
           for pkg in ts.PACKAGES}
    rows, registry, page = got[PORT]
    jrows, _, jpage = got[JAX]
    assert registry <= set(rows)
    # template members are minted on demand by whatever ran before in
    # this process: the named keys must agree
    template = ts.mod(PORT, "conf.property_key").Template
    assert {k for k in rows if template.match(k) is None} == \
        {k for k in jrows if template.match(k) is None}
    assert rows["atpu.security.login.token"] == {
        "value": "******", "source": "RUNTIME"} == \
        jrows["atpu.security.login.token"]
    assert rows["atpu.tpu.prefetch.buffer.batches"] == \
        jrows["atpu.tpu.prefetch.buffer.batches"] == \
        {"value": "4", "source": "RUNTIME"}
    # the port's cluster sets its fast-path directory (a deliberate
    # difference of LocalCluster): compare what neither cluster set
    unset = {k for k, v in jrows.items() if k in rows and
             v["source"] == rows[k]["source"] == "DEFAULT"}
    assert len(unset) > 150
    assert {k: rows[k] for k in unset} == {k: jrows[k] for k in unset}
    assert "Effective configuration" in page and \
        "Effective configuration" in jpage
    assert "s3cret" not in json.dumps(rows) + page


@pytest.mark.parametrize("name,value", [
    ("atpu.security.login.token", "t0k"),
    ("atpu.security.login.token", ""),
    ("atpu.master.hostname", "h"),
    ("atpu.underfs.s3.secret.key", "abc"),
    ("fs.azure.account.key", "k"),
    ("atpu.some.password", None),
])
def test_mask_credential_matches_jax(name, value):
    mine = ts.mod(PORT, "conf.property_key")
    theirs = ts.mod(JAX, "conf.property_key")
    assert mine.mask_credential(name, value) == \
        theirs.mask_credential(name, value)
    assert mine.is_credential_key(name) == theirs.is_credential_key(name)


# -- repair (a): the loader's prefetch depth ----------------------------------
@pytest.mark.parametrize("depth", [None, 4, 0])
def test_loaders_take_the_prefetch_depth_from_conf(tmp_path, depth):
    """Both packages' loaders over a file system whose conf sets
    ``atpu.tpu.prefetch.buffer.batches`` (or leaves it at its default)
    keep the same transfer prefetch depth; an explicit ``prefetch``
    still wins."""
    import jax

    got = {}
    for pkg in ts.PACKAGES:
        overrides = {} if depth is None else {
            "atpu.tpu.prefetch.buffer.batches": depth}
        lc = ts.mod(pkg, "minicluster.local_cluster")
        with lc.LocalCluster(str(tmp_path / pkg), num_workers=1,
                             conf_overrides=overrides) as c:
            fs = c.file_system()
            try:
                fs.write_all("/p/x", np.arange(1 << 12, dtype=np.uint8))
                if pkg == JAX:
                    io_mod = ts.mod(pkg, "client.jax_io")
                    device = jax.devices("cpu")[0]
                else:
                    io_mod = ts.mod(pkg, "client.torch_io")
                    device = "cpu"
                loaders = [io_mod.DeviceBlockLoader(fs, ["/p/x"],
                                                    device=device),
                           io_mod.DeviceBlockLoader(fs, ["/p/x"],
                                                    device=device,
                                                    prefetch=1)]
                got[pkg] = [ld._prefetch for ld in loaders]
                for ld in loaders:
                    ld.close()
            finally:
                fs.close()
    assert got[PORT] == got[JAX] == [2 if depth is None else depth, 1]


# -- repair (b): a launched master persists asynchronously --------------------
#: a block worker's locality host must be the job worker's host name for
#: the plans to pair them (both packages name a job worker by it)
HOST_IDENTITY = {"atpu.locality.identity": f"host={socket.gethostname()}"}


#: how long JAX's launched master is watched not persisting a file
UNPERSISTED_S = 5.0


def _wait(predicate, what: str, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.2)


@contextlib.contextmanager
def _with_job_service(pkg, cluster, jport):
    """The cluster, and a job master and a job worker, each a process of
    its own with the cluster's environment, all booting together (the
    job roles retry their master until it serves); the cluster stops
    first, so its master's checkers never call a stopped job master."""
    mp = ts.mod(pkg, "minicluster.multi_process")
    env = {**cluster._common_env(),
           "ATPU_MASTER_RPC_ADDRESSES": cluster.master_addresses,
           "ATPU_JOB_MASTER_HOSTNAME": "localhost",
           "ATPU_JOB_MASTER_RPC_PORT": str(jport),
           "ATPU_JOB_WORKER_HEARTBEAT_INTERVAL": "100ms"}
    logs = os.path.join(cluster.base, "logs")
    roles = [mp.ManagedProcess(role, env, os.path.join(logs, role))
             for role in ("job-master", "job-worker")]
    try:
        for role in roles:
            role.start()
        cluster.start()
        jc = ts.mod(pkg, "rpc.job_service").JobMasterClient(
            f"localhost:{jport}", retry_duration_s=1.0)

        def registered():
            try:
                return bool(jc.list_workers())
            except Exception:  # noqa: BLE001 - not serving yet
                return False

        _wait(registered, "no job worker", BOOT_S)
        yield jc
    finally:
        try:
            cluster.stop()
        finally:
            for role in reversed(roles):
                role.stop()


def _client(pkg, cluster, base):
    conf = ts.mod(pkg, "conf").Configuration(load_env=False)
    conf.set("atpu.master.fastpath.dir", str(base))
    return ts.mod(pkg, "client.file_system").FileSystem(
        cluster.master_addresses, conf=conf)


def _state(fs, path: str) -> str:
    return fs.get_status(path).persistence_state


@pytest.mark.parametrize("pkg", ts.PACKAGES)
def test_launched_master_persists_async_through_writes(pkg, tmp_path):
    """A master role with a job master at the conf's port, then an
    ASYNC_THROUGH write: the port's master attaches its persistence
    scheduler to that job master and the file reaches PERSISTED; JAX's
    launched master never attaches one, and the file is still
    unpersisted after ``UNPERSISTED_S`` (the port persists it within
    about a second here)."""
    mp = ts.mod(pkg, "minicluster.multi_process")
    jport = mp.free_port()
    os.makedirs(tmp_path / "underFSStorage", exist_ok=True)
    cluster = mp.MultiProcessCluster(
        str(tmp_path), num_workers=1,
        extra_conf={**HOST_IDENTITY, "atpu.job.master.rpc.port": jport})
    with _with_job_service(pkg, cluster, jport):
        fs = _client(pkg, cluster, tmp_path)
        try:
            fs.write_all("/async/f", b"p" * 5000, write_type="ASYNC_THROUGH")
            if pkg == PORT:
                _wait(lambda: _state(fs, "/async/f") == "PERSISTED",
                      "the launched master never persisted", 30)
                ufs = tmp_path / "underFSStorage" / "async" / "f"
                assert ufs.read_bytes() == b"p" * 5000
            else:
                time.sleep(UNPERSISTED_S)
                assert _state(fs, "/async/f") != "PERSISTED"
                assert not (tmp_path / "underFSStorage" / "async"
                            / "f").exists()
        finally:
            fs.close()


def test_new_primary_persists_after_a_failover(tmp_path):
    """A three-master (EMBEDDED) process cluster with its job service:
    the primary is SIGKILLed, and an ASYNC_THROUGH file written after the
    kill reaches PERSISTED through the new primary's scheduler."""
    mp = ts.mod(PORT, "minicluster.multi_process")
    jport = mp.free_port()
    cluster = mp.MultiProcessCluster(
        str(tmp_path), num_masters=3, journal_type="EMBEDDED",
        num_workers=1, extra_conf={**HOST_IDENTITY,
                                   "atpu.job.master.rpc.port": jport})
    with _with_job_service(PORT, cluster, jport):
        fs = _client(PORT, cluster, tmp_path)
        try:
            fs.write_all("/ha/before", b"b" * 3000,
                         write_type="ASYNC_THROUGH")
            _wait(lambda: _state(fs, "/ha/before") == "PERSISTED",
                  "the first primary never persisted", 30)
            first = cluster.primary_index(BOOT_S)
            cluster.masters[first].kill()
            _wait(lambda: cluster.primary_index(BOOT_S) != first,
                  "no new primary", BOOT_S)
            fs.write_all("/ha/after", b"a" * 3000,
                         write_type="ASYNC_THROUGH")
            _wait(lambda: _state(fs, "/ha/after") == "PERSISTED",
                  "the new primary never persisted", 45)
            ufs = tmp_path / "underFSStorage" / "ha" / "after"
            assert ufs.read_bytes() == b"a" * 3000
        finally:
            fs.close()


def test_master_without_a_job_master_serves_and_waits(tmp_path, caplog):
    """A launched master whose job master does not answer serves at
    once, logs that the checkers wait for one, and stops without
    waiting out an RPC deadline."""
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.master.process import MasterProcess
    from alluxio_tpu_torch.minicluster.multi_process import free_port

    conf = Configuration(load_env=False)
    conf.set(Keys.HOME, str(tmp_path))
    conf.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    conf.set(Keys.MASTER_RPC_PORT, 0)
    conf.set(Keys.MASTER_FASTPATH_ENABLED, False)
    conf.set(Keys.JOB_MASTER_RPC_PORT, free_port())
    master = MasterProcess(conf, root_ufs_uri=str(tmp_path / "ufs"),
                           attach_job_service=True)
    with caplog.at_level(logging.INFO,
                         logger="alluxio_tpu_torch.master.process"):
        t0 = time.monotonic()
        assert master.start() > 0
        try:
            _wait(lambda: "wait for a job master" in caplog.text,
                  "no wait logged", 10)
            assert master._job_threads == []
        finally:
            master.stop()
    assert time.monotonic() - t0 < 10.0
    assert master._job_attach is None
