"""One seeded operator script run through either package's shells
against that package's ``LocalCluster``: the parity tests of the port's
shells (``tests/test_torch_shell_{fs,admin}.py``) run the same script on
both packages and compare what each printed.

A script is a list of steps. A shell step is ``(shell, argv)`` with
``shell`` one of ``fs``, ``fsadmin``, ``job`` and ``table``, or ``(shell,
argv, "cross")`` for a step that the OTHER package's shell also runs
against this package's cluster (recorded under ``"cross " + id``: the
RPC planes interoperate, so it must print the same); a set-up step
is ``("py", name)``, where ``name`` picks a function of the caller's
``setups`` that gets the package name, the cluster and its
``FileSystem``; what it returns, when not None, is recorded like a
shell step's output. Steps are keyed by their place in the script and
their words (``step_id``); ``BASE`` in an argument stands for the
cluster's directory. Both packages run the script one after the other in the
same directory, so that paths print alike, and each on a metrics
registry of its own (``fresh_metrics``), so that what other tests of the
same process recorded does not print. ``mask`` then hides what is
not the package's to decide: times (dates, epoch milliseconds, the
time stamp in a backup's name, how long an alert has fired), the cluster id, the ports the kernel handed out,
uptimes and the host's name.
"""

import contextlib
import importlib
import io
import os
import re
import shutil
import socket
import time

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
SHELLS = {"fs": ("fs_shell", "FS_SHELL"),
          "fsadmin": ("fsadmin_shell", "ADMIN_SHELL"),
          "job": ("job_shell", "JOB_SHELL"),
          "table": ("table_shell", "TABLE_SHELL")}
#: the seed of both packages' id generators (worker ids are random)
ID_SEED = 7
#: stands for the cluster's directory in a step's arguments
BASE = "@BASE@"

_UUID = re.compile(
    r"\b[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}\b")
_DATE = re.compile(r"\b\d\d-\d\d(-\d{4})? \d\d:\d\d:\d\d\b")
_EPOCH_MS = re.compile(r"\b1[6-9]\d{11}\b")
_STAMP = re.compile(r"\b20\d{6}-\d{6}\b")
_UPTIME = re.compile(r"(Uptime: )\S+")
_FIRING = re.compile(r"(\(firing )\d+s\)")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def shell_conf(pkg: str, cluster):
    """A configuration of package ``pkg`` that points at ``cluster`` (of
    either package): the cluster's own keys, its master and its job
    master."""
    Configuration = mod(pkg, "conf").Configuration
    conf = Configuration(load_env=False)
    for key, value in cluster.conf.to_map().items():
        conf.set(key, value)
    conf.set("atpu.master.hostname", "localhost")
    conf.set("atpu.master.rpc.port", cluster.master.rpc_port)
    if cluster.job_master is not None:
        conf.set("atpu.job.master.hostname", "localhost")
        conf.set("atpu.job.master.rpc.port", cluster.job_master.rpc_port)
    return conf


def run_shell(pkg: str, cluster, shell: str, argv, conf=None):
    """``shell`` of package ``pkg`` run in process on ``argv`` against
    ``cluster`` with captured streams: (exit code, stdout, stderr)."""
    conf = conf if conf is not None else shell_conf(pkg, cluster)
    out, err = io.StringIO(), io.StringIO()
    ctx = mod(pkg, "shell.command").ShellContext(conf, out=out, err=err)
    module, name = SHELLS[shell]
    code = getattr(mod(pkg, f"shell.{module}"), name).run(list(argv), ctx)
    return code, out.getvalue(), err.getvalue()


def cluster_ports(cluster) -> list:
    ports = [cluster.master.rpc_port]
    ports += [w.port for w in cluster.workers]
    if cluster.job_master is not None:
        ports.append(cluster.job_master.rpc_port)
    if getattr(cluster.master, "web_port", None):
        ports.append(cluster.master.web_port)
    return ports


def mask(text: str, ports) -> str:
    text = _UUID.sub("<ID>", text)
    text = _DATE.sub("<DATE>", text)
    text = _EPOCH_MS.sub("<MS>", text)
    text = _STAMP.sub("<STAMP>", text)
    text = _UPTIME.sub(r"\1<UPTIME>", text)
    text = _FIRING.sub(r"\1<S>s)", text)
    for port in sorted({int(p) for p in ports}, key=lambda p: -len(str(p))):
        text = re.sub(rf"\b{port}\b", "<PORT>", text)
    return text.replace(socket.gethostname(), "<HOST>")


@contextlib.contextmanager
def fresh_metrics(pkg: str):
    """Package ``pkg``'s process registry swapped for an empty one, and
    the old one put back after."""
    reg = mod(pkg, "metrics.registry")
    with reg._default_lock:
        old, reg._default = reg._default, reg.MetricsRegistry("Process")
    try:
        yield
    finally:
        with reg._default_lock:
            reg._default = old


def step_id(index: int, step) -> str:
    words = [step[0], *step[1]] if step[0] != "py" else list(step)
    return f"{index:02d} " + " ".join(words)


def run_script(pkg: str, base: str, script, setups, *,
               cluster_kwargs=None) -> dict:
    """Boot package ``pkg``'s LocalCluster in ``base`` (emptied first),
    run ``script`` and stop the cluster. Returns ``{step id: (code,
    masked stdout, masked stderr)}``."""
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    mod(pkg, "utils.ids")._rng.seed(ID_SEED)
    kwargs = dict(num_workers=1, start_job_service=True,
                  start_worker_heartbeats=True)
    kwargs.update(cluster_kwargs or {})
    other = PACKAGES[1 - PACKAGES.index(pkg)]
    results = {}
    with fresh_metrics(pkg):
        cluster = mod(pkg, "minicluster.local_cluster").LocalCluster(
            base, **kwargs)
        cluster.start()
        _run(pkg, cluster, base, script, setups, other, results)
    return results


def settle_used_bytes(cluster, timeout_s: float = 60.0) -> None:
    """Wait until the master's used bytes equal the workers' own and no
    block removal waits for a heartbeat, on two polls in a row: the used
    bytes the master reports move with the worker heartbeats (a block
    freed after an unmount, one cached by a read), so a step that prints
    them reads them once both sides have caught up."""
    bm = cluster.master.block_master
    deadline = time.monotonic() + timeout_s
    settled = 0
    while settled < 2:
        with bm._lock:
            master = sum(bm.used_bytes_on_tiers().values())
            pending = any(w.to_remove_blocks for w in bm._workers.values())
        own = sum(sum(h.worker.store.store_meta()[1].values())
                  for h in cluster.workers)
        settled = settled + 1 if master == own and not pending else 0
        assert time.monotonic() < deadline, \
            f"used bytes never settled: master {master}, workers {own}"
        time.sleep(0.1)


def _run(pkg, cluster, base, script, setups, other, results) -> None:
    try:
        fs = cluster.file_system()
        try:
            for index, step in enumerate(script):
                sid = step_id(index, step)
                if step[0] == "py":
                    got = setups[step[1]](pkg, cluster, fs)
                    if got is not None:
                        results[sid] = got
                    continue
                if "settle" in step[2:]:
                    settle_used_bytes(cluster)
                ports = cluster_ports(cluster)
                argv = [a.replace(BASE, base) for a in step[1]]
                code, out, err = run_shell(pkg, cluster, step[0], argv)
                results[sid] = (code, mask(out, ports), mask(err, ports))
                if "cross" in step[2:]:
                    code, out, err = run_shell(
                        other, cluster, step[0], argv,
                        conf=shell_conf(other, cluster))
                    results["cross " + sid] = (code, mask(out, ports),
                                               mask(err, ports))
        finally:
            fs.close()
    finally:
        cluster.stop()
