"""The port's fault injector against the JAX package's, on the CPU.

- The same conf and the same calls give the same decision sequence from
  every ``take_*`` hook and the four HA hooks, the same injected tallies
  and the same ``FaultPlan`` log in both packages.
- Every hook the port wires takes its worker or client to the next rung,
  as the JAX hook takes the JAX one: failed UFS stripes retry, then fall
  back to one whole-block read; an injected read latency lands on every
  warm chunk; a shed RPC is retried after its hint; a denied SHM lease
  or a failed SHM map falls to the lease rung; a poisoned native plan
  falls to the Python path with the same bytes; a frozen metrics
  heartbeat ships nothing. The ladder cases run both
  packages' ``BlockStoreClient`` against the port's worker in a JAX
  ``LocalCluster`` that also holds a JAX worker.
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.utils import faults as jax_faults  # noqa: E402
from alluxio_tpu_torch.utils import faults  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

KB = 1024
BLOCK = 64 * KB
MODULES = {"jax": jax_faults, "port": faults}


@pytest.fixture(autouse=True)
def _reset_injectors():
    yield
    faults.injector().reset()
    jax_faults.injector().reset()


# -- decisions ----------------------------------------------------------------
def _decisions(mod, rates, keys):
    inj = mod.FaultInjector()
    inj.set(**rates)
    out = {
        "ufs": [inj.take_ufs_error(k) for k in keys],
        "rpc": [inj.take_rpc_reject(k) for k in keys],
        "shm_map": [inj.take_shm_map_error(k) for k in keys],
        "shm_deny": [inj.take_shm_lease_deny(k) for k in keys],
        "native": [inj.take_native_exec_error(k) for k in keys],
        "freeze": [inj.heartbeat_frozen(k) for k in keys],
    }
    tallies = dict(inj.injected)
    inj.reset()
    return out, tallies, dict(inj.injected)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_take_hooks_decide_like_jax(seed):
    """Seeded rates, a seeded scope and seeded keys (half of them in
    scope): every hook answers the same sequence in both packages, and
    ``reset`` clears the tallies alike."""
    rng = np.random.default_rng(seed)
    r = [round(float(x), 3) for x in rng.uniform(0.0, 1.0, 5)]
    rates = dict(ufs_error_rate=r[0], rpc_reject_rate=r[1],
                 shm_map_error_rate=r[2], shm_lease_deny_rate=r[3],
                 native_exec_error_rate=r[4], heartbeat_freeze=bool(seed % 2),
                 scope="w1")
    keys = [("w1-host" if b else "w2-host") for b in rng.integers(0, 2, 64)]
    got = {n: _decisions(m, rates, keys) for n, m in MODULES.items()}
    decided, tallies, cleared = got["port"]
    jax_decided, jax_tallies, _ = got["jax"]
    assert decided == jax_decided
    assert tallies == jax_tallies
    assert any(decided["ufs"]) and not any(
        d for d, k in zip(decided["ufs"], keys) if k == "w2-host")
    assert all(v == 0 for v in cleared.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_ha_hooks_decide_like_jax(seed):
    """The four HA hooks (tailer and election freeze, the partition's
    ``link_blocked``, the fsync countdown) answer the same sequence and
    count the same tallies in both packages."""
    rng = np.random.default_rng(seed)
    nodes = [f"127.0.0.1:{p}" for p in rng.integers(5000, 5004, 32)]
    got = {}
    for name, mod in MODULES.items():
        inj = mod.FaultInjector()
        inj.set(tailer_freeze_scope="5001", election_freeze_scope="5002",
                partitioned=["127.0.0.1:5003"], fsync_errors=3)
        got[name] = (
            [inj.tailer_frozen(n) for n in nodes],
            [inj.election_frozen(n) for n in nodes],
            [inj.link_blocked(a, b) for a, b in zip(nodes, nodes[1:])],
            [inj.take_fsync_error() for _ in range(5)],
            dict(inj.injected), mod.armed())
        inj.reset()
    assert got["port"] == got["jax"]
    assert got["port"][3] == [True, True, True, False, False]


def test_rate_paces_failures_deterministically():
    for mod in MODULES.values():
        inj = mod.FaultInjector()
        inj.set(ufs_error_rate=0.25)
        assert [i for i in range(12) if inj.take_ufs_error("h")] == [0, 4, 8]
        inj.reset()


def test_configure_from_conf_matches_jax():
    from alluxio_tpu.conf import Configuration as JaxConfiguration
    from alluxio_tpu_torch.conf import Configuration

    values = {"atpu.debug.fault.read.latency": "25ms",
              "atpu.debug.fault.worker.heartbeat.freeze": "true",
              "atpu.debug.fault.ufs.error.rate": "0.5",
              "atpu.debug.fault.rpc.reject.rate": "1.5",
              "atpu.debug.fault.shm.map.error.rate": "0.25",
              "atpu.debug.fault.shm.lease.deny.rate": "0.75",
              "atpu.debug.fault.native.exec.error.rate": "-1",
              "atpu.debug.fault.scope": "host-a"}
    got = {}
    for name, conf in (("jax", JaxConfiguration(values, load_env=False)),
                       ("port", Configuration(values, load_env=False))):
        inj = MODULES[name].FaultInjector()
        inj.configure(conf)
        got[name] = (inj.read_latency_s, inj.heartbeat_freeze,
                     inj.ufs_error_rate, inj.rpc_reject_rate,
                     inj.shm_map_error_rate, inj.shm_lease_deny_rate,
                     inj.native_exec_error_rate, inj.scope,
                     MODULES[name].armed())
        inj.reset()
    assert got["port"] == got["jax"]
    assert got["port"][3] == 1.0 and got["port"][6] == 0.0


def _plan(mod, fail):
    now = [0.0]
    calls = []

    def boom():
        raise RuntimeError("step failed")

    steps = [mod.FaultStep(0.5, "freeze", node="b"),
             mod.FaultStep(0.1, "kill", node="a"),
             mod.FaultStep(1.5, "kill", node="c")]
    if fail:
        steps.append(mod.FaultStep(0.9, "boom"))
    actions = {"kill": lambda node: calls.append(("kill", node)) or node,
               "freeze": lambda node: calls.append(("freeze", node)),
               "boom": boom}
    kw = dict(sleep=lambda s: now.__setitem__(0, now[0] + s),
              clock=lambda: now[0])
    plan = mod.FaultPlan(steps)
    if not fail:
        return plan.run(actions, **kw), calls
    with pytest.raises(RuntimeError, match="step failed"):
        plan.run(actions, continue_on_error=True, **kw)
    with pytest.raises(KeyError):
        mod.FaultPlan([mod.FaultStep(0, "nope")]).run(actions, **kw)
    return calls


def test_fault_plan_runs_like_jax():
    """The same schedule on a fake clock gives the same execution log in
    both packages; a failing step is surfaced after the rest ran, and an
    unknown action is refused before any step runs."""
    got = {n: _plan(m, False) for n, m in MODULES.items()}
    assert got["port"] == got["jax"]
    log, calls = got["port"]
    assert [(e["action"], e["ok"], e["ran_at_s"]) for e in log] == [
        ("kill", True, 0.1), ("freeze", True, 0.5), ("kill", True, 1.5)]
    failed = {n: _plan(m, True) for n, m in MODULES.items()}
    assert failed["port"] == failed["jax"] == [
        ("kill", "a"), ("freeze", "b"), ("kill", "c")]


# -- the worker's hooks, in process --------------------------------------------
def _fetch_with_ufs_faults(name, tmp_path, rate):
    if name == "jax":
        from alluxio_tpu.conf import Configuration, Keys
        from alluxio_tpu.metrics import metrics
        from alluxio_tpu.underfs.local import LocalUnderFileSystem
        from alluxio_tpu.worker.process import build_store_from_conf
        from alluxio_tpu.worker.ufs_fetch import FetchConf, UfsBlockFetcher
        from alluxio_tpu.worker.ufs_io import UfsBlockDescriptor
    else:
        from alluxio_tpu_torch.conf import Configuration, Keys
        from alluxio_tpu_torch.metrics import metrics
        from alluxio_tpu_torch.underfs.local import LocalUnderFileSystem
        from alluxio_tpu_torch.worker.process import build_store_from_conf
        from alluxio_tpu_torch.worker.ufs_fetch import (FetchConf,
                                                        UfsBlockFetcher)
        from alluxio_tpu_torch.worker.ufs_io import UfsBlockDescriptor
    root = tmp_path / f"{name}-{rate}"
    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_DATA_FOLDER, str(root / "worker"))
    conf.set(Keys.WORKER_SHM_DIR, str(root / "shm"))
    root.mkdir()
    payload = np.random.default_rng(31).integers(
        0, 256, 8 * KB, dtype=np.uint8).tobytes()
    (root / "f").write_bytes(payload)
    m = metrics()
    names = ("Worker.UfsFetchStripeRetries", "Worker.UfsFetchFallbacks",
             "Worker.UfsFetchFailures")
    before = [m.counter(n).count for n in names]
    MODULES[name].injector().set(ufs_error_rate=rate)
    fetcher = UfsBlockFetcher(build_store_from_conf(conf), FetchConf(
        stripe_size=KB, concurrency=1, per_mount_limit=2), host="w")
    try:
        fetch = fetcher.fetch(LocalUnderFileSystem(str(root)),
                              UfsBlockDescriptor(block_id=5,
                                                 ufs_path=str(root / "f"),
                                                 offset=0, length=8 * KB),
                              cache=True)
        assert fetch.result() == payload
        assert fetch.wait_done(10)
        return (fetch.fallback,
                [m.counter(n).count - b for n, b in zip(names, before)],
                MODULES[name].injector().injected["ufs_error"])
    finally:
        fetcher.close()
        MODULES[name].injector().reset()


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_ufs_error_hook_retries_then_falls_back(tmp_path, rate):
    """Rate 0.5 fails every stripe's first try, which its retry absorbs;
    rate 1.0 fails both tries of the first stripe, and the fetch falls
    back to one whole-block read, which serves the bytes."""
    got = {n: _fetch_with_ufs_faults(n, tmp_path, rate) for n in MODULES}
    assert got["port"] == got["jax"]
    fallback, (retries, fallbacks, failures), injected = got["port"]
    if rate == 0.5:
        assert (fallback, retries, fallbacks, injected) == (False, 8, 0, 8)
    else:
        assert fallback and fallbacks == 1 and injected == 2
    assert failures == 0


def test_heartbeat_freeze_hook_skips_the_metrics_heartbeat():
    from alluxio_tpu.worker.process import _MetricsReporter as JaxReporter
    from alluxio_tpu_torch.worker.process import _MetricsReporter

    got = {}
    for name, cls in (("jax", JaxReporter), ("port", _MetricsReporter)):
        sent = []
        client = SimpleNamespace(metrics_heartbeat=lambda src, snap, **kw:
                                 sent.append((src, kw.get("profile"))))
        reporter = cls(client, "worker-w1:1")
        MODULES[name].injector().set(heartbeat_freeze=True, scope="w2")
        reporter.heartbeat()  # out of scope: ships
        MODULES[name].injector().set(scope="w1")
        reporter.heartbeat()  # frozen
        reporter.heartbeat()
        MODULES[name].injector().set(heartbeat_freeze=False)
        reporter.heartbeat()
        got[name] = (sent, MODULES[name].injector().injected[
            "heartbeat_freeze"])
        MODULES[name].injector().reset()
    assert got["port"] == got["jax"] == (
        [("worker-w1:1", None)] * 2, 2)


# -- the hooks on the wire: a JAX cluster with a JAX and a port worker ---------
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from alluxio_tpu.minicluster import LocalCluster

    from tests.testutils.torch_worker import PortWorker

    base = tmp_path_factory.mktemp("faults")
    with LocalCluster(str(base), num_workers=1, block_size=BLOCK) as c:
        pw = PortWorker(c, str(base))
        data = {}
        fs = c.file_system()
        for i in range(4):
            d = np.random.default_rng(70 + i).integers(
                0, 256, BLOCK, dtype=np.uint8).tobytes()
            fs.write_all(f"/f{i}", d, write_type="MUST_CACHE")
            data[f"/f{i}"] = d
        fs.close()
        try:
            yield c, pw, data
        finally:
            pw.stop()


def _place(c, pw, path, data, side="port"):
    """The file's block, held by ``side``'s worker alone (written there
    if the other one holds it); returns its FileBlockInfo located there."""
    from alluxio_tpu.rpc.clients import WorkerClient as JaxWorkerClient
    from alluxio_tpu_torch.rpc.clients import WorkerClient
    from alluxio_tpu_torch.utils import ids

    fbi = c.fs_client().get_file_block_info_list(path)[0]
    bid = fbi.block_info.block_id
    workers = {"jax": (c.workers[0].worker,
                       JaxWorkerClient(c.workers[0].address),
                       c.workers[0].port),
               "port": (pw.worker, WorkerClient(f"127.0.0.1:{pw.port}"),
                        pw.port)}
    other = "jax" if side == "port" else "port"
    worker, client, port = workers[side]
    if not worker.store.has_block(bid):
        client.write_block(bid, ids.create_session_id(), data[path])
    if workers[other][0].store.has_block(bid):
        workers[other][1].remove_block(bid)
    fbi.block_info.locations = [
        loc for loc in c.block_client().get_block_info(bid).locations
        if loc.address.rpc_port == port]
    assert fbi.block_info.locations
    return fbi


def _open(side, c, fbi, read=None):
    """Open the block through one package's BlockStoreClient; returns
    (rung, bytes read by ``read``)."""
    if side == "jax":
        from alluxio_tpu.client.block_store import BlockStoreClient
        from alluxio_tpu.client.remote_read import RemoteReadConf
        from alluxio_tpu.utils import wire
    else:
        from alluxio_tpu_torch.client.block_store import BlockStoreClient
        from alluxio_tpu_torch.client.remote_read import RemoteReadConf
        from alluxio_tpu_torch.utils import wire
    store = BlockStoreClient(c.block_client(), passive_cache=False,
                             remote_read=RemoteReadConf(stripe_size=0))
    try:
        stream = store.open_block(wire.FileBlockInfo.from_wire(
            fbi.to_wire()))
        name = type(stream).__name__
        rung = {"ShmBlockInStream": "shm",
                "LocalBlockInStream": "lease"}.get(name, "remote")
        got = (read or (lambda s: s.pread(0, BLOCK)))(stream)
        stream.close()
        return rung, got
    finally:
        store.close()


@pytest.mark.parametrize("fault", ["shm_lease_deny_rate",
                                   "shm_map_error_rate"])
def test_shm_faults_fall_to_the_lease_rung(cluster, fault):
    """With no fault both packages' clients map the port worker's SHM
    segment; a denied lease (the worker's hook) or a failed map (each
    client's hook) sends both to the lease rung, with the same bytes."""
    c, pw, data = cluster
    fbi = _place(c, pw, "/f0", data)
    assert {s: _open(s, c, fbi)[0] for s in ("jax", "port")} == \
        {"jax": "shm", "port": "shm"}
    for mod in MODULES.values():
        mod.injector().set(**{fault: 1.0})
    got = {s: _open(s, c, fbi) for s in ("jax", "port")}
    assert got["port"] == got["jax"] == ("lease", data["/f0"])
    key = {"shm_lease_deny_rate": "shm_lease_deny",
           "shm_map_error_rate": "shm_map_error"}[fault]
    # the port's hook fired for both clients (lease deny) or for its own
    assert faults.injector().injected[key] == \
        (2 if fault == "shm_lease_deny_rate" else 1)
    assert pw.worker.shm_store.stats()["live_leases"] == 0
    for mod in MODULES.values():
        mod.injector().reset()
    assert _open("port", c, fbi)[0] == "shm"


def test_native_poison_falls_to_the_python_path(cluster):
    """A poisoned plan on the SHM rung's ``pread_many``: the native call
    rejects mid-table, the Python path serves the same bytes, and the
    fallback is counted, as in the JAX client."""
    from alluxio_tpu.metrics import metrics as jax_metrics
    from alluxio_tpu_torch import native
    from alluxio_tpu_torch.metrics import metrics

    if not native.loaded():
        pytest.skip("the native library did not build here")
    c, pw, data = cluster
    fbi = _place(c, pw, "/f1", data)
    rng = np.random.default_rng(5)
    offsets = [int(o) for o in rng.integers(0, BLOCK - 512, 16)]
    sizes = [int(s) for s in rng.integers(1, 512, 16)]
    want = [data["/f1"][o:o + s] for o, s in zip(offsets, sizes)]

    def read(stream):
        return stream.pread_many(offsets, sizes)

    counters = {"jax": jax_metrics().counter("Client.NativeFallbacks"),
                "port": metrics().counter("Client.NativeFallbacks")}
    for mod in MODULES.values():
        mod.injector().set(native_exec_error_rate=1.0)
    got = {}
    for side in ("jax", "port"):
        before = counters[side].count
        rung, out = _open(side, c, fbi, read)
        got[side] = (rung, out, counters[side].count - before,
                     MODULES[side].injector().injected["native_exec_error"])
    assert got["port"] == got["jax"] == ("shm", want, 1, 1)


def test_read_latency_and_rpc_reject_hooks_on_the_wire(cluster):
    """A warm ``read_block`` sleeps the injected latency on each chunk,
    and a ``read_many`` shed at rate 0.5 succeeds on its retry, on the
    port's worker as on the JAX worker."""
    from alluxio_tpu.rpc.clients import WorkerClient as JaxWorkerClient
    from alluxio_tpu_torch.rpc.clients import WorkerClient

    c, pw, data = cluster
    bid = _place(c, pw, "/f2", data).block_info.block_id
    jbid = _place(c, pw, "/f3", data, "jax").block_info.block_id
    sides = {"jax": (JaxWorkerClient(c.workers[0].address), jbid, "/f3"),
             "port": (WorkerClient(f"127.0.0.1:{pw.port}"), bid, "/f2")}
    got = {}
    for side, (client, block, path) in sides.items():
        inj = MODULES[side].injector()
        inj.set(read_latency_s=0.01)
        chunks = list(client.read_block(block, chunk_size=16 * KB))
        latency = inj.injected["read_latency"]
        inj.reset()
        inj.set(rpc_reject_rate=0.5, scope="read_many")
        batch = client.read_many(block, [0, 100], [10, 20])
        got[side] = (len(chunks), b"".join(x["data"] for x in chunks)
                     == data[path], batch["lengths"],
                     batch["data"] == data[path][0:10] + data[path][100:120],
                     latency, inj.injected["rpc_reject"])
        inj.reset()
    assert got["port"] == got["jax"]
    # the first read_many is shed and its retry served
    assert got["port"] == (4, True, [10, 20], True, 4, 1)
