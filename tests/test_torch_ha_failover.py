"""The port's HA control plane against the JAX package's, on the CPU (the
scenarios of ``tests/test_ha_failover.py``, each on both packages).

- Standby serving: a tailing standby answers reads stamped with its
  md_version and redirects writes with the leader's address; its
  md_version equals the primary's after the same operations (the same
  number in both packages); a client redirects writes and, with standby
  reads on, routes reads to the standby (``Client.StandbyReads``).
- The quorum view: ``get_masters`` on the primary and on the standby;
  ``quorum_degraded_rule`` gives the same verdicts in both packages.
- An ``HaCluster`` of three masters on EMBEDDED journals in each package,
  given the same operations through a leader kill, a snapshot install to
  a restarted member, a leadership transfer and a partition of a member
  (``link_blocked``), ends with the same inode tree on every member and
  in both packages (a partitioned leader's fenced writes are
  ``tests/test_torch_raft.py``'s).
- The fast-path fence: with the demote held and the leader stepped down,
  a same-host read over the JAX master's fast path is still answered
  (unmarked, from state that may lag); the port's master refuses it with
  the leader's address, on both transports (ROADMAP section 3, open in
  the reference, fixed in the port).
- A scheduled chaos plan (``FaultPlan`` over ``HaCluster.chaos_actions``)
  under live load keeps every acknowledged write and every standby read
  within its advertised md_version, on the port.
- The trace fan-out's endpoints and merge are alike; a unary call the
  server cancels is retryable in the port (a plain error in JAX).
"""

import shutil
import tempfile
import threading
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_ha import (  # noqa: E402
    PACKAGES, mod, tree_view, wait_for,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    for pkg in PACKAGES:
        mod(pkg, "utils.faults").injector().reset()


def make_conf(pkg, tmp_path, **overrides):
    conf = mod(pkg, "conf")
    Keys = conf.Keys
    c = conf.Configuration(load_env=False)
    c.set(Keys.HOME, str(tmp_path))
    c.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    c.set(Keys.MASTER_RPC_PORT, 0)
    c.set(Keys.MASTER_SAFEMODE_WAIT, "0s")
    c.set(Keys.MASTER_STANDBY_TAIL_INTERVAL, "50ms")
    c.set(Keys.MASTER_HA_PUBLISH_INTERVAL, "100ms")
    c.set(Keys.MASTER_FASTPATH_ENABLED, False)
    for k, v in overrides.items():
        c.set(k, v)
    return c


def start_primary_standby(pkg, tmp_path):
    """A serving primary and a tailing standby over one shared journal
    (file-lock flavor; a selector gate keeps the second master standby
    while the first lives: in-process flock is per-pid)."""
    process = mod(pkg, "master.process")
    ha = mod(pkg, "journal.ha")
    m1 = process.FaultTolerantMasterProcess(make_conf(pkg, tmp_path))
    m1.start()
    assert m1.serving

    class _Gate(ha.FileLockPrimarySelector):
        def try_acquire(self_inner) -> bool:  # noqa: N805
            if m1.serving:
                return False
            return super(_Gate, self_inner).try_acquire()

    m2 = process.FaultTolerantMasterProcess(
        make_conf(pkg, tmp_path), selector=_Gate(str(tmp_path / "journal")))
    m2.start()
    assert not m2.serving and m2.standby_rpc_port
    return m1, m2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_standby_serves_stamped_reads_and_redirects_writes(tmp_path, pkg):
    clients = mod(pkg, "rpc.clients")
    m1, m2 = start_primary_standby(pkg, tmp_path)
    try:
        clients.FsMasterClient(m1.address).create_directory("/served")
        standby = f"localhost:{m2.standby_rpc_port}"
        sc = clients.FsMasterClient(standby, retry_duration_s=10.0,
                                    fastpath=False)
        wait_for(lambda: sc.exists("/served"), msg="standby tail")
        info, stamp = sc.get_status("/served", want_version=True)
        assert info.folder and stamp is not None and stamp >= 1
        infos, lstamp = sc.list_status("/", want_version=True)
        assert "/served" in ["/" + i.name for i in infos]
        assert lstamp is not None
        with pytest.raises(mod(pkg, "utils.exceptions").NotPrimaryError) \
                as ei:
            mod(pkg, "rpc.core").RpcChannel(standby).call(
                mod(pkg, "rpc.master_service").FS_SERVICE,
                "create_directory", {"path": "/nope"})
        assert ei.value.leader == m1.client_address
    finally:
        m2.stop(), m1.stop()


def _versions(pkg, tmp_path):
    c_mod = mod(pkg, "rpc.clients")
    m1, m2 = start_primary_standby(pkg, tmp_path / pkg)
    try:
        c = c_mod.FsMasterClient(m1.address)
        for i in range(7):
            c.create_directory(f"/v{i}")
        c.rename("/v0", "/v0r")
        c.delete("/v1")
        want = m1.fs_master.invalidations.version
        wait_for(lambda: m2.fs_master.invalidations.version == want,
                 msg="standby invalidation version catch-up")
        return want
    finally:
        m2.stop(), m1.stop()


def test_standby_md_version_equals_the_primary_alike(tmp_path):
    got = [_versions(pkg, tmp_path) for pkg in PACKAGES]
    assert got[0] == got[1] > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_client_redirects_writes_and_routes_reads(tmp_path, pkg):
    reg = mod(pkg, "metrics").metrics()
    m1, m2 = start_primary_standby(pkg, tmp_path)
    try:
        standby = f"localhost:{m2.standby_rpc_port}"
        redirects = reg.counter("Client.FailoverRedirects")
        standby_reads = reg.counter("Client.StandbyReads")
        r0, s0 = redirects.count, standby_reads.count
        # standby first: the write must follow the leader hint
        c = mod(pkg, "rpc.clients").FsMasterClient(
            f"{standby},{m1.address}", retry_duration_s=15.0,
            fastpath=False, standby_reads=True)
        c.create_directory("/via-redirect")
        assert redirects.count > r0
        wait_for(lambda: m2.fs_master.exists("/via-redirect"),
                 msg="standby tail")
        for _ in range(4):
            assert c.exists("/via-redirect")
        assert standby_reads.count > s0
    finally:
        m2.stop(), m1.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_get_masters_on_the_primary_and_the_standby(tmp_path, pkg):
    ha = mod(pkg, "journal.ha")
    clients = mod(pkg, "rpc.clients")
    m1, m2 = start_primary_standby(pkg, tmp_path)
    try:
        wait_for(lambda: len(ha.MasterRegistry(
            str(tmp_path / "journal")).list()) == 2, msg="registry rows")
        rep = clients.MetaMasterClient(m1.address).get_masters()
        roles = {r["address"]: r["role"] for r in rep["masters"]}
        assert roles[m1.client_address] == "PRIMARY"
        assert roles[m2.client_address] == "STANDBY"
        assert rep["leader"] == m1.client_address
        rep2 = clients.MetaMasterClient(
            f"localhost:{m2.standby_rpc_port}",
            fastpath=False).get_masters()
        assert {r["address"] for r in rep2["masters"]} == set(roles)
    finally:
        m2.stop(), m1.stop()


@pytest.mark.parametrize("live", (3.0, 2.0, 2.8, 1.0, None))
def test_quorum_degraded_rule_gives_the_same_verdict(live):
    class _Ctx:
        def __init__(self):
            self._v = {"Master.HaQuorumLive": live,
                       "Master.HaQuorumExpected": 3.0}

        def window_mean(self, name, source, window_s):
            return self._v.get(name)

    verdicts = []
    for pkg in PACKAGES:
        rule = mod(pkg, "master.health").quorum_degraded_rule(3)
        assert rule.needs_history and rule.name == "master-quorum-degraded"
        verdicts.append([(v.subject, v.value, v.summary, v.evidence)
                         for v in rule.probe(_Ctx())])
    assert verdicts[0] == verdicts[1]
    assert bool(verdicts[0]) == (live is not None and live < 2.5)


def _tree_script(pkg, base):
    """The same operations through a leader kill, a snapshot install to
    the restarted member, a leadership transfer and a partition of a
    member; returns every member's tree."""
    ha_cluster = mod(pkg, "minicluster.ha_cluster")
    faults = mod(pkg, "utils.faults")
    Keys = mod(pkg, "conf").Keys
    cluster = ha_cluster.HaCluster(
        str(base), num_masters=3,
        conf_overrides={
            Keys.MASTER_EMBEDDED_JOURNAL_SNAPSHOT_PERIOD_ENTRIES: 10})
    try:
        cluster.start()
        fs = cluster.fs_client(retry_duration_s=60.0, fastpath=False)
        for i in range(6):
            fs.create_directory(f"/t/a{i}", recursive=True)
        dead = cluster.primary_index()
        cluster.kill_primary()
        for i in range(20):  # past the snapshot period: a snapshot
            fs.create_directory(f"/t/b{i}")
        fs.rename("/t/a0", "/t/a0r")
        fs.delete("/t/a1")
        primary = cluster.primary
        primary.journal.checkpoint()
        cluster.restart_master(dead)
        restarted = cluster.masters[dead]
        wait_for(lambda: restarted.journal.sequence
                 == cluster.primary.journal.sequence, timeout=30,
                 msg="snapshot install to the restarted member")
        # leadership to the restarted member
        target = cluster.raft_addresses[dead]
        assert cluster.primary.journal.transfer_leadership(target)
        wait_for(lambda: cluster.primary is restarted, timeout=30,
                 msg="transfer")
        fs.create_directory("/t/after-transfer")
        # partition a standby: the quorum of two keeps writing; healed,
        # the member catches up
        cut = cluster.standby_indices()[0]
        cluster.partition(cut)
        for i in range(5):
            fs.create_directory(f"/t/c{i}")
        assert faults.injector().injected["partition_drop"] > 0
        cluster.heal_partition()
        want = cluster.primary.journal.sequence
        wait_for(lambda: all(m.journal.sequence == want
                             for m in cluster.masters), timeout=30,
                 msg="members converge")
        trees = []
        for m in cluster.masters:
            port = m.rpc_port if m.serving else m.standby_rpc_port
            trees.append(tree_view(mod(pkg, "rpc.clients").FsMasterClient(
                f"localhost:{port}", fastpath=False), "/t"))
        return trees
    finally:
        cluster.stop()


def test_group_applies_the_same_tree_through_failover(tmp_path):
    got = {pkg: _tree_script(pkg, tmp_path / pkg) for pkg in PACKAGES}
    for pkg, trees in got.items():
        assert trees[0] == trees[1] == trees[2], pkg
    assert got[PACKAGES[0]] == got[PACKAGES[1]]
    paths = [t[0] for t in got[PACKAGES[1]][0]]
    assert "/t/a0r" in paths and "/t/a1" not in paths
    assert "/t/c4" in paths and "/t/b19" in paths
    assert "/t/after-transfer" in paths


def test_fast_path_fence_after_a_step_down(tmp_path):
    """The demote held (the test holds ``_promote_lock``) and the leader
    stepped down by a transfer: the JAX master still answers a fast-path
    ``get_status`` (the reference's gap); the port's refuses it, on the
    fast path and on gRPC alike."""
    short = tempfile.mkdtemp(prefix="atpu-fp-", dir="/tmp")
    seen = {}
    try:
        for pkg in PACKAGES:
            Keys = mod(pkg, "conf").Keys
            fastpath = mod(pkg, "rpc.fastpath")
            fs_service = mod(pkg, "rpc.master_service").FS_SERVICE
            not_primary = mod(pkg, "utils.exceptions").NotPrimaryError
            cluster = mod(pkg, "minicluster.ha_cluster").HaCluster(
                str(tmp_path / pkg), num_masters=3, conf_overrides={
                    Keys.MASTER_FASTPATH_ENABLED: True,
                    Keys.MASTER_FASTPATH_DIR: short})
            try:
                cluster.start()
                fs = cluster.fs_client(retry_duration_s=30.0,
                                       fastpath=False)
                fs.create_directory("/fenced-read")
                i = cluster.primary_index()
                p = cluster.masters[i]
                sock = fastpath.socket_path_for(p.address, short)
                channel = fastpath.FastPathChannel(
                    sock, metadata=mod(pkg, "rpc.core")
                    .default_client_metadata())
                assert channel.call(fs_service, "get_status",
                                    {"path": "/fenced-read"})["folder"]
                with p._promote_lock:
                    target = cluster.raft_addresses[(i + 1) % 3]
                    assert p.journal.transfer_leadership(target)
                    wait_for(lambda: not p.journal.is_primary(),
                             msg="step-down")
                    out = {}
                    for name, call in (
                            ("fastpath", channel.call),
                            ("grpc", mod(pkg, "rpc.core").RpcChannel(
                                p.address).call)):
                        try:
                            resp = call(fs_service, "get_status",
                                        {"path": "/fenced-read"})
                            out[name] = ("answered",
                                         bool(resp.get("standby")))
                        except not_primary as e:
                            out[name] = ("refused", e.leader)
                    seen[pkg] = out
                channel.close_thread_connection()
            finally:
                cluster.stop()
    finally:
        shutil.rmtree(short, ignore_errors=True)
    jax, port = seen[PACKAGES[0]], seen[PACKAGES[1]]
    assert jax["fastpath"] == ("answered", False)   # the reference's gap
    assert jax["grpc"][0] == "refused"
    assert port["fastpath"][0] == port["grpc"][0] == "refused"


def test_scheduled_chaos_plan_keeps_the_invariants(tmp_path):
    """Under live writes and standby probes, a scheduled fault plan
    (kill the primary, freeze a standby's apply, restart the dead master,
    partition a member, heal) loses no acknowledged write, surfaces no
    error to the idempotent writer and serves no standby read staler than
    its md_version (the port's ``HaCluster``, ``FaultPlan`` and
    ``WriteLedger``)."""
    from alluxio_tpu_torch.minicluster.ha_cluster import (
        HaCluster, WriteLedger,
    )
    from alluxio_tpu_torch.rpc.clients import FsMasterClient
    from alluxio_tpu_torch.utils.faults import FaultPlan, FaultStep

    cluster = HaCluster(str(tmp_path), num_masters=3, num_workers=0)
    try:
        cluster.start()
        writer = cluster.fs_client(retry_duration_s=90.0, fastpath=False)
        reader = cluster.fs_client(retry_duration_s=90.0, fastpath=False)
        writer.create_directory("/chaos")
        ledger = WriteLedger()
        stop = threading.Event()
        errors, staleness, probes = [], [], []

        def write_loop():
            i = 0
            while not stop.is_set():
                path = f"/chaos/w{i:05d}"
                try:
                    writer.create_directory(path)
                    _, stamp = reader.get_status(path, want_version=True)
                    ledger.record(path, stamp)
                except Exception as e:  # noqa: BLE001 - the invariant
                    errors.append(e)
                    return
                i += 1
                time.sleep(0.02)

        clients = {}

        def probe_loop():
            while not stop.is_set():
                port = next((cluster.masters[i].standby_rpc_port
                             for i in cluster.standby_indices()
                             if cluster.masters[i] is not None
                             and cluster.masters[i].standby_rpc_port),
                            None)
                if port is None:
                    time.sleep(0.05)
                    continue
                sc = clients.setdefault(port, FsMasterClient(
                    f"localhost:{port}", retry_duration_s=1.0,
                    fastpath=False))
                try:
                    infos, stamp = sc.list_status("/chaos",
                                                  want_version=True)
                except Exception:  # noqa: BLE001 - standby mid-churn
                    time.sleep(0.05)
                    continue
                probes.append(stamp)
                staleness.extend(ledger.staleness_violations(
                    {"/chaos/" + x.name for x in infos}, stamp))
                time.sleep(0.05)

        wt = threading.Thread(target=write_loop, daemon=True)
        pt = threading.Thread(target=probe_loop, daemon=True)
        wt.start(), pt.start()
        plan = FaultPlan([
            FaultStep(0.5, "kill_primary"),
            FaultStep(2.5, "freeze_tailer", index=0),
            FaultStep(3.5, "unfreeze_tailer"),
            FaultStep(4.0, "restart_master", index=0),
            FaultStep(5.5, "partition", index=0),
            FaultStep(6.5, "heal_partition"),
        ])
        actions = dict(cluster.chaos_actions())
        actions["freeze_tailer"] = lambda index: \
            cluster.freeze_tailer(cluster.standby_indices()[0])
        actions["restart_master"] = lambda index: cluster.restart_master(
            next(i for i, m in enumerate(cluster.masters) if m is None))
        actions["partition"] = lambda index: \
            cluster.partition(cluster.standby_indices()[0])
        log = plan.run(actions)
        assert all(e["ok"] for e in log), log
        n = len(ledger.entries)
        wait_for(lambda: len(ledger.entries) > max(20, n + 5) or errors,
                 timeout=60, msg="writes after the heal")
        stop.set()
        wt.join(15), pt.join(15)
        assert not errors, f"idempotent write surfaced {errors[0]!r}"
        assert len(ledger.entries) > 20 and probes
        missing = ledger.verify_durable(
            cluster.fs_client(retry_duration_s=60.0, fastpath=False))
        assert not missing, f"acknowledged writes lost: {missing[:5]}"
        assert not staleness, f"stale standby reads: {staleness[:5]}"
    finally:
        cluster.stop()


def test_trace_fanout_merges_the_masters_alike():
    """The HA trace fan-out: the endpoints of the master list, and the
    merge of several masters' stitched views (a span seen twice kept
    once, most recent first, the summary over the union), the same in
    both packages."""
    rng = __import__("numpy").random.default_rng(3)

    def span(i, trace, start):
        return {"trace_id": f"t{trace}", "span_id": f"s{i}",
                "parent_id": "" if i % 3 == 0 else f"s{i - 1}",
                "name": f"op{i % 4}", "source": "master",
                "start_ms": float(start), "duration_ms": float(i % 5 + 1)}

    base = {"spans": [span(i, i % 2, rng.integers(0, 1000))
                      for i in range(6)]}
    peers = [{"spans": [span(i, i % 3, rng.integers(0, 1000))
                        for i in range(4, 12)]} for _ in range(2)]
    got = []
    for pkg in PACKAGES:
        fan = mod(pkg, "utils.trace_fanout")
        conf_mod = mod(pkg, "conf")
        conf = conf_mod.Configuration(load_env=False)
        conf.set(conf_mod.Keys.MASTER_RPC_ADDRESSES,
                 "m0:19998, m1:19998,m2:19998")
        merged = fan.merge_stitched(
            {"spans": [dict(s) for s in base["spans"]]},
            [{"spans": [dict(s) for s in p["spans"]]} for p in peers])
        got.append((fan.master_endpoints(conf), merged))
    assert got[0] == got[1]
    endpoints, merged = got[1]
    assert endpoints == ["m0:19998", "m1:19998", "m2:19998"]
    keys = {(s["trace_id"], s["span_id"])
            for p in [base] + peers for s in p["spans"]}
    assert len(merged["spans"]) == len(keys) < 6 + 16
    starts = [s["start_ms"] for s in merged["spans"]]
    assert starts == sorted(starts, reverse=True)


def test_a_call_the_server_cancels_is_retryable_in_the_port():
    """A unary call the server cancels with no typed error (as a stopping
    or demoting master's server can) raises ``UnavailableError`` in the
    port, which its master clients retry; the JAX channel raises a plain
    ``AlluxioTpuError``, which surfaced to the ``ha`` bench's writer."""
    from concurrent import futures

    import grpc

    def cancel(request, context):
        context.cancel()

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "t", {"m": grpc.unary_unary_rpc_method_handler(
            cancel, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        raised = {}
        for pkg in PACKAGES:
            with pytest.raises(mod(pkg, "utils.exceptions")
                               .AlluxioTpuError) as e:
                mod(pkg, "rpc.core").RpcChannel(
                    f"127.0.0.1:{port}").call("t", "m", {}, timeout=10)
            raised[pkg] = type(e.value).__name__
    finally:
        server.stop(None)
    assert raised == {PACKAGES[0]: "AlluxioTpuError",
                      PACKAGES[1]: "UnavailableError"}
