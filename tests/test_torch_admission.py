"""The port's master admission control and audit log against the JAX
package's, on the CPU.

- ``TokenBucket`` and ``TokenBucketSet`` on a fake clock: seeded request
  scripts (burst, refill, the cap after idling, the set's LRU bound) give
  both packages the same decision sequence, retry-after hints, tokens
  and evictions.
- ``AdmissionController``: the same checks give the same admits, sheds
  and retry-after hints (clamped to ``MAX_RETRY_AFTER_S``); exempt
  methods are never shed; principals are isolated; anonymous callers
  share one bucket; a principal flood keeps both maps bounded; the typed
  error's wire round trip keeps the hint; ``report()`` and
  ``shed_counts()`` are equal; ``sample_history`` writes the same series.
- A shed call is audited with the JAX line (``AuditContext.format``), and
  the async writer logs it on the package's audit logger; the port's
  writer also counts the dropped entries of denied calls.
- ``tenant_overload_rule`` has the JAX wire and flags the same subjects.
- ``check_admission``: the reject drill spares the exempt methods, and a
  principal comes from the authenticated user, else the ``atpu-user``
  metadata.
- The two-tenant ``LocalCluster``: with admission on, an abuser flooding
  ``create_file`` is shed (over gRPC and over the fast path) while every
  victim operation and cold read completes; the shed calls are audited
  and counted; the tenant-overload alert goes pending; a shed call
  retries at the server's pace and succeeds.
"""

import importlib
import logging
import threading
import time

import numpy as np
import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
SEEDS = (0, 1, 2)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Clock:
    def __init__(self, now: float = 0.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now


def _script(seed: int, n: int = 400, keys: int = 6) -> list:
    """(dt, key, tokens) steps: bursts of back-to-back calls, pauses of
    up to a few seconds (a refill past the cap) and a churn of keys."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dt = float(rng.choice([0.0, 0.001, 0.02, 0.3, 4.0],
                              p=[0.4, 0.3, 0.15, 0.1, 0.05]))
        out.append((dt, f"p{int(rng.integers(0, keys))}",
                    float(rng.choice([1.0, 1.0, 2.0]))))
    return out


# -- token buckets -----------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_token_bucket_decisions_equal(seed):
    got = {}
    for pkg in PACKAGES:
        clock = _Clock()
        b = _mod(pkg, "qos").TokenBucket(rate=10.0, burst=3.0, clock=clock)
        seq = []
        for dt, _key, n in _script(seed):
            clock.now += dt
            if dt > 1.0:
                seq.append(("available", b.available()))
            seq.append(b.try_acquire(n))
        got[pkg] = seq
    assert got[PORT] == got[JAX]
    # the cap: a long idle banks no more than the burst
    assert max(v for k, v in got[PORT] if k == "available") == 3.0


@pytest.mark.parametrize("seed", SEEDS)
def test_token_bucket_set_decisions_and_lru_equal(seed):
    got = {}
    for pkg in PACKAGES:
        clock = _Clock()
        s = _mod(pkg, "qos").TokenBucketSet(5.0, 2.0, max_keys=4,
                                            clock=clock)
        seq = []
        for dt, key, n in _script(seed, keys=9):
            clock.now += dt
            seq.append((key, s.try_acquire(key, n), len(s)))
        got[pkg] = (seq, s.evictions, list(s._buckets))
    assert got[PORT] == got[JAX]
    assert got[PORT][1] > 0 and max(n for *_, n in got[PORT][0]) == 4


# -- the controller ----------------------------------------------------------------
class _Audit:
    def __init__(self) -> None:
        self.entries = []

    def append(self, ctx) -> None:
        self.entries.append(ctx)


def _controller(pkg, clock, **kw):
    adm = _mod(pkg, "qos.admission")
    conf = dict(enabled=True, rate=1.0, burst=2.0, exempt=("heartbeat",))
    conf.update(kw)
    audit = _Audit()
    return adm.AdmissionController(adm.AdmissionConf(**conf),
                                   audit_writer=audit, clock=clock), audit


def _checks(pkg, ctl, clock, calls) -> list:
    errors = _mod(pkg, "utils.exceptions")
    out = []
    for dt, who, method in calls:
        clock.now += dt
        try:
            ctl.check(who, method)
            out.append("ok")
        except errors.ResourceExhaustedError as e:
            out.append(("shed", e.retry_after_s, str(e)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_controller_decisions_hints_and_reports_equal(seed):
    rng = np.random.default_rng(seed)
    principals = ["alice", "bob", None, "", "worker-1"]
    methods = ["create_file", "get_status", "heartbeat", "exists"]
    calls = [(float(rng.choice([0.0, 0.01, 0.5, 20.0],
                               p=[0.5, 0.3, 0.15, 0.05])),
              principals[int(rng.integers(0, len(principals)))],
              methods[int(rng.integers(0, len(methods)))])
             for _ in range(300)]
    got = {}
    for pkg in PACKAGES:
        clock = _Clock(100.0)
        ctl, audit = _controller(pkg, clock, rate=2.0, burst=3.0)
        seq = _checks(pkg, ctl, clock, calls)
        hist = _mod(pkg, "metrics.history").MetricsHistory()
        ctl.sample_history(hist, now=clock.now)
        got[pkg] = (seq, ctl.report(), ctl.shed_counts(),
                    [e.format() for e in audit.entries], hist.names())
    assert got[PORT] == got[JAX]
    seq = got[PORT][0]
    assert "ok" in seq and any(s != "ok" for s in seq)
    hints = [s[1] for s in seq if s != "ok"]
    assert all(0 < h <= _mod(PORT, "qos.admission").MAX_RETRY_AFTER_S
               for h in hints)


def test_retry_after_is_clamped_alike():
    got = {}
    for pkg in PACKAGES:
        clock = _Clock()
        ctl, _ = _controller(pkg, clock, rate=0.01, burst=1.0)
        got[pkg] = _checks(pkg, ctl, clock, [(0.0, "a", "get_status")] * 3)
    assert got[PORT] == got[JAX]
    assert got[PORT][1][1] == _mod(PORT, "qos.admission").MAX_RETRY_AFTER_S


def test_controller_semantics_alike():
    """JAX's ``TestAdmissionController`` cases on both packages."""
    for pkg in PACKAGES:
        adm = _mod(pkg, "qos.admission")
        errors = _mod(pkg, "utils.exceptions")
        clock = _Clock()
        ctl, audit = _controller(pkg, clock)
        for _ in range(100):
            ctl.check("worker-1", "heartbeat")  # far over rate, exempt
        ctl.check("abuser", "get_status")
        ctl.check("abuser", "get_status")
        with pytest.raises(errors.ResourceExhaustedError) as ei:
            ctl.check("abuser", "get_status")
        assert 0 < ei.value.retry_after_s <= adm.MAX_RETRY_AFTER_S
        ctl.check("victim", "get_status")  # its own bucket
        ctl.check(None, "get_status")
        ctl.check("", "get_status")
        with pytest.raises(errors.ResourceExhaustedError):
            ctl.check(None, "get_status")
        assert any(r["principal"] == adm.ANONYMOUS
                   for r in ctl.report()["principals"])
        (entry, _) = audit.entries
        assert (entry.user, entry.command, entry.allowed,
                entry.succeeded) == ("abuser", "get_status", False, False)
        flood, _ = _controller(pkg, clock, max_principals=8)
        for i in range(1000):
            clock.now += 0.001
            try:
                flood.check(f"spoof-{i}", "get_status")
            except errors.ResourceExhaustedError:
                pass
        assert len(flood._buckets) <= 8 and len(flood._stats) <= 8
        e = errors.ResourceExhaustedError("shed")
        e.retry_after_s = 0.75
        e2 = errors.AlluxioTpuError.from_wire(e.to_wire())
        assert isinstance(e2, errors.ResourceExhaustedError)
        assert e2.retry_after_s == 0.75
        plain = errors.AlluxioTpuError.from_wire(
            errors.ResourceExhaustedError("full").to_wire())
        assert plain.retry_after_s is None


def test_admission_conf_and_exemptions_alike():
    for pkg in PACKAGES:
        conf = _mod(pkg, "conf").Configuration(load_env=False)
        conf.set("atpu.master.rpc.admission.enabled", True)
        conf.set("atpu.master.rpc.admission.exempt", " a, b ,,c")
        c = _mod(pkg, "qos.admission").AdmissionConf.from_conf(conf)
        assert (c.enabled, c.rate, c.burst, c.max_principals, c.exempt) == \
            (True, 200.0, 400.0, 4096, frozenset("abc")), pkg
    assert _mod(PORT, "qos.admission").DEFAULT_EXEMPT == \
        _mod(JAX, "qos.admission").DEFAULT_EXEMPT
    default = _mod(PORT, "conf").Keys.MASTER_RPC_ADMISSION_EXEMPT.default
    assert frozenset(default.split(",")) == \
        _mod(PORT, "qos.admission").DEFAULT_EXEMPT
    # one name for the exemptions: the RPC core keeps no copy of its own
    assert not hasattr(_mod(PORT, "rpc.core"), "FAULT_EXEMPT")


# -- audit ---------------------------------------------------------------------------
def test_audit_line_and_writer_alike(caplog):
    lines = {}
    for pkg in PACKAGES:
        audit = _mod(pkg, "security.audit")
        ctxs = [audit.AuditContext(command="create_file", src_path="/a",
                                   user="alice"),
                audit.AuditContext(command="rename", src_path="/a",
                                   dst_path="/b", user="bob", ip="10.0.0.1",
                                   allowed=False, succeeded=False),
                audit.AuditContext(command="exists"),
                audit.AuditContext(command="get_status", user="eve",
                                   allowed=False, succeeded=False)]
        writer = audit.AsyncAuditLogWriter(capacity=2)
        logger = audit.AUDIT_LOG.name
        with caplog.at_level(logging.INFO, logger=logger):
            for ctx in ctxs:  # before start: the last two overflow
                writer.append(ctx)
            assert writer.dropped == 2
            if pkg == PORT:  # the port also counts the dropped denials
                assert writer.dropped_denied == 1
            writer.start()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and sum(
                    r.name == logger for r in caplog.records) < 2:
                time.sleep(0.01)
            writer.stop()
        lines[pkg] = ([c.format() for c in ctxs],
                      [r.getMessage() for r in caplog.records
                       if r.name == logger])
        caplog.clear()
    assert lines[PORT] == lines[JAX]
    assert lines[PORT][1] == lines[PORT][0][:2]
    assert lines[PORT][0][1] == ("succeeded=false allowed=false ugi=bob "
                                 "ip=10.0.0.1 cmd=rename src=/a dst=/b")
    assert _mod(PORT, "security.audit").AUDIT_LOG.name == \
        "alluxio_tpu_torch.audit"


# -- the tenant-overload rule --------------------------------------------------------
def test_tenant_overload_rule_alike():
    got = {}
    for pkg in PACKAGES:
        health = _mod(pkg, "master.health")
        counts = {"abuser": 0, "victim": 0}
        rule = health.tenant_overload_rule(lambda: dict(counts),
                                           shed_rate_per_s=1.0)
        seq = []
        for now, abuser, victim in ((100.0, 0, 0), (110.0, 600, 5),
                                    (110.5, 900, 5), (120.0, 600, 5),
                                    (130.0, 700, 100)):
            counts.update(abuser=abuser, victim=victim)
            seq.append([(v.subject, v.value, v.summary, v.evidence)
                        for v in rule.probe(
                            health.HealthContext(None, None, now))])
        got[pkg] = (rule.to_wire(), seq)
    assert got[PORT] == got[JAX]
    assert [[s[0] for s in step] for step in got[PORT][1]] == [
        [], ["tenant:abuser"], [], [], ["tenant:abuser", "tenant:victim"]]


# -- the RPC gate --------------------------------------------------------------------
@pytest.fixture()
def faults_reset():
    injectors = [_mod(pkg, "utils.faults").injector() for pkg in PACKAGES]
    for inj in injectors:
        inj.reset()
    yield
    for inj in injectors:
        inj.reset()


def test_check_admission_exemptions_alike(faults_reset):
    got = {}
    for pkg in PACKAGES:
        core = _mod(pkg, "rpc.core")
        errors = _mod(pkg, "utils.exceptions")
        _mod(pkg, "utils.faults").injector().set(rpc_reject_rate=1.0)
        seq = []
        for method in ("svc.create_file", "svc.heartbeat",
                       "svc.register_worker", "svc.commit_block",
                       "svc.get_status"):
            try:
                core.check_admission(None, None, method)
                seq.append("ok")
            except errors.ResourceExhaustedError as e:
                seq.append(("shed", e.retry_after_s > 0))
        # a controller's own exemptions replace the default set
        ctl, _ = _controller(pkg, _Clock(), exempt=("create_file",))
        for method in ("svc.create_file", "svc.heartbeat"):
            try:
                core.check_admission(ctl, None, method)
                seq.append("ok")
            except errors.ResourceExhaustedError:
                seq.append("shed")
        got[pkg] = seq
        _mod(pkg, "utils.faults").injector().reset()
    assert got[PORT] == got[JAX] == [
        ("shed", True), "ok", "ok", "ok", ("shed", True), "ok", "shed"]


class _Context:
    def __init__(self, md) -> None:
        self._md = md

    def invocation_metadata(self):
        return self._md


def test_check_admission_principal_alike():
    got = {}
    for pkg in PACKAGES:
        core = _mod(pkg, "rpc.core")
        user = _mod(pkg, "security.user")
        ctl, _ = _controller(pkg, _Clock(), rate=1.0, burst=1.0)
        md = _Context((("atpu-user", "meta-user"),))
        core.check_admission(ctl, md, "svc.get_status")
        token = user.set_authenticated_user(
            user.User(name="authed", groups=("authed",)))
        try:
            core.check_admission(ctl, md, "svc.get_status")
        finally:
            user.reset_authenticated_user(token)
        core.check_admission(ctl, None, "svc.get_status",
                             principal_hint="hinted")
        core.check_admission(ctl, _Context(()), "svc.get_status")
        got[pkg] = sorted((r["principal"], r["admitted"])
                          for r in ctl.report()["principals"])
    assert got[PORT] == got[JAX] == [
        ("(anonymous)", 1), ("authed", 1), ("hinted", 1), ("meta-user", 1)]


# -- the two-tenant cluster ----------------------------------------------------------
VICTIM_MD = (("atpu-user", "victim"),)
ABUSER_MD = (("atpu-user", "abuser"),)


def _qos_cluster(pkg, base):
    return _mod(pkg, "minicluster.local_cluster").LocalCluster(
        base, num_workers=1, start_worker_heartbeats=True, conf_overrides={
            "atpu.master.rpc.admission.enabled": True,
            "atpu.master.rpc.admission.rate": 25.0,
            "atpu.master.rpc.admission.burst": 25.0,
            "atpu.worker.qos.enabled": True,
            "atpu.worker.ufs.fetch.tenant.limit": 2,
            "atpu.user.block.size.bytes.default": 64 << 10})


def _victim_survives(pkg, c) -> dict:
    """JAX's ``test_victim_survives_abusive_flood`` on one package."""
    clients = _mod(pkg, "rpc.clients")
    errors = _mod(pkg, "utils.exceptions")
    conf_mod = _mod(pkg, "conf")
    fs = c.file_system()
    fs.create_directory("/victim", mode=0o777)
    fs.create_directory("/abuse", mode=0o777)
    blobs = {}
    for i in range(3):
        data = bytes([65 + i]) * (64 << 10)
        fs.write_all(f"/cold-{i}", data, write_type="CACHE_THROUGH")
        blobs[f"/cold-{i}"] = data
    for path in blobs:
        fs.free(path)
    abuser = clients.FsMasterClient(c.master.address, metadata=ABUSER_MD,
                                    retry_duration_s=0.05)
    victim_conf = c.conf.copy()
    victim_conf.set(conf_mod.Keys.SECURITY_LOGIN_USERNAME, "victim")
    victim_fs = clients.FsMasterClient(c.master.address, metadata=VICTIM_MD)
    victim = _mod(pkg, "client.file_system").FileSystem(c.master.address,
                                                        conf=victim_conf)
    stop = threading.Event()
    shed = [0]

    def flood():
        i = 0
        while not stop.is_set():
            i += 1
            try:
                abuser.create_file(f"/abuse/f-{threading.get_ident()}-{i}")
            except errors.ResourceExhaustedError:
                shed[0] += 1
            except Exception:  # noqa: BLE001 - the flood keeps going
                pass

    flooders = [threading.Thread(target=flood, daemon=True)
                for _ in range(4)]
    for th in flooders:
        th.start()
    try:
        for i in range(20):
            victim_fs.create_file(f"/victim/f-{i}")
            assert victim_fs.get_status(f"/victim/f-{i}") is not None
        reads = [victim.read_all(p) == b for p, b in blobs.items()]
    finally:
        stop.set()
        for th in flooders:
            th.join(timeout=10)
    qos = c.meta_client().get_qos()
    rows = {r["principal"]: r for r in qos["admission"]["principals"]}
    victim_shed = rows.get("victim", {"shed": 0})["shed"]
    assert shed[0] > 0, pkg
    assert rows["abuser"]["shed"] > 5 * max(1, victim_shed), pkg
    assert qos["admission"]["shed_total"] >= rows["abuser"]["shed"]
    return {"reads": reads, "enabled": qos["admission"]["enabled"],
            "keys": sorted(qos["admission"]),
            "victim_files": sorted(i.name for i in
                                   victim_fs.list_status("/victim"))}


def test_victim_survives_the_flood(tmp_path):
    got = {}
    for pkg in PACKAGES:
        with _qos_cluster(pkg, str(tmp_path / pkg)) as c:
            assert type(c.master.admission).__module__ == \
                f"{pkg}.qos.admission"
            got[pkg] = _victim_survives(pkg, c)
    assert got[PORT] == got[JAX]
    assert got[PORT]["reads"] == [True] * 3
    assert len(got[PORT]["victim_files"]) == 20


def test_admission_gates_the_fast_path(tmp_path):
    """The port's fast path sheds an abuser's flood by its hello
    frame's principal, as the JAX fast path does."""
    got = {}
    for pkg in PACKAGES:
        clients = _mod(pkg, "rpc.clients")
        errors = _mod(pkg, "utils.exceptions")
        keys = _mod(pkg, "conf").Keys
        # a short directory: the port's cluster puts the master's socket
        # there, and a Unix socket's path is limited to 107 bytes
        with _qos_cluster(pkg, str(tmp_path / pkg[-1])) as c:
            fast_dir = c.conf.get(keys.MASTER_FASTPATH_DIR)
            kw = {"fastpath_dir": fast_dir} if fast_dir else {}
            abuser = clients.FsMasterClient(
                c.master.address, metadata=ABUSER_MD, retry_duration_s=0.0,
                **kw)
            victim = clients.FsMasterClient(
                c.master.address, metadata=VICTIM_MD, retry_duration_s=0.0,
                **kw)
            shed = 0
            for i in range(60):
                try:
                    abuser.exists(f"/x-{i}")
                except errors.ResourceExhaustedError:
                    shed += 1
            ok = sum(victim.exists(f"/y-{i}") is False for i in range(20))
            rows = {r["principal"]: r["shed"] for r in
                    c.meta_client().get_qos()["admission"]["principals"]}
            transport = getattr(abuser, "transport", "fastpath")
            got[pkg] = (transport, shed > 0, ok, rows.get("victim", 0),
                        rows["abuser"] == shed)
            for client in (abuser, victim):
                getattr(client, "close", lambda: None)()
    assert got[PORT] == got[JAX] == ("fastpath", True, 20, 0, True)


def test_shed_calls_are_audited_and_counted(tmp_path, caplog):
    got = {}
    for pkg in PACKAGES:
        clients = _mod(pkg, "rpc.clients")
        errors = _mod(pkg, "utils.exceptions")
        logger = _mod(pkg, "security.audit").AUDIT_LOG.name
        with _qos_cluster(pkg, str(tmp_path / pkg)) as c:
            abuser = clients.FsMasterClient(
                c.master.address, metadata=ABUSER_MD, retry_duration_s=0.0)
            shed = 0
            with caplog.at_level(logging.INFO, logger=logger):
                for i in range(100):
                    try:
                        abuser.exists(f"/y-{i}")
                    except errors.ResourceExhaustedError:
                        shed += 1

                def denied():
                    return [r.getMessage() for r in caplog.records
                            if r.name == logger and
                            "allowed=false" in r.getMessage()]

                deadline = time.monotonic() + 5
                while time.monotonic() < deadline and \
                        len(denied()) < shed:
                    time.sleep(0.05)  # the async writer drains
                lines = denied()
            snap = c.meta_client().get_metrics()
            # the shed count follows the refill during the loop: each
            # package is held to its own
            got[pkg] = (shed > 0,
                        len(lines) + c.master.audit_writer.dropped == shed,
                        sorted(set(lines)),
                        snap.get("Master.RpcAdmissionShed", 0) >= shed)
            caplog.clear()
    assert got[PORT] == got[JAX] == (True, True, [
        "succeeded=false allowed=false ugi=abuser ip= cmd=exists src= "
        "dst="], True)


def test_tenant_overload_alert_goes_pending(tmp_path):
    got = {}
    for pkg in PACKAGES:
        clients = _mod(pkg, "rpc.clients")
        errors = _mod(pkg, "utils.exceptions")
        with _qos_cluster(pkg, str(tmp_path / pkg)) as c:
            monitor = c.master.health_monitor
            assert "tenant-over-share" in [r.name for r in monitor.rules]
            monitor.evaluate()  # the baseline probe
            abuser = clients.FsMasterClient(
                c.master.address, metadata=ABUSER_MD, retry_duration_s=0.0)
            shed = 0
            for i in range(200):
                try:
                    abuser.exists(f"/x-{i}")
                except errors.ResourceExhaustedError:
                    shed += 1
            time.sleep(1.1)  # past the rule's 1 s baseline guard
            monitor.evaluate()
            report = monitor.report()
            got[pkg] = (shed > 0, sorted(
                a["subject"] for a in report["pending"] + report["alerts"]
                if a["rule"] == "tenant-over-share"))
    assert got[PORT] == got[JAX] == (True, ["tenant:abuser"])


def test_shed_call_retries_at_the_servers_pace(tmp_path):
    """A client with a retry budget rides out the shedding: the retry
    policy honours the hint, and the call succeeds."""
    for pkg in PACKAGES:
        clients = _mod(pkg, "rpc.clients")
        errors = _mod(pkg, "utils.exceptions")
        with _qos_cluster(pkg, str(tmp_path / pkg)) as c:
            drainer = clients.FsMasterClient(
                c.master.address, metadata=ABUSER_MD, retry_duration_s=0.0)
            client = clients.FsMasterClient(
                c.master.address, metadata=ABUSER_MD, retry_duration_s=10.0)
            sheds = []
            channel = client._channels[0]

            class _Counting:
                """The client's channel, counting the sheds it sees."""

                def __getattr__(self, name):
                    return getattr(channel, name)

                def call(self, *args, **kw):
                    try:
                        return channel.call(*args, **kw)
                    except errors.ResourceExhaustedError as e:
                        sheds.append(e.retry_after_s)
                        raise

            client._channels[0] = _Counting()
            # drained right before the call, so its first attempt is
            # shed (tried again should a token accrue in between)
            for _ in range(5):
                with pytest.raises(errors.ResourceExhaustedError):
                    for _ in range(60):
                        drainer.exists("/")
                t0 = time.monotonic()
                assert client.exists("/") is True
                assert time.monotonic() - t0 < 10.0, pkg
                if sheds:
                    break
            assert sheds and all(ra > 0 for ra in sheds), pkg
